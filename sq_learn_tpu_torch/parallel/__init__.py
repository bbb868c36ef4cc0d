"""Data-parallel meshes: row sharding, the fixed-order collectives, the
sharded Lloyd loop, k-means++ init, Gram SVD, tomography, k-NN search and
streamed Gram, and the multi-process world (counterpart of
``sq_learn_tpu/parallel``). The elastic world is
``sq_learn_tpu_torch.parallel.elastic``, imported by name: its names are
not re-exported here, as the JAX package's are not."""

from . import distributed, streaming
from .init import kmeans_plusplus_sharded
from .lloyd import lloyd_single_sharded
from .mesh import (
    DATA_AXIS,
    Mesh,
    ShardedRows,
    data_sharding,
    make_mesh,
    pad_and_shard,
    pad_to_multiple,
    replicated,
    shard_rows,
)
from .neighbors import knn_indices_sharded, shard_train_rows
from .pca import (centered_sharded, centered_svd_sharded, tomography_sharded,
                  uncentered_svd_sharded)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "ShardedRows",
    "centered_sharded",
    "centered_svd_sharded",
    "data_sharding",
    "distributed",
    "kmeans_plusplus_sharded",
    "knn_indices_sharded",
    "lloyd_single_sharded",
    "make_mesh",
    "pad_and_shard",
    "pad_to_multiple",
    "replicated",
    "shard_rows",
    "shard_train_rows",
    "streaming",
    "tomography_sharded",
    "uncentered_svd_sharded",
]
