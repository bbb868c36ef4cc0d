"""Out-of-core shard stores and crash-resumable multi-epoch fits
(counterpart of ``sq_learn_tpu/oocore``).

Datasets larger than host RAM live as CRC-manifested shard stores
(:mod:`.store`; optionally LZ4-compressed per shard,
``SQ_OOC_CODEC=lz4``, with the CRC over the stored bytes), in the JAX
package's on-disk format, so a store written by either package opens in
the other. Deterministic epoch plans schedule multi-pass batch walks over
them (:mod:`.epochs`), the bounded readahead prefetcher overlaps shard
reads and CRC checks with the consumer (:mod:`.prefetch`; depth 0 is the
serial path, bit for bit), and the resumable mini-batch fit
(:mod:`.fit`) runs every step on the card and survives a SIGKILL
mid-epoch bit for bit. The streaming engine
(:mod:`sq_learn_tpu_torch.streaming`) reads stores wherever it reads host
arrays, and :class:`~sq_learn_tpu_torch.models.MiniBatchQKMeans` and
:class:`~sq_learn_tpu_torch.models.QPCA` fit straight from disk.

Quickstart::

    from sq_learn_tpu_torch import oocore
    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    store = oocore.create_synthetic_store("/tmp/s", 100_000, 784, seed=0)
    km = MiniBatchQKMeans(n_clusters=10, random_state=0).fit(store)

The host-side modules (store, codec, epochs, prefetch) import numpy and
the standard library only, so the prefetch workers never touch torch.
The JAX package's ``oocore/smoke.py`` (a CPU CLI) is not ported: its
scenario runs on the card in ``chip_smoke.py`` and on the CPU in the
tests.
"""

from .epochs import EpochPlan
from .fit import assign_labels, minibatch_epoch_fit
from .prefetch import (PrefetchingSource, ShardPrefetcher, iter_shards,
                       prefetch_depth, prefetch_threads)
from .store import (ArraySource, RamBudgetError, ShardCorruptionError,
                    ShardStore, create_synthetic_store, is_source,
                    open_store, store_from_array)

__all__ = [
    "ArraySource",
    "EpochPlan",
    "PrefetchingSource",
    "RamBudgetError",
    "ShardCorruptionError",
    "ShardPrefetcher",
    "ShardStore",
    "assign_labels",
    "create_synthetic_store",
    "is_source",
    "iter_shards",
    "minibatch_epoch_fit",
    "open_store",
    "prefetch_depth",
    "prefetch_threads",
    "store_from_array",
]
