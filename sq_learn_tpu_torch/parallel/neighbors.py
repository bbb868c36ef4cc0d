"""Train-sharded brute-force k-NN search over a mesh (counterpart of
``sq_learn_tpu/parallel/neighbors.py``).

The TRAINING rows are split over the mesh, once, at fit
(:func:`shard_train_rows`). A search replicates the queries, runs the
fused search :func:`~sq_learn_tpu_torch.ops.kernels.argkmin` on each
shard (the kernel on a CUDA shard, on its device's stream) for its
min(k, rows per shard) nearest rows, offsets the indices to global row
ids, and merges the shards' (n_q, k_local) candidate lists on the mesh's
first device in plain torch, ordered by (d², global index): a stable sort
of the lists concatenated in shard order. Only the candidate lists cross
devices.

Padding rows never win: their squared norm in ``x_sq_train`` is
``_PAD_PENALTY``, which ranks them after every real row, and the caller
guarantees k ≤ n (the classifier's ``_check_k``), so k real rows are
always among the candidates. The kernel takes no mask.
"""

import torch

from .. import obs as _obs
from ..ops.kernels import argkmin
from ..ops.linalg import pairwise_sq_distances, row_norms
from .mesh import pad_and_shard

#: the squared norm of a padding row: it ranks the row after every real
#: candidate without overflowing float32 arithmetic in the merge
_PAD_PENALTY = 1e30

__all__ = ["knn_indices_sharded", "shard_train_rows"]


def shard_train_rows(mesh, X_train):
    """Pad the training rows to a multiple of the shard count and place
    them, with their squared norms (``_PAD_PENALTY`` on padding rows),
    over the mesh — the one corpus-sized transfer of a sharded search.
    Returns an opaque ``(X sharded, x_sq sharded, per, n)`` state for
    :func:`knn_indices_sharded`'s ``presharded=``."""
    Xs, mask, n = pad_and_shard(mesh, X_train)
    xsq = Xs.map(lambda x, m: torch.where(
        m > 0, row_norms(x, squared=True),
        torch.full_like(m, _PAD_PENALTY)), mask)
    Xs = Xs.map(lambda x: x.contiguous())
    return Xs, xsq, Xs.per, n


def _shard_search(T, tsq, Q, k):
    """(idx, d2) of the k nearest rows of one shard: the fused search on
    float32, the plain search in the data's dtype otherwise (the JAX
    package keeps float64 off its kernel), each ranking by
    ‖t‖² − 2·q·t with padding rows' norms at ``_PAD_PENALTY``."""
    if T.dtype == torch.float32:
        return argkmin(T, tsq, Q, k)
    d2 = pairwise_sq_distances(Q, T) + torch.where(
        tsq >= _PAD_PENALTY, _PAD_PENALTY, 0.0).to(T.dtype)
    vals, order = torch.sort(d2, dim=1, stable=True)
    return order[:, :k].to(torch.int32), vals[:, :k]


def knn_indices_sharded(mesh, X_train, X_query, k, presharded=None):
    """Indices (int32) and squared distances of the k nearest training
    rows per query, ascending, with the training rows sharded over
    ``mesh``; on the mesh's first device.

    Matches :func:`~sq_learn_tpu_torch.models.neighbors.knn_indices`
    (the exact search) on the same input. The caller guarantees
    ``k <= n_train``. Pass ``presharded`` from :func:`shard_train_rows`
    to skip the per-call corpus placement; ``X_query`` is a tensor.
    """
    if presharded is None:
        presharded = shard_train_rows(mesh, X_train)
    Xs, xsq, per, n = presharded
    nq = X_query.shape[0]
    with _obs.span("parallel.neighbors.knn_indices_sharded",
                   n_devices=mesh.size, n_queries=int(nq), k=int(k)) as sp:
        # a shard offers at most `per` candidates; with k <= n the union
        # of the shards always holds k real rows
        k_local = min(int(k), per)
        Q = X_query.to(Xs.dtype).contiguous()
        outs = [_shard_search(T, ts, q, k_local) for T, ts, q
                in zip(Xs.shards, xsq.shards, mesh.broadcast(Q))]
        idx = mesh.gather([i.to(torch.int64) + (mesh.offset + s) * per
                           for s, (i, _) in enumerate(outs)], dim=1)
        d2 = mesh.gather([d for _, d in outs], dim=1)
        # the merge: ascending d², ties to the lowest global row (the
        # lists come in shard order, each ascending with ties by index)
        d2, order = torch.sort(d2, dim=1, stable=True)
        idx = torch.gather(idx, 1, order[:, :k]).to(torch.int32)
        sp.sync(idx)
    return idx, d2[:, :k]
