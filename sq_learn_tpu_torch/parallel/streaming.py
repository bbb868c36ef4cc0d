"""Mesh variant of the streaming tiled-ingestion engine (counterpart of
``sq_learn_tpu/parallel/streaming.py``).

The same double-buffered tile walk as :mod:`sq_learn_tpu_torch.streaming`
(pinned staging, the transfer supervisor's retries and breaker, armed
faults, resumable fold passes, the per-tile value check), with each
tile's rows split over the mesh: tile buckets are rounded to multiples of
the shard count, each shard takes its block of the tile's rows to its
device and forms its partial Gram and column sums there, and the partials
are summed in shard order into the (m, m)/(m,) accumulators on the mesh's
first device. Zero-padded rows add nothing to the sums. Between tiles only
the accumulators survive; a checkpoint snapshots them, and a resumed pass
continues mid-sweep.
"""

import torch

from .. import obs as _obs
from ..ops.linalg import gram_spectrum, svd_flip_v
from ..streaming import (_rows_input, _torch_dtype, padded_rows,
                         _row_bytes, stream_fold)
from .mesh import data_sharding, replicated

__all__ = [
    "streamed_centered_gram_sharded",
    "streamed_centered_svd_topk_sharded",
]


def streamed_centered_gram_sharded(mesh, X, *, max_bytes=None,
                                   checkpoint=None, validate=False):
    """(mean, G_centered, n) of host data with every tile's rows split over
    the mesh and the per-shard partial Grams and column sums summed in
    shard order. ``checkpoint`` (or ``SQ_STREAM_CKPT_DIR``) makes the pass
    resumable: the snapshot holds the summed accumulators."""
    X = _rows_input(X)
    n, m = X.shape
    dev = mesh.lead
    dtype = _torch_dtype(X)
    init = (torch.zeros((m, m), dtype=dtype, device=dev),
            torch.zeros((m,), dtype=dtype, device=dev))
    split = data_sharding(mesh)

    def step(acc, tile):
        G, colsum = acc
        blocks = split(tile).shards
        G.add_(mesh.psum([b.T @ b for b in blocks]))
        colsum.add_(mesh.psum([torch.sum(b, dim=0) for b in blocks]))
        return acc

    with _obs.span("parallel.streaming.centered_gram", n=n, m=m,
                   n_devices=mesh.size):
        G, colsum = stream_fold(X, step, init, max_bytes=max_bytes,
                                device=dev, multiple=mesh.size,
                                site="streaming.gram_colsum",
                                checkpoint=checkpoint, validate=validate)
        mean = colsum / n
        Gc = G - n * torch.outer(mean, mean)
    return mean, Gc, n


def streamed_centered_svd_topk_sharded(mesh, X, n_left, *, max_bytes=None,
                                       validate=False):
    """The streamed twin of :func:`~sq_learn_tpu_torch.parallel.pca.
    centered_svd_sharded` for the qPCA partial-U Gram route: (mean, Uk, S,
    Vt) with the Gram built from sharded tiles and the (n, k) U block
    assembled on the mesh's first device from per-shard products — X is
    never resident. Matches the resident sharded SVD up to the order the
    tiles are summed in."""
    X = _rows_input(X)
    n, m = X.shape
    mean, Gc, _ = streamed_centered_gram_sharded(
        mesh, X, max_bytes=max_bytes, validate=validate)
    S, V, safe = gram_spectrum(Gc)
    _, Vt = svd_flip_v(None, V.T)
    k = int(n_left)
    rep, split = replicated(mesh), data_sharding(mesh)
    proj = rep((Vt[:k] / safe[:k, None]).T.contiguous())
    means = rep(mean)

    def step(acc, tile, n_valid, start):
        # the padded rows project to −mean·proj: sliced off below
        rows = mesh.gather([(b - mu) @ p for b, mu, p
                            in zip(split(tile).shards, means, proj)])
        acc[start:start + n_valid] = rows[:n_valid]
        return acc

    n_pad = padded_rows(n, _row_bytes(X), max_bytes, mesh.size)
    with _obs.span("parallel.streaming.topk_u", n=n, k=k,
                   n_devices=mesh.size):
        Uk = stream_fold(X, step, torch.zeros((n_pad, k), dtype=S.dtype,
                                              device=mesh.lead),
                         max_bytes=max_bytes, device=mesh.lead,
                         multiple=mesh.size, with_offsets=True,
                         site="streaming.topk_u", checkpoint=False)
    return mean, Uk[:n], S, Vt

