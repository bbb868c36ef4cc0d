"""Batched and sharded k-means++ initialization (counterpart of
``sq_learn_tpu/parallel/init.py``).

Every candidate is drawn through the same two-stage sampler as the JAX
kernel: over a fixed grid of ``NBLOCKS`` row blocks, stage 1 inverts the
CDF of the per-block potential sums and stage 2 inverts the CDF inside the
owning block; potential totals are block sums followed by a fixed-order
sum. Restarts are a leading batch dimension. The uniforms a draw consumes
are tensor arguments drawn by the caller from its generator, so a test can
feed the JAX side's uniforms and compare indices.

:func:`kmeans_plusplus_sharded` runs the same sampler with the rows
split over a :class:`~sq_learn_tpu_torch.parallel.mesh.Mesh`. The block
grid is anchored to global row indices, so every block lies inside one
shard (a mesh must divide ``NBLOCKS``): each shard sums its own blocks,
the block sums cross shards only by the mesh's gather in shard order,
stage 2 runs on the block's owner, and a chosen row reaches every shard
by that gather. From the same generator the sharded init draws the same
uniforms as :func:`kmeans_plusplus_batched` and selects the same rows.
"""

import math

import torch

from .. import obs as _obs
from .mesh import pad_to_multiple, shard_rows

#: number of row blocks of the hierarchical sampler
NBLOCKS = 64


def resolve_init_subsample(n_samples, n_clusters, setting="auto"):
    """Row count of the uniform init subsample (0 = init on the full data).
    'auto' targets ``max(128·k, 4096)`` rows (rounded up to a block
    multiple) and only engages when the data is ≥4× larger; explicit
    integers are used as given (0/None disables)."""
    if setting == "auto":
        target = max(128 * int(n_clusters), 4096)
    elif not setting:
        return 0
    else:
        target = int(setting)
    target = -(-target // NBLOCKS) * NBLOCKS
    return target if n_samples > 4 * target else 0


def _default_trials(n_clusters):
    return 2 + int(math.log(n_clusters))


def _pad_rows(v, n_pad):
    """Zero-pad the last dimension of ``v`` to ``n_pad``."""
    n = v.shape[-1]
    if n == n_pad:
        return v
    return torch.nn.functional.pad(v, (0, n_pad - n))


def _block_sums(v, n_blocks):
    """(..., rows) → (..., n_blocks) per-block sums."""
    return v.reshape(*v.shape[:-1], n_blocks, -1).sum(dim=-1)


def _pot_total(vals, n_blocks):
    """Σ vals as block partials, then a fixed-order sum."""
    return torch.sum(_block_sums(vals, n_blocks), dim=-1)


def _draw_index(u, pot, n_blocks):
    """Categorical draws ∝ ``pot`` via the two-stage block sampler.

    ``pot`` is (..., rows) with rows a multiple of ``n_blocks``; ``u`` holds
    one uniform in [0, 1) per draw, shaped like ``pot``'s leading
    dimensions. Returns the row indices (int64). Rows with zero potential
    are never selected (the stage boundaries are strict).
    """
    bsums = _block_sums(pot, n_blocks)
    cum = torch.cumsum(bsums, dim=-1)
    total = cum[..., -1]
    # strictly below the total so the right-side search always lands
    # inside a positive-mass block (and a positive-potential row in it)
    t = torch.clamp(u, max=0.999999) * total
    b = torch.clamp(torch.searchsorted(cum, t[..., None], right=True)[..., 0],
                    0, n_blocks - 1)
    prev = torch.where(
        b > 0, torch.gather(cum, -1, (b - 1).clamp(min=0)[..., None])[..., 0],
        torch.zeros_like(t))
    bs = pot.shape[-1] // n_blocks
    blocks = pot.reshape(*pot.shape[:-1], n_blocks, bs)
    idx = b[..., None, None].expand(*b.shape, 1, bs)
    block = torch.gather(blocks, -2, idx)[..., 0, :]
    off = torch.clamp(
        torch.searchsorted(torch.cumsum(block, dim=-1),
                           (t - prev)[..., None], right=True)[..., 0],
        0, bs - 1)
    return b * bs + off


def _kpp_run(u_first, u_trials, X, x_sq, weights, *, n_clusters,
             n_blocks=NBLOCKS):
    """Greedy best-of-trials D²-sampling inits of R restarts at once.

    ``u_first`` (R,) and ``u_trials`` (R, k−1, T) are the uniforms of the
    first draw and of every trial draw. Returns centers (R, k, m) and row
    indices (R, k).
    """
    n, m = X.shape
    R = u_first.shape[0]
    n_trials = u_trials.shape[-1]
    bs = -(-n // n_blocks)
    n_pad = bs * n_blocks
    w_pad = _pad_rows(weights, n_pad)
    rows = torch.arange(R, device=X.device)

    first = _draw_index(u_first, w_pad.expand(R, n_pad), n_blocks)
    c0 = X[first]                                            # (R, m)
    d0 = torch.clamp(x_sq + torch.sum(c0 * c0, dim=-1)[:, None]
                     - 2.0 * (c0 @ X.T), min=0.0)
    closest = _pad_rows(d0, n_pad)                           # (R, n_pad)
    centers = torch.zeros((R, n_clusters, m), dtype=X.dtype,
                          device=X.device)
    indices = torch.full((R, n_clusters), -1, dtype=torch.int64,
                         device=X.device)
    centers[:, 0] = c0
    indices[:, 0] = first
    for c in range(1, n_clusters):
        pot = closest * w_pad
        cand_idx = _draw_index(
            u_trials[:, c - 1], pot[:, None, :].expand(R, n_trials, n_pad),
            n_blocks)                                        # (R, T)
        cand_rows = X[cand_idx]                              # (R, T, m)
        c_sq = torch.sum(cand_rows * cand_rows, dim=-1)
        d2 = torch.clamp(x_sq + c_sq[..., None]
                         - 2.0 * (cand_rows @ X.T), min=0.0)  # (R, T, n)
        new_closest = torch.minimum(closest[:, None], _pad_rows(d2, n_pad))
        pots = _pot_total(new_closest * w_pad, n_blocks)     # (R, T)
        best = torch.argmin(pots, dim=-1)
        closest = new_closest[rows, best]
        centers[:, c] = cand_rows[rows, best]
        indices[:, c] = cand_idx[rows, best]
    return centers, indices


def kmeans_plusplus_batched(generator, X, x_sq_norms=None, n_clusters=8, *,
                            n_restarts=1, weights=None, n_local_trials=None,
                            subsample=0):
    """All ``n_restarts`` k-means++ inits in one batched pass.
    ``subsample`` > 0 draws that many rows uniformly without replacement
    (one shared draw, weights preserved) and runs the D² potentials on
    them. Returns (centers (R, k, m), indices (R, k) into the ORIGINAL
    rows)."""
    n = X.shape[0]
    if x_sq_norms is None:
        x_sq_norms = torch.sum(X * X, dim=1)
    if weights is None:
        weights = torch.ones(n, dtype=X.dtype, device=X.device)
    if n_local_trials is None:
        n_local_trials = _default_trials(n_clusters)
    sub = None
    if subsample and subsample < n:
        sub = torch.randperm(n, generator=generator,
                             device=X.device)[:subsample]
        X, x_sq_norms, weights = X[sub], x_sq_norms[sub], weights[sub]
    u = torch.rand((n_restarts, 1 + (n_clusters - 1) * n_local_trials),
                   generator=generator, dtype=X.dtype, device=X.device)
    centers, indices = _kpp_run(
        u[:, 0], u[:, 1:].reshape(n_restarts, n_clusters - 1,
                                  n_local_trials),
        X, x_sq_norms, weights, n_clusters=n_clusters)
    if sub is not None:
        indices = sub[indices]
    return centers, indices


def _draw_index_sharded(mesh, u, pots, n_blocks):
    """:func:`_draw_index` over sharded potentials: ``pots`` holds each
    local shard's (..., per) potentials, ``u`` (...) the uniforms on the
    mesh's first device. Stage 1 inverts the CDF of the block sums
    gathered in shard order; stage 2 runs on the block's owner. Returns
    the global row indices on the first device."""
    per = pots[0].shape[-1]
    local_blocks = n_blocks // mesh.size
    bs = per // local_blocks
    bsums = mesh.gather([_block_sums(p, local_blocks) for p in pots],
                        dim=-1)
    cum = torch.cumsum(bsums, dim=-1)
    total = cum[..., -1]
    t = torch.clamp(u, max=0.999999) * total
    b = torch.clamp(torch.searchsorted(cum, t[..., None], right=True)[..., 0],
                    0, n_blocks - 1)
    prev = torch.where(
        b > 0, torch.gather(cum, -1, (b - 1).clamp(min=0)[..., None])[..., 0],
        torch.zeros_like(t))
    owner = b // local_blocks
    offs = []
    for i, p in enumerate(pots):
        mine = owner.to(p.device) == mesh.offset + i
        b_loc = torch.where(mine, (b - owner * local_blocks).to(p.device), 0)
        blocks = p.reshape(*p.shape[:-1], local_blocks, bs)
        idx = b_loc[..., None, None].expand(*b_loc.shape, 1, bs)
        block = torch.gather(blocks, -2, idx)[..., 0, :]
        off = torch.clamp(
            torch.searchsorted(torch.cumsum(block, dim=-1),
                               (t - prev).to(p.device)[..., None],
                               right=True)[..., 0], 0, bs - 1)
        offs.append(torch.where(mine, off, 0))
    return b * bs + mesh.psum(offs)


def _take_rows_sharded(mesh, X, idx):
    """Rows ``idx`` (global, any shape) of the sharded ``X``: each shard
    offers its row of each index (zeros where it does not own it), the
    offers are gathered in shard order and the owner's is kept, exactly."""
    per = X.per
    offers = []
    for i, x in enumerate(X.shards):
        local = idx.to(x.device) - (mesh.offset + i) * per
        inside = (local >= 0) & (local < per)
        rows = x[torch.clamp(local, 0, per - 1)]
        offers.append(torch.where(inside[..., None], rows,
                                  torch.zeros_like(rows)))
    every = mesh.gather([o[None] for o in offers])       # (shards, ..., m)
    owner = idx // per
    return torch.gather(every, 0, owner[None, ..., None].expand(
        1, *every.shape[1:]))[0]


def _kpp_run_sharded(mesh, u_first, u_trials, X, x_sq, weights, *,
                     n_clusters, n_blocks=NBLOCKS):
    """:func:`_kpp_run` with the (block-multiple padded) rows ``X``,
    ``x_sq`` and ``weights`` sharded over ``mesh``; the uniforms and the
    results live on the mesh's first device."""
    m = X.shards[0].shape[1]
    R = u_first.shape[0]
    n_trials = u_trials.shape[-1]
    dev = mesh.lead
    rows = torch.arange(R, device=dev)

    def d2_to(cand):
        """Per shard, the clamped squared distances of its rows to the
        candidate rows ``cand`` (..., m)."""
        out = []
        for x, xs, c in zip(X.shards, x_sq.shards, mesh.broadcast(cand)):
            c_sq = torch.sum(c * c, dim=-1)
            out.append(torch.clamp(xs + c_sq[..., None] - 2.0 * (c @ x.T),
                                   min=0.0))
        return out

    first = _draw_index_sharded(
        mesh, u_first, [w.expand(R, w.shape[0]) for w in weights.shards],
        n_blocks)
    c0 = _take_rows_sharded(mesh, X, first)                  # (R, m)
    closest = d2_to(c0)                                      # (R, per) each
    centers = torch.zeros((R, n_clusters, m), dtype=X.dtype, device=dev)
    indices = torch.full((R, n_clusters), -1, dtype=torch.int64, device=dev)
    centers[:, 0] = c0
    indices[:, 0] = first
    for c in range(1, n_clusters):
        pots = [(cl * w)[:, None, :].expand(R, n_trials, w.shape[0])
                for cl, w in zip(closest, weights.shards)]
        cand_idx = _draw_index_sharded(mesh, u_trials[:, c - 1], pots,
                                       n_blocks)             # (R, T)
        cand_rows = _take_rows_sharded(mesh, X, cand_idx)    # (R, T, m)
        new_closest = [torch.minimum(cl[:, None], d2) for cl, d2
                       in zip(closest, d2_to(cand_rows))]    # (R, T, per)
        pots = _pot_total(mesh.gather(
            [_block_sums(nc * w, n_blocks // mesh.size)
             for nc, w in zip(new_closest, weights.shards)], dim=-1),
            n_blocks)                                        # (R, T)
        best = torch.argmin(pots, dim=-1)
        closest = [nc[rows.to(nc.device), best.to(nc.device)]
                   for nc in new_closest]
        centers[:, c] = cand_rows[rows, best]
        indices[:, c] = cand_idx[rows, best]
    return centers, indices


def kmeans_plusplus_sharded(mesh, generator, X, x_sq_norms=None,
                            n_clusters=8, *, n_restarts=1, weights=None,
                            n_local_trials=None):
    """k-means++ inits with the rows of ``X`` split over ``mesh``
    (counterpart of ``sq_learn_tpu/parallel/init.py:301-340``): ``X`` (a
    tensor on the mesh's first device) is padded to a multiple of
    ``NBLOCKS`` with zero-weight rows, which are never selected, and
    sharded. The uniforms come from ``generator`` exactly as
    :func:`kmeans_plusplus_batched` draws them, so the selected indices,
    and the centers, which are data rows, equal its own on the same
    generator (no subsample). A mesh whose shard count does not divide
    ``NBLOCKS`` raises. Returns (centers (R, k, m), indices (R, k)) on the
    mesh's first device."""
    n_dev = mesh.size
    if NBLOCKS % n_dev:
        raise ValueError(
            f"mesh of {n_dev} devices does not divide the {NBLOCKS}-block "
            f"sampling grid")
    n = X.shape[0]
    if x_sq_norms is None:
        x_sq_norms = torch.sum(X * X, dim=1)
    if weights is None:
        weights = torch.ones(n, dtype=X.dtype, device=X.device)
    if n_local_trials is None:
        n_local_trials = _default_trials(n_clusters)
    with _obs.span("parallel.init.kmeans_plusplus_sharded",
                   n_devices=n_dev, n_samples=int(n),
                   n_clusters=int(n_clusters)) as sp:
        padded = [pad_to_multiple(a, NBLOCKS)[0]
                  for a in (X, x_sq_norms, weights)]
        Xs, xs, ws = shard_rows(mesh, *padded, n=n)
        u = torch.rand((n_restarts, 1 + (n_clusters - 1) * n_local_trials),
                       generator=generator, dtype=X.dtype, device=X.device)
        centers, indices = _kpp_run_sharded(
            mesh, u[:, 0].to(mesh.lead),
            u[:, 1:].reshape(n_restarts, n_clusters - 1,
                             n_local_trials).to(mesh.lead),
            Xs, xs, ws, n_clusters=n_clusters)
        sp.sync(centers)
    return centers, indices
