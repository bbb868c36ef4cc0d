"""Batched k-means++ initialization (counterpart of
``sq_learn_tpu/parallel/init.py``, single device).

Every candidate is drawn through the same two-stage sampler as the JAX
kernel: over a fixed grid of ``NBLOCKS`` row blocks, stage 1 inverts the
CDF of the per-block potential sums and stage 2 inverts the CDF inside the
owning block; potential totals are block sums followed by a fixed-order
sum. Restarts are a leading batch dimension. The uniforms a draw consumes
are tensor arguments drawn by the caller from its generator, so a test can
feed the JAX side's uniforms and compare indices.
"""

import math

import torch

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
