"""Measurement-count sampling primitives (counterpart of
``sq_learn_tpu/ops/quantum/sampling.py``).

Measurements are never materialized: outcome *counts* are drawn directly
from a multinomial. The JAX package's XLA path draws them by a d-step
conditional binomial chain, d dependent launches on a GPU (70 000 for a
left singular vector of MNIST). :func:`multinomial_counts` draws the same
distribution with a binary split tree instead: each level splits every
node's count between its two children by one binomial draw, so a call
takes ⌈log₂ d⌉ levels, each one ``torch.binomial`` over every node of
every row.
"""

import math

import numpy as np
import torch


def _filled(x, shape, dtype, device):
    """``x`` broadcast to ``shape`` as a tensor on ``device``. A scalar is
    written on the device (a fill): a host→device copy from pageable
    memory makes the host wait for the device, once per call of a search
    iteration otherwise."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(device=device, dtype=dtype), shape)
    if np.ndim(x) == 0:
        return torch.full(tuple(shape), float(x), dtype=dtype, device=device)
    return torch.broadcast_to(torch.as_tensor(np.asarray(x), dtype=dtype,
                                              device=device), shape)


def _as_tensor(x, generator, dtype=torch.float32):
    """``x`` as a tensor: a tensor is kept as it is, anything else lands on
    the generator's device in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x
    return _filled(x, np.shape(x), dtype, generator.device)


def multinomial_counts(generator, n, probs):
    """Sample outcome counts of ``n`` categorical draws.

    Parameters
    ----------
    generator : torch.Generator on the device of ``probs``
    n : number or tensor broadcastable to the batch shape of ``probs``
        Number of measurements (may differ per row).
    probs : (..., d) tensor
        Outcome probabilities along the last axis (need not be normalized).

    Returns
    -------
    counts : (..., d) float64 tensor summing to ``n`` along the last axis.
        float64 holds the integer counts exactly: the tomography count
        N = 36·d·ln d/δ² reaches ~1.8·10⁸ for d = 70 000 at δ = 0.4, past
        float32's 2²⁴. A row whose mass is zero or not finite comes back
        NaN, as on the JAX package's XLA path.

    The tree: leaf masses padded with zeros to 2^L, L = ⌈log₂ d⌉; the mass
    of every node is summed bottom-up, then from the root down each node's
    count c splits as Binomial(c, mass(left)/mass(node)) to the left and
    the rest to the right — exactly the multinomial distribution.
    ``multinomial_counts.binomial_calls`` counts the ``torch.binomial``
    calls (one per level).
    """
    p = probs.to(torch.float64)
    batch, d = p.shape[:-1], p.shape[-1]
    levels = max(1, math.ceil(math.log2(d))) if d > 1 else 0
    width = 1 << levels
    flat = p.reshape(-1, d)
    rows = flat.shape[0]
    leaves = torch.zeros((rows, width), dtype=torch.float64, device=p.device)
    leaves[:, :d] = flat
    mass = [leaves]
    for _ in range(levels):
        mass.append(mass[-1].view(rows, -1, 2).sum(-1))
    mass.reverse()  # mass[l]: (rows, 2^l)
    total = mass[0][:, 0]
    ok = torch.isfinite(total) & (total > 0)
    n = _filled(n, batch, torch.float64, p.device)
    counts = n.reshape(rows, 1).clone()
    for level in range(levels):
        node = mass[level]
        left = mass[level + 1][:, 0::2]
        ratio = torch.where(node > 0, left / torch.where(node > 0, node, 1.0),
                            torch.zeros_like(node)).clamp_(0.0, 1.0)
        ratio = torch.where(ok[:, None], ratio, torch.zeros_like(ratio))
        to_left = torch.binomial(counts, ratio, generator=generator)
        multinomial_counts.binomial_calls += 1
        counts = torch.stack([to_left, counts - to_left], dim=-1).view(
            rows, -1)
    out = counts[:, :d]
    out = torch.where(ok[:, None], out, torch.full_like(out, math.nan))
    return out.reshape(*batch, d)


multinomial_counts.binomial_calls = 0


def estimate_wald(counts, n):
    """Wald (empirical frequency) estimator from measurement counts
    (reference ``estimate_wald``, ``Utility.py:61``)."""
    return counts / n


def fejer_probs(delta, M):
    """Pointwise Fejér-kernel probability |sin(MΔπ) / (M·sin(Δπ))|², the
    output distribution of amplitude (``Utility.py:498-506``) and phase
    estimation (``Utility.py:642-650``) at grid distance Δ from the true
    value; the removable singularity at Δ ∈ ℤ is taken to 1."""
    delta = torch.as_tensor(delta)
    if not delta.is_floating_point():
        delta = delta.to(torch.float32)
    sin_d = torch.sin(math.pi * delta)
    singular = torch.abs(sin_d) < 1e-12
    safe = torch.where(singular, torch.ones_like(sin_d), sin_d)
    p = (torch.sin(math.pi * M * delta) / (M * safe)) ** 2
    return torch.where(singular, torch.ones_like(p), p)


def fejer_grid_sample(generator, pos, M, window, sample_shape=()):
    """Sample grid indices from the Fejér measurement distribution.

    Draws j ∈ {0, …, M−1} (mod-M wrapped) with
    P(j) ∝ |sin(π(pos−j)) / (M·sin(π(pos−j)/M))|², the exact amplitude or
    phase estimation output distribution for a register of M grid points
    whose true value sits at fractional grid position ``pos``. Only the
    ``2·window+1`` grid points nearest ``pos`` are enumerated, masked to at
    most M unique residues: exact when M ≤ 2·window+1, otherwise the
    O(1/window) tail is renormalized onto the window, which can only raise
    the within-ε success probability (the JAX function's contract).

    Parameters
    ----------
    generator : torch.Generator on the device of ``pos``
    pos : (...,) float tensor — true value in grid units (value·M).
    M : (...,) float tensor or scalar — grid size per element.
    window : int — half-width of the enumerated window.
    sample_shape : tuple — leading shape of independent samples.

    Returns
    -------
    j : float tensor of shape ``sample_shape + pos.shape``, in [0, M).
    """
    pos = _as_tensor(pos, generator)
    M = _filled(M, pos.shape, pos.dtype, pos.device)
    offs = torch.arange(-window, window + 1, dtype=pos.dtype,
                        device=pos.device)
    base = torch.floor(pos)
    j = base[..., None] + offs  # (..., 2W+1) candidate (unwrapped) indices
    delta = (pos[..., None] - j) / M[..., None]
    p = fejer_probs(delta, M[..., None])
    # keep exactly min(2W+1, M) unique residues mod M: offsets in (−M/2, M/2]
    centered = j - base[..., None]
    valid = (centered > -M[..., None] / 2) & (centered <= M[..., None] / 2)
    # inverse-CDF draw: one uniform and 2W+1 compares per sample
    cum = torch.cumsum(torch.where(valid, p, torch.zeros_like(p)), dim=-1)
    # u on (0, 1]: u == 0 would select index 0 even when it is masked
    u = 1.0 - torch.rand(tuple(sample_shape) + tuple(pos.shape),
                         generator=generator, dtype=pos.dtype,
                         device=pos.device)
    thresh = u * cum[..., -1]
    idx = torch.sum(cum < thresh[..., None], dim=-1)
    idx = torch.clamp(idx, 0, 2 * window)
    j_sel = base + (idx.to(pos.dtype) - window)
    return torch.remainder(j_sel, M)
