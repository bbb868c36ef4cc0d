"""μ(A) quantum-memory-model norm search (counterpart of
``sq_learn_tpu/ops/quantum/norms.py``).

μ_p(A) = √(s_{2p}(A) · s_{2(1−p)}(Aᵀ)) with s_q(A) = max_i ‖A_i‖_q^q,
evaluated for every p of a grid in one elementwise sweep, then compared
against the Frobenius norm (reference ``Utility.py:196-231``).
"""

import numpy as np
import torch

#: row-block height of the tiled sweep: blocks of ~2^18 elements bound the
#: temporaries of the power chain (|A| tile, log tile, base, running
#: power) to a few MiB whatever the matrix's height
_TILE_ELEMS = 1 << 18


def _grid_exponents(grid):
    """The exponent set a μ grid needs — 2p for the row factor and 2(1−p)
    for the column factor draw from the same set — plus the uniform-step
    flag that enables the multiplication chain."""
    qs = sorted({round(2 * p, 12) for p in grid}
                | {round(2 * (1 - p), 12) for p in grid})
    qpos = [q for q in qs if q > 0]
    steps = {round(b - a, 12) for a, b in zip(qpos, qpos[1:])}
    uniform = bool(qpos) and (not steps or steps == {round(qpos[0], 12)})
    return qs, qpos, uniform


def _power_sweep(tile, qs, qpos, uniform):
    """Reductions of |tile|^q for every exponent q.

    Returns ``(row_max, cols)`` stacked over qs: row_max (|qs|,) —
    max_i Σ_j |a_ij|^q; cols (|qs|, m) — Σ_i |a_ij|^q. With a uniformly
    spaced exponent set the powered matrices form a multiplication chain
    |A|^{i·d} = (|A|^d)^i: one exp pass, then one multiply per grid point.
    """
    absT = torch.abs(tile)
    nz = absT > 0
    logT = torch.log(torch.where(nz, absT, torch.ones_like(absT)))
    zero = torch.zeros((), dtype=tile.dtype, device=tile.device)
    row_max, cols = {}, {}

    def record(q, P):
        row_max[q] = torch.max(torch.sum(P, dim=1))
        cols[q] = torch.sum(P, dim=0)

    if 0 in qs:
        record(0, nz.to(tile.dtype))  # reference Utility.py:198-203
    if uniform:
        base = torch.where(nz, torch.exp(qpos[0] * logT), zero)
        P = base
        for q in qpos:
            record(q, P)
            P = P * base
    else:
        for q in qpos:
            record(q, torch.where(nz, torch.exp(q * logT), zero))
    return (torch.stack([row_max[q] for q in qs]),
            torch.stack([cols[q] for q in qs]))


def _mu_grid(A, grid):
    """μ_p for every p of the (static) grid, one fused sweep over A."""
    qs, qpos, uniform = _grid_exponents(grid)
    row_max, cols = _power_sweep(A, qs, qpos, uniform)
    return _combine(grid, qs, row_max, torch.max(cols, dim=1).values)


def _mu_grid_blocked(A, grid):
    """:func:`_mu_grid` over row tiles of ``_TILE_ELEMS`` elements
    (reference ``_mu_grid_blocked``): each tile runs the whole power
    chain, its row maxima are exact (a row is never split) and its column
    power sums add up across tiles in tile order, so the temporaries are
    bounded by one tile."""
    n, m = A.shape
    qs, qpos, uniform = _grid_exponents(grid)
    block = max(1, _TILE_ELEMS // max(m, 1))
    row_max = cols = None
    for r0 in range(0, n, block):
        rows, c = _power_sweep(A[r0:r0 + block], qs, qpos, uniform)
        row_max = rows if row_max is None else torch.maximum(row_max, rows)
        cols = c if cols is None else cols + c
    if row_max is None:
        return _mu_grid(A, grid)
    return _combine(grid, qs, row_max, torch.max(cols, dim=1).values)


def mu(A, p):
    """μ_p(A) for a single p ∈ [0, 1]."""
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"mu is defined for p in [0, 1], got {p}")
    return _mu_grid(A, (p,))[0]


def _search_grid(start, end, step):
    """Validated p-grid shared by :func:`linear_search` and
    :func:`best_mu`."""
    if not 0.0 <= start <= end <= 1.0:
        raise ValueError(
            f"mu grid must satisfy 0 <= start <= end <= 1, got "
            f"[{start}, {end}]")
    if step <= 0:
        raise ValueError(f"mu grid step must be > 0, got {step}")
    return tuple(float(p) for p in np.arange(start, end, step)) + (float(end),)


def linear_search(A, start=0.0, end=1.0, step=0.05):
    """Grid-minimize μ_p over p ∈ [start, end] ⊆ [0, 1] (reference
    ``linear_search``, ``Utility.py:215-219``). Returns
    (best_p, best_value)."""
    grid = _search_grid(start, end, step)
    vals = _mu_grid(A, grid).cpu().numpy()
    idx = int(np.argmin(vals))
    return grid[idx], float(vals[idx])


def _combine(grid, qs, row_max, col_max):
    """μ_p = √(s_{2p}(A)·s_{2(1−p)}(Aᵀ)) from the stacked per-q factors."""
    idx = {q: i for i, q in enumerate(qs)}
    vals = [torch.sqrt(row_max[idx[round(2 * p, 12)]]
                       * col_max[idx[round(2 * (1 - p), 12)]])
            for p in grid]
    return torch.stack(vals)


def select_mu(grid, mu_vals, frob):
    """Host-side winner between the μ_p grid and the Frobenius norm
    (reference ``best_mu``, ``Utility.py:222-231``).

    Returns (description, value): description is ``"p=<best_p>"`` or
    ``"Frobenius"``.
    """
    if isinstance(mu_vals, torch.Tensor):
        mu_vals = mu_vals.cpu().numpy()
    mu_vals = np.asarray(mu_vals)
    idx = int(np.argmin(mu_vals))
    val = float(mu_vals[idx])
    frob = float(frob)
    if val <= frob:
        return f"p={grid[idx]}", val
    return "Frobenius", frob


def best_mu(A, start=0.0, end=1.0, step=0.05):
    """Best of grid-searched μ_p and the Frobenius norm (reference
    ``best_mu``, ``Utility.py:222-231``).

    Returns (description, value): description is ``"p=<best_p>"`` or
    ``"Frobenius"``.
    """
    grid = _search_grid(start, end, step)
    vals = _mu_grid(A, grid)
    frob = torch.linalg.norm(A)
    return select_mu(grid, vals.cpu().numpy(), float(frob))
