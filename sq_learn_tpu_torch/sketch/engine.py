"""Randomized spectral-statistics estimators with certified error bounds
(counterpart of ``sq_learn_tpu/sketch/engine.py``, its device route).

From ONE uniform row sample S of size s, scaled by n/s, plus one exact
O(n·m) pass over the whole matrix:

- σ_min(A): λ_min of the scaled sketch Gram Ĝ = (n/s)·X_Sᵀ X_S, with a
  matrix-Bernstein bound on ‖Ĝ − G‖ (Tropp 2015, thm 6.1.1) giving the
  certified lower bound σ_lb = √max(λ_min(Ĝ) − t, 0), P(σ_lb > σ_min) ≤ δ_σ.
- μ_p(A) = √(s_{2p}(A)·s_{2(1−p)}(Aᵀ)): the sampled row maximum is the
  plug-in estimate, its certified upper bound the deterministic Hölder
  cap; the scaled column sums carry a Hoeffding/Serfling bound, union-
  bounded over the columns and exponents. Since the reference's
  ``best_mu`` takes min(min_p μ_p, ‖A‖_F), the conservative μ never
  exceeds the exact Frobenius norm.
- ‖A‖_F, η = max‖xᵢ‖², max|aᵢⱼ| and the largest column square norm are
  exact (the cheap pass).

Downstream consumers take σ_min → its lower bound and μ → its upper bound,
so a runtime estimate is an upper bound w.p. ≥ 1 − δ_stat (δ_stat split
evenly between the σ and μ claims). δ_stat = 0 or a shape below the
engagement rule computes the exact kernels (:func:`exact_spectral_stats`).

A numpy input is validated to a tensor on the configured device first, so
every call takes the device route; the JAX package's host engine
(``dispatch_host``) is not ported. ``SQ_SKETCH_ROWS`` and
``SQ_SKETCH_DELTA`` are read as the JAX package reads them.

Under an obs run the exact path records the zero-budget ``sketch.stats``
short-circuit, and a sketched estimate its FLOP counters and, below
:data:`AUDIT_ELEMS` matrix elements, its own guarantee draws against the
exact statistics (:func:`audit_sketch`).
"""

import dataclasses
import math

import numpy as np
import torch

from .. import _knobs
from .. import obs as _obs
from ..ops.linalg import smallest_eigenvalue
from ..ops.quantum.norms import _grid_exponents, _power_sweep, select_mu

__all__ = [
    "SpectralStats",
    "audit_sketch",
    "exact_spectral_stats",
    "fetch_components",
    "frobenius_squared",
    "mu_stats",
    "record_sketch_obs",
    "resolve_sketch_rows",
    "sketch_components",
    "sketch_delta_stat",
    "spectral_stats",
]

#: seed offset of a fit's row sample (the JAX package folds the same
#: constant into its key)
SKETCH_SEED = 0x5CE7

#: default sketch failure budget δ_stat (env ``SQ_SKETCH_DELTA``)
DEFAULT_DELTA_STAT = 0.05

#: matrix elements above which a sketch is not audited against the exact
#: statistics: the audit would rival the sweep the sketch replaces
AUDIT_ELEMS = 8_000_000


def sketch_delta_stat():
    """The sketch engine's failure budget δ_stat (``SQ_SKETCH_DELTA``,
    default 0.05). 0 disables sketching entirely (zero-budget = exact)."""
    env = _knobs.get_raw("SQ_SKETCH_DELTA")
    return float(env) if env else DEFAULT_DELTA_STAT


def resolve_sketch_rows(n_samples, n_features, setting="auto"):
    """Row count of the uniform sketch sample (0 = exact kernels).

    'auto' targets ``max(4096, 2·m)`` rows and engages only when the data
    is ≥4× larger AND tall (n ≥ m); ``SQ_SKETCH_ROWS`` overrides the 'auto'
    target (0 disables); explicit integers are used as given (0/None/False
    disables). A zero δ_stat also disables.
    """
    if setting == "auto":
        env = _knobs.get_raw("SQ_SKETCH_ROWS")
        if env is not None:
            setting = int(float(env))
    if setting == "auto":
        target = max(4096, 2 * int(n_features))
    elif not setting:
        return 0
    else:
        target = int(setting)
    if n_samples < 4 * target or n_samples < n_features:
        return 0
    if sketch_delta_stat() <= 0:
        return 0
    return target


@dataclasses.dataclass
class SpectralStats:
    """One bundle of runtime-model statistics with certified bounds.

    Plug-in estimates (``sigma_min``, ``mu_vals``) and certified bounds
    (``sigma_min_lower`` ≤ σ_min w.p. ≥ 1−δ_stat/2; ``mu_upper`` ≥ μ_p
    w.p. ≥ 1−δ_stat/2) coincide on the exact path. ``cost`` carries the
    estimated FLOP counts of the computation and of the exact one.
    """

    eta: float
    frob: float
    sigma_min: float
    sigma_min_lower: float
    mu_grid: tuple
    mu_vals: np.ndarray
    mu_upper: np.ndarray
    delta_stat: float
    sketched: bool
    sample_rows: int
    shape: tuple
    cost: dict

    def conservative_mu(self):
        """(description, value) of the conservative μ: the reference's
        ``best_mu`` winner rule over the per-p upper bounds vs the exact
        Frobenius norm."""
        return select_mu(self.mu_grid, self.mu_upper, self.frob)

    def condition_number(self):
        """Conservative κ = 1/σ_lb; the plug-in estimate when the bound is
        vacuous, inf when σ_min is 0."""
        if self.sigma_min_lower > 0:
            return 1.0 / self.sigma_min_lower
        if self.sigma_min > 0:
            return 1.0 / self.sigma_min
        return np.inf

    def certified_sigma(self):
        return (not self.sketched) or self.sigma_min_lower > 0

    def info(self):
        """JSON-able summary for estimator ``sketch_info_`` attributes."""
        return {
            "sketched": self.sketched,
            "sample_rows": int(self.sample_rows),
            "delta_stat": float(self.delta_stat),
            "shape": tuple(int(v) for v in self.shape),
            "eta": float(self.eta),
            "frob": float(self.frob),
            "sigma_min_estimate": float(self.sigma_min),
            "sigma_min_lower": float(self.sigma_min_lower),
            "sigma_certified": bool(self.certified_sigma()),
            "mu_estimate": float(np.min(self.mu_vals)) if len(
                self.mu_vals) else None,
            "mu_upper": float(np.min(self.mu_upper)) if len(
                self.mu_upper) else None,
            "cost": {k: float(v) for k, v in self.cost.items()},
        }


# ---------------------------------------------------------------------------
# Device passes
# ---------------------------------------------------------------------------


def sample_kernel(Xs, scale, *, mu_grid, with_sigma=True):
    """The sketch pass over the (s, m) sampled rows: one flat float32
    tensor ``[lam_min?] + row_fac(nq) + col_fac(nq)``, where ``lam_min`` is
    λ_min of the scaled sketch Gram (``with_sigma`` only), ``row_fac[q]``
    the sampled maximum row power sum and ``col_fac[q]`` the scaled column
    power sums' maximum (exponent order = ``_grid_exponents(mu_grid)[0]``).
    """
    qs, qpos, uniform = _grid_exponents(mu_grid)
    row_max, cols = _power_sweep(Xs, qs, qpos, uniform)
    parts = []
    if with_sigma:
        G = (Xs.T @ Xs) * scale
        parts.append(smallest_eigenvalue(G)[None].to(torch.float32))
    parts.append(row_max.to(torch.float32))
    parts.append((torch.max(cols, dim=1).values * scale).to(torch.float32))
    return torch.cat(parts)


def cheap_pass_kernel(X):
    """The exact O(n·m) statistics every bound feeds on:
    ``[eta, frob, amax, colsq_max]`` (max row sq-norm, Frobenius norm,
    max |entry|, max column sq-norm)."""
    sq = X * X
    rowsq = torch.sum(sq, dim=1)
    colsq = torch.sum(sq, dim=0)
    return torch.stack([torch.max(rowsq), torch.sqrt(torch.sum(rowsq)),
                        torch.max(torch.abs(X)), torch.max(colsq)])


def sketch_components(X, idx, mu_grid, with_sigma=True):
    """The sketched components of ``X`` from its sampled rows ``idx`` (an
    (s,) index tensor on X's device), as device tensors (counterpart of
    ``sketch_components_traced``, the variant a fit folds into its own
    steps): ``eta``, ``frob``, ``amax``, ``colsq_max`` from
    :func:`cheap_pass_kernel`, ``row_fac``, ``col_fac`` and, with
    ``with_sigma``, ``lam_min`` from :func:`sample_kernel`. Nothing is
    fetched; :func:`finalize_components` takes the host copies."""
    cheap = cheap_pass_kernel(X)
    flat = sample_kernel(X[idx], X.shape[0] / idx.shape[0],
                         mu_grid=tuple(mu_grid), with_sigma=with_sigma)
    off = 1 if with_sigma else 0
    nq = (flat.shape[0] - off) // 2
    out = {"eta": cheap[0], "frob": cheap[1], "amax": cheap[2],
           "colsq_max": cheap[3], "row_fac": flat[off:off + nq],
           "col_fac": flat[off + nq:]}
    if with_sigma:
        out["lam_min"] = flat[0]
    return out


def fetch_components(comp):
    """Host copies of :func:`sketch_components`' tensors, in one
    device→host copy: floats for the scalars, float64 arrays for the
    factors."""
    names = list(comp)
    flat = torch.cat([comp[k].reshape(-1).to(torch.float64)
                      for k in names]).cpu().numpy()
    out, pos = {}, 0
    for k in names:
        size = comp[k].numel()
        out[k] = flat[pos:pos + size] if comp[k].ndim else float(flat[pos])
        pos += size
    return out


# ---------------------------------------------------------------------------
# Bound math (host side — plain floats)
# ---------------------------------------------------------------------------


def _row_cap(q, m, eta, amax):
    """Deterministic Hölder cap on s_q(A) = max row power sum."""
    if q == 0:
        return float(m)
    if q <= 2:
        return float(m) ** (1.0 - q / 2.0) * float(eta) ** (q / 2.0)
    return float(amax) ** (q - 2.0) * float(eta)


def _col_cap(q, n, colsq_max, amax):
    """Deterministic Hölder cap on s_q(Aᵀ) = max column power sum
    (monotone in the column sq-norm, so the max column suffices)."""
    if q == 0:
        return float(n)
    if q <= 2:
        return float(n) ** (1.0 - q / 2.0) * float(colsq_max) ** (q / 2.0)
    return float(amax) ** (q - 2.0) * float(colsq_max)


def _bernstein_gram_deviation(n, s, m, eta, frob, delta):
    """Matrix-Bernstein tail t with P(‖Ĝ − G‖ ≥ t) ≤ δ for the scaled
    row-sampled Gram: per-sample range L ≤ n·η + ‖G‖ and variance proxy
    v ≤ n·η·‖G‖, with ‖G‖ ≤ min(n·η, ‖A‖_F²)."""
    g_ub = min(float(n) * float(eta), float(frob) ** 2)
    ell = math.log(2.0 * max(int(m), 1) / float(delta))
    v = float(n) * float(eta) * g_ub
    L = float(n) * float(eta) + g_ub
    return math.sqrt(2.0 * v * ell / s) + 2.0 * L * ell / (3.0 * s)


def _flop_costs(n, s, m, n_qpos):
    """Estimated FLOPs of the sketched computation vs the exact one it
    replaces (Gram + μ sweep + cheap pass; transcendentals counted 1)."""
    sweep = 2 * n_qpos + 2
    return {
        "sketch_flops": float(s) * m * m + float(s) * m * sweep
        + 4.0 * n * m,
        "exact_flops": float(n) * m * m + float(n) * m * sweep,
    }


def finalize_components(comp, *, n, m, s, mu_grid, delta_stat):
    """Fold the fetched sketch components (``eta``, ``frob``, ``amax``,
    ``colsq_max``, ``row_fac``, ``col_fac`` and, with σ, ``lam_min``) into
    a :class:`SpectralStats` with certified bounds."""
    qs, qpos, _ = _grid_exponents(mu_grid)
    eta = float(comp["eta"])
    frob = float(comp["frob"])
    amax = float(comp["amax"])
    colsq_max = float(comp["colsq_max"])
    row_fac = np.asarray(comp["row_fac"], np.float64)
    col_fac = np.asarray(comp["col_fac"], np.float64)
    d_sigma = d_mu = float(delta_stat) / 2.0

    lam_min = comp.get("lam_min")
    if lam_min is not None:
        lam_min = float(lam_min)
        t = _bernstein_gram_deviation(n, s, m, eta, frob, d_sigma)
        sigma_est = math.sqrt(max(lam_min, 0.0))
        sigma_lb = math.sqrt(max(lam_min - t, 0.0))
    else:
        sigma_est = sigma_lb = 0.0

    idx = {q: i for i, q in enumerate(qs)}
    # Hoeffding deviation per exponent for the scaled column sums, union
    # over the m columns and the exponent set (sampling without
    # replacement: Hoeffding 1963 §6 keeps the with-replacement bound)
    ell_mu = math.log(max(int(m), 1) * max(len(qs), 1) / d_mu)
    mu_vals, mu_upper = [], []
    for p in mu_grid:
        qr, qc = round(2 * p, 12), round(2 * (1 - p), 12)
        r_est, c_est = row_fac[idx[qr]], col_fac[idx[qc]]
        r_ub = _row_cap(qr, m, eta, amax)
        amax_qc = float(amax) ** qc if qc > 0 else 1.0
        t_c = float(n) * amax_qc * math.sqrt(ell_mu / (2.0 * s))
        c_ub = min(float(c_est) + t_c, _col_cap(qc, n, colsq_max, amax))
        mu_vals.append(math.sqrt(max(float(r_est) * float(c_est), 0.0)))
        mu_upper.append(math.sqrt(max(r_ub * c_ub, 0.0)))
    return SpectralStats(
        eta=eta, frob=frob, sigma_min=sigma_est, sigma_min_lower=sigma_lb,
        mu_grid=tuple(mu_grid), mu_vals=np.asarray(mu_vals),
        mu_upper=np.asarray(mu_upper), delta_stat=float(delta_stat),
        sketched=True, sample_rows=int(s), shape=(int(n), int(m)),
        cost=_flop_costs(n, s, m, len(qpos)))


# ---------------------------------------------------------------------------
# Exact short-circuit
# ---------------------------------------------------------------------------


def exact_bundle(mu_grid, eta, frob, sigma_min, mu_vals, shape=None):
    """Wrap already-computed EXACT statistics into a :class:`SpectralStats`
    (bounds equal the values)."""
    mu_vals = np.asarray(mu_vals, np.float64)
    qs, qpos, _ = _grid_exponents(mu_grid)
    n, m = (int(shape[0]), int(shape[1])) if shape is not None else (0, 0)
    return SpectralStats(
        eta=float(eta), frob=float(frob), sigma_min=float(sigma_min),
        sigma_min_lower=float(sigma_min), mu_grid=tuple(mu_grid),
        mu_vals=mu_vals, mu_upper=mu_vals.copy(), delta_stat=0.0,
        sketched=False, sample_rows=0, shape=(n, m),
        cost=_flop_costs(n, max(n, 1), m, len(qpos)))


def exact_spectral_stats(X, mu_grid, with_sigma=True):
    """The exact kernels, packaged: the SAME ``smallest_singular_value`` /
    ``_mu_grid`` code the fits use, with bounds equal to the values (so
    ``conservative_mu`` is bit-equal to :func:`best_mu`'s winner). Records
    the zero-budget ``sketch.stats`` short-circuit under an obs run."""
    from ..ops.linalg import row_norms, smallest_singular_value
    from ..ops.quantum.norms import _mu_grid

    n, m = X.shape
    eta = float(torch.max(row_norms(X, squared=True)))
    frob = float(torch.linalg.norm(X))
    sigma = float(smallest_singular_value(X)) if with_sigma else 0.0
    mu_vals = _mu_grid(X, tuple(mu_grid)).cpu().numpy().astype(np.float64)
    qs, qpos, _ = _grid_exponents(mu_grid)
    if _obs.guarantees.enabled():
        _obs.guarantees.record_guarantee(
            "sketch.stats", 0.0, 0.0, fail_prob=0.0, short_circuit=True,
            estimator="sketch")
    return SpectralStats(
        eta=eta, frob=frob, sigma_min=sigma, sigma_min_lower=sigma,
        mu_grid=tuple(mu_grid), mu_vals=mu_vals, mu_upper=mu_vals.copy(),
        delta_stat=0.0, sketched=False, sample_rows=0,
        shape=(int(n), int(m)),
        cost=_flop_costs(n, max(int(n), 1), m, len(qpos)))


# ---------------------------------------------------------------------------
# Sample and fetch
# ---------------------------------------------------------------------------


def sample_indices(rng, n, rows):
    """Sorted uniform without-replacement row sample from a numpy
    ``Generator`` (sorted: the gather walks memory forward; the estimators
    are permutation-invariant)."""
    return np.sort(rng.choice(int(n), size=int(rows), replace=False))


def _as_device_tensor(X):
    if isinstance(X, torch.Tensor):
        return X
    from .._config import resolve_device
    from ..utils.validation import check_array

    return check_array(X, device=resolve_device())


def spectral_stats(X, mu_grid, *, delta_stat=None, sketch="auto",
                   with_sigma=True, rng=None, audit=True):
    """Estimate the spectral statistics of ``X`` (a tensor, or an array
    validated onto the configured device), sketched when the engagement
    rule fires, exact otherwise. ``rng`` is the numpy ``Generator`` of the
    row sample (default ``default_rng(0)``). ``audit=False`` computes and
    records no guarantee draw (:func:`audit_sketch`)."""
    X = _as_device_tensor(X)
    n, m = X.shape
    if delta_stat is None:
        delta_stat = sketch_delta_stat()
    rows = resolve_sketch_rows(n, m, sketch) if delta_stat > 0 else 0
    if not rows:
        return exact_spectral_stats(X, mu_grid, with_sigma=with_sigma)
    if rng is None:
        rng = np.random.default_rng(0)
    with _obs.span("sketch.stats", n=n, m=m, rows=rows,
                   with_sigma=with_sigma):
        idx = torch.as_tensor(sample_indices(rng, n, rows), device=X.device)
        comp = fetch_components(sketch_components(X, idx, mu_grid,
                                                  with_sigma=with_sigma))
        stats = finalize_components(comp, n=n, m=m, s=rows,
                                    mu_grid=tuple(mu_grid),
                                    delta_stat=delta_stat)
        record_sketch_obs(stats)
        if audit:
            audit_sketch(stats, X)
    return stats


def record_sketch_obs(stats):
    """Obs counters of a sketched estimate: the estimated FLOPs of the
    sketched computation and of the exact sweep it replaced."""
    if not _obs.enabled() or not stats.sketched:
        return
    _obs.counter_add("sketch.flops", stats.cost["sketch_flops"])
    _obs.counter_add("sketch.exact_equiv_flops", stats.cost["exact_flops"])
    _obs.counter_add("sketch.estimates", 1)


def audit_sketch(stats, X):
    """Guarantee draws for the sketch's own contract: with an obs run
    active and the matrix under the audit ceiling, compute the EXACT
    σ_min and μ grid and record how far the certified bounds miss them
    (zero, unless the bound math is wrong) against δ_stat/2 at the
    ``sketch.sigma_min`` / ``sketch.mu`` sites. Above
    :data:`AUDIT_ELEMS` elements the audit is skipped."""
    if not _obs.guarantees.enabled() or not stats.sketched:
        return
    n, m = stats.shape
    if n * m > AUDIT_ELEMS:
        return
    from ..ops.linalg import smallest_singular_value
    from ..ops.quantum.norms import _mu_grid

    tol = 1e-5 * max(1.0, stats.frob)  # float-noise allowance
    if stats.sigma_min_lower > 0:
        sigma_exact = float(smallest_singular_value(X))
        _obs.guarantees.observe(
            "sketch.sigma_min",
            [max(0.0, stats.sigma_min_lower - sigma_exact)], tol,
            fail_prob=stats.delta_stat / 2.0, estimator="sketch",
            sample_rows=stats.sample_rows)
    mu_exact = _mu_grid(X, stats.mu_grid).cpu().numpy().astype(np.float64)
    _obs.guarantees.observe(
        "sketch.mu",
        np.maximum(0.0, mu_exact - np.asarray(stats.mu_upper)), tol,
        fail_prob=stats.delta_stat / 2.0, estimator="sketch",
        sample_rows=stats.sample_rows)


def mu_stats(X, mu_grid, *, sketch="auto", rng=None, tag="mu",
             audit=True):
    """Digest-cached conservative μ-route statistics (no σ_min): one
    :func:`spectral_stats` per (dataset, grid, sketch config, state of the
    row-sample generator), every repeat served from the cache. Consumers
    take ``stats.conservative_mu()``; on the exact path it is bit-equal to
    :func:`best_mu`'s winner. The fits do not read this cache (see
    :mod:`.cache`). ``audit`` is :func:`spectral_stats`'s."""
    from . import cache as _cache

    X = _as_device_tensor(X)
    delta_stat = sketch_delta_stat()
    n, m = X.shape
    rows = resolve_sketch_rows(n, m, sketch) if delta_stat > 0 else 0
    if rows and rng is None:
        rng = np.random.default_rng(0)
    # a sampled entry holds the draw of one generator state: another seed
    # must not read it
    draw = repr(rng.bit_generator.state) if rows else None
    key = _cache.key_for(X, tag, tuple(mu_grid), int(rows),
                         float(delta_stat) if rows else 0.0, draw)
    hit = _cache.lookup(key)
    if hit is not None:
        return hit
    stats = spectral_stats(X, mu_grid, delta_stat=delta_stat,
                           sketch=rows if rows else 0, with_sigma=False,
                           rng=rng, audit=audit)
    _cache.store(key, stats)
    return stats


def frobenius_squared(X):
    """‖X‖_F² through the digest-keyed cache: exact (one O(n·m) pass in
    float64), computed once per dataset across repeated fits."""
    from . import cache as _cache

    key = _cache.key_for(X, "frob2")
    hit = _cache.lookup(key)
    if hit is not None:
        return float(hit)
    if isinstance(X, torch.Tensor):
        val = float(torch.sum(X.to(torch.float64) ** 2))
    else:
        Xn = np.asarray(X)
        val = float(np.einsum("ij,ij->", Xn, Xn, dtype=np.float64))
    _cache.store(key, val)
    return val
