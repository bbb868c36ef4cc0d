"""Spectral statistics of the q-means runtime model (counterpart of
``sq_learn_tpu/sketch/engine.py``, exact part only).

The exact statistics are wrapped in a :class:`SpectralStats` bundle whose
certified bounds equal the values, so the estimator reads μ and κ through
the same conservative folding rule the sketched route uses in the JAX
package. The sketched estimators wait for the qPCA slice.
"""

import dataclasses

import numpy as np

from ..ops.quantum.norms import _grid_exponents, select_mu


@dataclasses.dataclass
class SpectralStats:
    """One bundle of runtime-model statistics with certified bounds
    (``sigma_min_lower`` ≤ σ_min, ``mu_upper`` ≥ μ_p); on the exact path
    the bounds coincide with the values. ``cost`` carries the estimated
    FLOP counts of the computation."""

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


def _flop_costs(n, s, m, n_qpos):
    """Estimated FLOPs of the sketched computation vs the exact one it
    replaces (Gram + μ sweep + cheap pass; transcendentals counted 1)."""
    sweep = 2 * n_qpos + 2
    return {
        "sketch_flops": float(s) * m * m + float(s) * m * sweep
        + 4.0 * n * m,
        "exact_flops": float(n) * m * m + float(n) * m * sweep,
    }


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
