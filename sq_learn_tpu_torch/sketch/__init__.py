"""Sketched spectral-statistics engine (counterpart of
``sq_learn_tpu/sketch``): the runtime-model statistics σ_min(A), μ(A),
‖A‖_F and η, estimated from a uniform row sample with certified bounds, or
exact at zero budget or small shapes, and a digest-keyed cache for
repeated :func:`mu_stats` / :func:`frobenius_squared` calls over one
array."""

from . import cache
from .engine import (SpectralStats, exact_spectral_stats, frobenius_squared,
                     mu_stats, resolve_sketch_rows, sketch_delta_stat,
                     spectral_stats)

__all__ = [
    "SpectralStats",
    "cache",
    "exact_spectral_stats",
    "frobenius_squared",
    "mu_stats",
    "resolve_sketch_rows",
    "sketch_delta_stat",
    "spectral_stats",
]
