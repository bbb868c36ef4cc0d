"""Quantum simulation runtime (counterpart of ``sq_learn_tpu/ops/quantum``,
the reference's ``sklearn/QuantumUtility/``).

Every routine is a plain function on tensors; every random draw takes an
explicit ``torch.Generator`` on the device the draws are made on.
"""

from .estimation import (
    amplitude_estimation,
    amplitude_estimation_M,
    amplitude_estimation_per_eps,
    consistent_phase_estimation,
    inner_product_estimates,
    ipe,
    median_evaluation,
    median_q,
    phase_estimation,
    phase_estimation_m,
    sv_to_theta,
    theta_to_sv,
)
from .noise import (
    gaussian_estimate,
    introduce_error,
    introduce_error_array,
    truncated_noise,
)
from .norms import best_mu, linear_search, mu
from .sampling import estimate_wald, fejer_grid_sample, fejer_probs, multinomial_counts
from .state import QuantumState, coupon_collect
from .tomography import (
    magnitude_tomography_signed,
    real_tomography,
    tomography,
    tomography_incremental,
    tomography_n_measurements,
)

__all__ = [
    "QuantumState",
    "amplitude_estimation",
    "amplitude_estimation_M",
    "amplitude_estimation_per_eps",
    "best_mu",
    "consistent_phase_estimation",
    "coupon_collect",
    "estimate_wald",
    "fejer_grid_sample",
    "fejer_probs",
    "gaussian_estimate",
    "inner_product_estimates",
    "introduce_error",
    "introduce_error_array",
    "ipe",
    "linear_search",
    "median_evaluation",
    "median_q",
    "mu",
    "multinomial_counts",
    "phase_estimation",
    "phase_estimation_m",
    "magnitude_tomography_signed",
    "real_tomography",
    "sv_to_theta",
    "theta_to_sv",
    "tomography",
    "tomography_incremental",
    "tomography_n_measurements",
    "truncated_noise",
]
