"""QuantumUtility — reference-namespace facade (``sklearn/QuantumUtility``).

The reference re-exports its routine library from this package
(``QuantumUtility/__init__.py:5-6``); here the port's tensor
implementations stand behind the reference's names (``Utility.py`` symbol
→ ours), as in ``sq_learn_tpu/QuantumUtility``:

- ``QuantumState`` (:25), ``tomography`` (:107), ``real_tomography``
  (:259), ``amplitude_estimation`` (:442), ``phase_estimation`` (:591),
  ``consistent_phase_estimation`` (:740), ``ipe`` (:697),
  ``median_evaluation`` (:534) — same names.
- ``introduce_error`` (:68) / ``introduce_error_array`` (:71) — same
  names; ``make_gaussian_est`` (:88) → :func:`gaussian_estimate`.
- ``best_mu`` (:222) / ``linear_search`` (:215) / ``mu`` (:196) — same.
- ``estimate_wald`` (:61), ``coupon_collect`` (:75), ``create_rand_vec``
  (:183) — same names.
- ``wrapper_phase_est_arguments`` (:575) / ``unwrap_phase_est_arguments``
  (:584) → :func:`sv_to_theta` / :func:`theta_to_sv`.
- ``L2_tomogrphy_fakeSign`` (:234) → :func:`magnitude_tomography_signed`.

``check_division`` (:425), ``check_measure`` (:414),
``amplitude_est_dist`` (:435), ``auxiliary_fun`` (:404) and
``vectorize_aux_fun`` (:409) are drop-in compatibility shims. Where the
reference draws from a process-global generator, these take an explicit
``torch.Generator``.
"""

import numpy as np
import torch

from ..ops.quantum import (
    QuantumState,
    amplitude_estimation,
    best_mu,
    consistent_phase_estimation,
    coupon_collect,
    estimate_wald,
    gaussian_estimate,
    introduce_error,
    introduce_error_array,
    ipe,
    linear_search,
    median_evaluation,
    mu,
    phase_estimation,
    real_tomography,
    tomography,
    tomography_incremental,
)
from ..ops.quantum.estimation import sv_to_theta, theta_to_sv
from ..ops.quantum.tomography import magnitude_tomography_signed
from ..utils.random import as_generator

# reference name (misspelling and all, Utility.py:234)
L2_tomogrphy_fakeSign = magnitude_tomography_signed

# reference aliases
make_gaussian_est = gaussian_estimate
wrapper_phase_est_arguments = sv_to_theta
unwrap_phase_est_arguments = theta_to_sv


def create_rand_vec(generator, n_vec, len_vec, scale=1.0, type="uniform"):
    """Random (possibly unnormalized) vectors (reference
    ``create_rand_vec``, ``Utility.py:183``): ``n_vec`` vectors of length
    ``len_vec`` on the generator's device."""
    shape = (n_vec, len_vec)
    if type == "uniform":
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (2.0 * u - 1.0) * scale
    if type == "normal":
        return scale * torch.randn(shape, generator=generator,
                                   device=generator.device)
    raise ValueError(f"type must be 'uniform' or 'normal', got {type!r}")


def check_measure(arr, faster_measure_increment):
    """Monotone measure-schedule fixup (reference ``check_measure``,
    ``Utility.py:414``): bump equal/decreasing consecutive entries by
    ``5 + faster_measure_increment`` so the schedule strictly increases."""
    arr = list(arr)
    incr = 5 + faster_measure_increment
    for i in range(len(arr) - 1):
        if arr[i + 1] == arr[i]:
            arr[i + 1] += incr
        if arr[i + 1] <= arr[i]:
            arr[i + 1] = arr[i] + incr
    return arr


def check_division(v, n_jobs):
    """Split ``v`` work items into ``n_jobs`` near-equal integer chunks
    (reference ``check_division``, ``Utility.py:425``)."""
    base = int(v) // n_jobs
    out = [base] * n_jobs
    for i in range(int(v) - base * n_jobs):
        out[i] += 1
    return out


def amplitude_est_dist(w0, w1):
    """Circular (mod-1) distance between two phase-grid points (reference
    ``amplitude_est_dist``, ``Utility.py:435``)."""
    d = torch.as_tensor(w1) - torch.as_tensor(w0)
    return torch.minimum(torch.abs(-torch.ceil(d) + d),
                         torch.abs(-torch.floor(d) + d))


def auxiliary_fun(q_state, i, generator=None):
    """Measure ``q_state`` ``i`` times (reference ``auxiliary_fun``,
    ``Utility.py:404``); when no generator is given, a fresh entropy-seeded
    one on the device of the state's probabilities, so the draws stay
    where the state lives."""
    if generator is None:
        generator = as_generator(None, q_state.probabilities.device)
    return q_state.measure(generator, n_times=int(i))


def vectorize_aux_fun(dic, i):
    """√(count fraction) lookup with 0 default (reference
    ``vectorize_aux_fun``, ``Utility.py:409``)."""
    return float(np.sqrt(dic[i])) if i in dic else 0


__all__ = [
    "L2_tomogrphy_fakeSign",
    "QuantumState",
    "amplitude_est_dist",
    "auxiliary_fun",
    "check_division",
    "check_measure",
    "vectorize_aux_fun",
    "amplitude_estimation",
    "best_mu",
    "consistent_phase_estimation",
    "coupon_collect",
    "create_rand_vec",
    "estimate_wald",
    "gaussian_estimate",
    "introduce_error",
    "introduce_error_array",
    "ipe",
    "linear_search",
    "make_gaussian_est",
    "median_evaluation",
    "mu",
    "phase_estimation",
    "real_tomography",
    "sv_to_theta",
    "theta_to_sv",
    "tomography",
    "tomography_incremental",
    "unwrap_phase_est_arguments",
    "wrapper_phase_est_arguments",
]
