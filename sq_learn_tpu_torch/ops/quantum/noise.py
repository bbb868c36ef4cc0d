"""Truncated-Gaussian noise injectors (counterpart of
``sq_learn_tpu/ops/quantum/noise.py``).

The reference's fast-path error models (``Utility.py:68-73,88-104``):
instead of running full tomography, an estimate is approximated by adding
truncnorm(−b, b) noise per component. Truncated normals are drawn by
inverse CDF: a uniform mapped into [Φ(−b), Φ(b)] goes through
``torch.special.ndtri``, in float64, and the result is clamped to
[−b, b], so the bound holds by construction.
"""

import math

import numpy as np
import torch

from .sampling import _as_tensor, _filled


def truncated_noise(generator, bound, shape, dtype=torch.float32):
    """Standard-normal noise truncated to [−bound, bound] (scipy
    ``truncnorm.rvs(-b, b)`` equivalent), on the generator's device.
    ``bound`` may be a tensor broadcastable to ``shape``; bound == 0 yields
    exactly 0."""
    device = generator.device
    b = _filled(bound, tuple(shape), torch.float64, device)
    lo = torch.special.ndtr(-b)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float64,
                   device=device)
    z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo))
    z = torch.minimum(torch.maximum(z, -b), b)
    return torch.where(b > 0, z, torch.zeros_like(z)).to(dtype)


def introduce_error(generator, value, epsilon):
    """value + truncnorm(−ε, ε) noise (reference ``introduce_error``, :68);
    ``value`` and ``epsilon`` broadcast together."""
    value = _as_tensor(value, generator)
    return value + truncated_noise(generator, epsilon, value.shape,
                                   value.dtype)


def introduce_error_array(generator, array, norm_error):
    """Add truncnorm noise bounded by ``norm_error/√d`` per component
    (reference ``introduce_error_array``, :71), so the L2 perturbation is
    ≤ ``norm_error``."""
    array = _as_tensor(array, generator)
    scale = 1.0 / math.sqrt(array.shape[-1])
    if isinstance(norm_error, torch.Tensor) or np.ndim(norm_error):
        bound = _filled(norm_error, np.shape(norm_error), torch.float64,
                        array.device)[..., None] * scale
    else:
        bound = float(norm_error) * scale
    return array + truncated_noise(generator, bound, array.shape, array.dtype)


def gaussian_estimate(generator, vec, noise):
    """Gaussian-noise approximation of tomography (reference
    ``make_gaussian_est``, :88): adds truncnorm(±noise/√d) per component.
    noise == 0 returns the input unchanged (the reference returns an
    undefined variable there, ``Utility.py:97-104``)."""
    vec = _as_tensor(vec, generator)
    d = vec.shape[-1]
    per_component = float(noise) / math.sqrt(d)
    return vec + truncated_noise(generator, per_component, vec.shape,
                                 vec.dtype)
