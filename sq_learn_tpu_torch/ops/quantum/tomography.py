"""Vector-state tomography (counterpart of
``sq_learn_tpu/ops/quantum/tomography.py``).

Algorithm 4.1 of "A Quantum Interior Point Method for LPs and SDPs" (the
reference's ``real_tomography``, ``Utility.py:259-402``, and its
dispatcher ``tomography``, ``:107-180``):

part 1  measure the state N times in the computational basis → magnitude
        estimates √p̂ᵢ;
part 2  measure an interference state of 2d registers with amplitudes
        ½(Vᵢ±Pᵢ) N times and resolve the sign of each component by
        thresholding the '+' register counts at 0.4·Pᵢ²·N.

Counts come from :func:`~.sampling.multinomial_counts`; a matrix is one
batched call over its rows (the JAX package ``vmap``s), each row with its
own N, and every row's count vector goes through the split tree at once.

With an obs run active, :func:`tomography` records its draws against the
declared δ (:func:`_observe_guarantee`), as the JAX package's eager calls
do; :func:`real_tomography` alone, which the fit loops call, records
nothing.
"""

import math

import numpy as np
import torch

from ...obs import guarantees as _guarantees
from .noise import gaussian_estimate
from .sampling import _as_tensor, _filled, multinomial_counts


def _observe_guarantee(A, est, noise, norm, preserve_norm, variant):
    """Emit ``guarantee`` records for one tomography call
    (:mod:`sq_learn_tpu_torch.obs.guarantees`): the simulation knows its
    own ground truth, so each estimate is one audited draw of "realized
    error ≤ δ w.p. ≥ 1 − fail_prob".

    - ``true``: Algorithm 4.1's contract is on the NORMALIZED vector —
      per-row error of est/‖v‖ against v/‖v‖ in the declared norm,
      failure probability 1/d^0.83 (QIPM Theorem 4.3's tail at the
      implemented N = 36·d·ln d/δ²).
    - ``gaussian``: the fast path adds truncnorm(±δ/√d) per component of
      the FLATTENED input, so its realized ‖A−Â‖_F ≤ δ by construction —
      declared fail_prob 0.

    The errors are computed in float64 on the device; only the sampled
    draws reach the host. No-op when observability is disabled.
    """
    if not _guarantees.enabled():
        return
    A = A.to(torch.float64)
    E = est.to(torch.float64)
    if variant == "gaussian":
        _guarantees.observe(
            "tomography.gaussian", torch.linalg.norm(A - E).reshape(1),
            float(noise), fail_prob=0.0, norm="L2", d=int(A.numel()))
        return
    if A.ndim == 1:
        A, E = A[None], E[None]
    scale = torch.linalg.norm(A, dim=1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    unit = A / safe[:, None]
    Eu = (E / safe[:, None]) if preserve_norm else E
    ord_ = 2 if norm == "L2" else math.inf
    realized = torch.linalg.vector_norm(unit - Eu, ord=ord_, dim=1)
    d = A.shape[1]
    _guarantees.observe(
        "tomography.true", realized, float(noise),
        fail_prob=min(1.0, d ** -0.83), norm=norm, d=int(d))


def tomography_n_measurements(d, delta, norm="L2"):
    """Sample complexity N (reference ``Utility.py:307-311``):
    L2: 36·d·ln d/δ²; inf: 36·ln d/δ²."""
    if norm == "L2":
        return int((36 * d * math.log(d)) / (delta**2))
    if norm == "inf":
        return int((36 * math.log(d)) / (delta**2))
    raise ValueError(f"norm must be 'L2' or 'inf', got {norm!r}")


def _tomography_unit(generator, V, N):
    """One pass of Algorithm 4.1 on the unit rows of ``V`` (r, d) with N
    measurements per row (a number or an (r,) tensor). Counts and the
    magnitudes are float64; the estimate comes back in V's dtype."""
    d = V.shape[-1]
    Vd = V.to(torch.float64)
    N = _filled(N, np.shape(N), torch.float64, V.device)
    Nc = N[..., None] if N.ndim else N
    # part 1: magnitudes from measurement counts
    counts = multinomial_counts(generator, N, Vd * Vd)
    P = torch.sqrt(counts / Nc)
    # part 2: sign resolution on the 2d-register interference state
    amps = 0.5 * torch.cat([Vd + P, Vd - P], dim=-1)
    counts2 = multinomial_counts(generator, N, amps * amps)
    plus_counts = counts2[..., :d]
    sign = torch.where(plus_counts > 0.4 * P * P * Nc, 1.0, -1.0)
    return (sign * P).to(V.dtype)


def real_tomography(generator, v, delta=None, N=None, norm="L2",
                    preserve_norm=True):
    """Tomography estimate of one vector (d,) or of each row of a matrix
    (r, d).

    Each row is normalized as the reference does (``Utility.py:301-304``),
    estimated with N measurements (``tomography_n_measurements(d, delta,
    norm)`` when N is None; N may be an (r,) tensor, one per row) and, with
    ``preserve_norm`` (the default), rescaled by its norm; pass False for
    the reference's estimate of the normalized vector.
    """
    v = _as_tensor(v, generator)
    d = v.shape[-1]
    if N is None:
        N = tomography_n_measurements(d, delta, norm)
    scale = torch.linalg.norm(v, dim=-1, keepdim=True)
    unit = v / torch.where(scale > 0, scale, torch.ones_like(scale))
    est = _tomography_unit(generator, unit, N)
    return est * scale if preserve_norm else est


def tomography(generator, A, noise, true_tomography=True, norm="L2", N=None,
               preserve_norm=True):
    """Tomography dispatcher (reference ``tomography``,
    ``Utility.py:107-180``).

    noise == 0 returns A unchanged. ``true_tomography=False`` takes the
    truncated-Gaussian fast path over the flattened input (so
    ‖Â − A‖_F ≤ noise); otherwise Algorithm 4.1 runs on every row of a
    matrix at once. Under an obs run each call records its realized
    errors against ``noise``; noise 0 records the short-circuit.
    """
    A = _as_tensor(A, generator)
    variant = "true" if true_tomography else "gaussian"
    if float(noise) == 0.0:
        if _guarantees.enabled():
            _guarantees.record_guarantee(
                f"tomography.{variant}", 0.0, 0.0, fail_prob=0.0,
                short_circuit=True)
        return A
    if not true_tomography:
        out = gaussian_estimate(generator, A.reshape(-1),
                                noise).reshape(A.shape)
    else:
        out = real_tomography(generator, A, delta=noise, N=N, norm=norm,
                              preserve_norm=preserve_norm)
    _observe_guarantee(A, out, noise, norm, preserve_norm, variant)
    return out


def magnitude_tomography_signed(generator, v, delta=None, N=None,
                                preserve_norm=False):
    """Magnitude-only tomography with the TRUE signs copied onto the
    estimated magnitudes (reference ``L2_tomogrphy_fakeSign``,
    ``Utility.py:234-256``): part 1 of Algorithm 4.1 without the sign
    resolution. The estimate is of the normalized vector unless
    ``preserve_norm``."""
    v = _as_tensor(v, generator)
    d = v.shape[-1]
    if N is None:
        if delta is None:
            raise ValueError("provide either N or delta")
        if float(delta) == 0.0:
            return v if preserve_norm else v / torch.linalg.norm(v)
        N = tomography_n_measurements(d, delta, "L2")
    counts = multinomial_counts(generator, int(N), v.to(torch.float64) ** 2)
    est = (torch.sign(v) * torch.sqrt(counts / int(N))).to(v.dtype)
    return est * torch.linalg.norm(v) if preserve_norm else est


def tomography_incremental(generator, v, delta, norm="L2", num_points=100,
                           faster_measure_increment=0,
                           stop_when_reached_accuracy=True):
    """Incremental-measurement tomography (reference
    ``Utility.py:315-363``): Algorithm 4.1 on a geomspace schedule of
    measurement counts, optionally stopping once ‖V−P‖ ≤ δ. A host loop,
    one fetch per step.

    Returns dict {n_measurements: estimate (np.ndarray)}.
    """
    v = _as_tensor(v, generator)
    d = v.shape[0]
    scale = float(torch.linalg.norm(v))
    unit = v / (scale if scale > 0 else 1.0)
    N = tomography_n_measurements(d, delta, norm)
    schedule = np.geomspace(1, N, num=num_points, dtype=np.int64)
    # de-duplicate the schedule like reference check_measure (Utility.py:414)
    incr = 5 + faster_measure_increment
    for i in range(len(schedule) - 1):
        if schedule[i + 1] <= schedule[i]:
            schedule[i + 1] = schedule[i] + incr
    ord_ = 2 if norm == "L2" else np.inf
    unit_np = unit.cpu().numpy()
    results = {}
    for n in schedule:
        est = _tomography_unit(generator, unit[None], int(n))[0]
        results[int(n)] = est.cpu().numpy()
        if stop_when_reached_accuracy:
            if np.linalg.norm(unit_np - results[int(n)], ord=ord_) <= delta:
                break
    return results
