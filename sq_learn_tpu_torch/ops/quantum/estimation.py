"""Amplitude / phase / inner-product estimation (counterpart of
``sq_learn_tpu/ops/quantum/estimation.py``).

The reference's routines (``Utility.py:442-531`` amplitude estimation,
``:591-694`` phase estimation, ``:697-737`` IPE, ``:740-792`` consistent
PE, ``:534-572`` median boosting), batched over tensors: the M-point
output pmf is never materialized; grid indices come from
:func:`~sq_learn_tpu_torch.ops.quantum.sampling.fejer_grid_sample` with a
grid size per element.

Every random draw takes an explicit ``torch.Generator``; the tensors an
estimate is made from live on its device, and scalar inputs are put
there.

With an obs run active, each call outside a
:func:`~sq_learn_tpu_torch.obs.guarantees.no_audit` region records its
draws against their declared contract (:func:`_observe_estimate`), at
the sites the JAX package's eager calls record; inside such a region
(the fit loops and fused searches the JAX package runs under ``jit``)
nothing is recorded.
"""

import contextlib
import math

import numpy as np
import torch

from ...obs import guarantees as _guarantees
from .sampling import _as_tensor, _filled, fejer_grid_sample

_MEDIAN_CONST = 2 * (8 / math.pi**2 - 0.5) ** 2

# cap on the Fejér sampler's transient tensor (elements of
# (batch, Q, 2·window+1)); module-level so tests can shrink it to force
# the blocked path of :func:`ipe_matrix`
_IPE_BLOCK_ELEMS = 1 << 24


def _median(t):
    """Median over the leading (sample) axis. Q is odd wherever the
    package takes a median, so the middle order statistic is the value
    ``jnp.median`` returns."""
    return torch.sort(t, dim=0).values[(t.shape[0] - 1) // 2] \
        if t.shape[0] % 2 else torch.quantile(t, 0.5, dim=0)


def _observe_estimate(site, truth, est, tol, fail_prob, circular=False,
                      **attrs):
    """Emit ``guarantee`` records for one estimation call: the simulator
    knows the true value it perturbs, so each element of the batch is one
    audited draw of "|estimate − truth| ≤ tol w.p. ≥ 1 − fail_prob"
    (:mod:`sq_learn_tpu_torch.obs.guarantees`). ``circular`` measures
    distance on the unit phase circle (PE's ω ∈ [0, 1) wraps); ``tol`` is
    a number or a tensor of one tolerance per element. The errors are
    computed in float64 on the estimate's device. No-op when
    observability is disabled or inside a ``no_audit`` region."""
    if not _guarantees.enabled():
        return
    e = est.to(torch.float64)
    t = torch.as_tensor(truth, device=e.device).to(torch.float64)
    err = torch.abs(torch.broadcast_to(t, e.shape) - e)
    if circular:
        err = torch.minimum(err, 1.0 - err)
    if isinstance(tol, torch.Tensor):
        tol = torch.broadcast_to(tol.to(torch.float64), e.shape)
    _guarantees.observe(site, err, tol, fail_prob=fail_prob, **attrs)


def median_q(gamma):
    """Number of repetitions Q = ⌈ln(1/γ)/(2(8/π²−½)²)⌉ (odd) for median
    boosting (reference ``median_evaluation``, ``Utility.py:564-568``)."""
    q = int(math.ceil(math.log(1 / gamma) / _MEDIAN_CONST))
    return q + 1 if q % 2 == 0 else q


def median_evaluation(func, generator, gamma=0.1, Q=None, **kwargs):
    """Run ``func(generator=generator, **kwargs)`` Q times and return the
    median (reference ``median_evaluation``). The generator advances
    between the repetitions, so each draws its own noise."""
    if Q is None:
        Q = median_q(gamma)
    estimates = torch.stack([
        torch.as_tensor(func(generator=generator, **kwargs))
        for _ in range(int(Q))])
    return _median(estimates)


def amplitude_estimation_M(epsilon):
    """Grid size M = ⌈(π/2ε)(1+√(1+4ε))⌉ (reference ``Utility.py:484``)."""
    return math.ceil((math.pi / (2 * epsilon)) * (1 + math.sqrt(1 + 4 * epsilon)))


def amplitude_estimation(generator, a, epsilon=0.01, gamma=None, M=None,
                         window=64):
    """Simulate amplitude estimation (Brassard et al.; reference
    ``amplitude_estimation``, ``Utility.py:442-531``), batched over ``a``.

    θ_a = asin(√a); θ̃ is drawn from the exact M-point AE output
    distribution; returns ã = sin²θ̃. With ``gamma``, Q median-boosted
    repetitions are drawn in one call.
    """
    a = _as_tensor(a, generator)
    if M is None:
        M = amplitude_estimation_M(epsilon)
    theta_a = torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    w1 = theta_a / math.pi  # true value on the unit grid circle
    Q = 1 if gamma is None else median_q(gamma)
    j = fejer_grid_sample(generator, w1 * M, float(M), window,
                          sample_shape=(Q,))
    a_tilde = torch.sin(math.pi * j / M) ** 2
    out = _median(a_tilde) if Q > 1 else a_tilde[0]
    if _guarantees.enabled():
        # AE contract: |ã − a| ≤ ε with prob ≥ 1−γ (median-boosted), or
        # ≥ 8/π² for a single draw (Brassard et al. Thm 12); ε stays the
        # declared tolerance even under an explicit M
        _observe_estimate(
            "amplitude_estimation", torch.clamp(a, 0.0, 1.0), out,
            float(epsilon),
            float(gamma) if gamma is not None else 1.0 - 8 / math.pi**2,
            M=int(M))
    return out


def amplitude_estimation_per_eps(generator, a, epsilon, Q=1, window=64):
    """Amplitude estimation with a per-element precision: ``epsilon`` may be
    any tensor broadcastable to ``a``, and each element gets its own grid
    size M(ε)."""
    a = _as_tensor(a, generator)
    eps = _filled(epsilon, a.shape, a.dtype, a.device)
    M = torch.ceil((math.pi / (2 * eps)) * (1 + torch.sqrt(1 + 4 * eps)))
    theta_a = torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    pos = theta_a / math.pi * M
    j = fejer_grid_sample(generator, pos, M, window, sample_shape=(int(Q),))
    a_tilde = torch.sin(math.pi * j / M) ** 2
    return _median(a_tilde) if Q > 1 else a_tilde[0]


def phase_estimation_m(epsilon, gamma=0.1):
    """Qubit count m = ⌈log2(1/ε)⌉ + ⌈log2(2 + 1/2γ)⌉ (Nielsen & Chuang
    eq. 5.35; reference ``Utility.py:635``)."""
    return int(
        math.ceil(math.log2(1 / epsilon)) + math.ceil(math.log2(2 + 1 / (2 * gamma)))
    )


def phase_estimation(generator, omega, m=None, epsilon=None, gamma=0.1,
                     window=64):
    """Simulate phase estimation on ω ∈ [0, 1) (reference
    ``phase_estimation``, ``Utility.py:591-694``), batched over ``omega``:
    ω̃ = k/M, M = 2^m, drawn from the exact PE output distribution;
    ω ≈ 1 maps to (M−1)/M as in the reference (``:640``)."""
    declared_eps = epsilon
    if m is None:
        if epsilon is None:
            raise ValueError("specify either m or epsilon")
        m = phase_estimation_m(epsilon, gamma)
    M = 2**m
    omega = _as_tensor(omega, generator)
    j = fejer_grid_sample(generator, omega * M, float(M), window)
    omega_tilde = j / M
    one = torch.isclose(omega, torch.ones_like(omega))
    out = torch.where(one, torch.full_like(omega_tilde, (M - 1) / M),
                      omega_tilde)
    if declared_eps is not None:
        # PE contract (Nielsen & Chuang eq. 5.35 at the implemented m):
        # circular |ω̃ − ω| ≤ ε with prob ≥ 1−γ; a bare qubit count
        # declares no contract
        _observe_estimate("phase_estimation", omega, out,
                          float(declared_eps), float(gamma), circular=True,
                          m=int(m))
    return out


def consistent_phase_intervals(epsilon, gamma, n=None, shift=None):
    """The snap grid of consistent phase estimation and the inner PE's
    precision δ' = ε·γ/(2n): (float64 numpy boundaries, δ'). An output of
    :func:`consistent_phase_estimation` is the midpoint of two neighbouring
    boundaries (clamped at 0)."""
    if n is None:
        n = phase_estimation_m(epsilon, gamma)
    C = gamma / n
    delta_prime = (epsilon * C) / 2
    L = np.floor(2 / C)
    if shift is None:
        shift = int(L / 2) + 1
    intervals = np.arange(-1 - shift * delta_prime,
                          1 + epsilon - shift * delta_prime, epsilon)
    intervals = np.append(intervals, 1 + epsilon - shift * delta_prime)
    return intervals, delta_prime


def consistent_phase_estimation(generator, omega, epsilon, gamma, n=None,
                                shift=None, window=64):
    """Consistent phase estimation ("Inverting Well Conditioned Matrices in
    Quantum Logspace"; reference ``Utility.py:740-792``).

    Runs PE at precision δ' = ε·γ/(2n) and snaps the output into a fixed
    ε-grid of shifted intervals, so repeated noisy calls almost always
    agree. The grid is built in float64 numpy and cast to ω's dtype.
    """
    omega = _as_tensor(omega, generator)
    dtype = torch.promote_types(omega.dtype, torch.float32)
    intervals, delta_prime = consistent_phase_intervals(epsilon, gamma, n,
                                                        shift)
    intervals = torch.from_numpy(intervals).to(dtype)
    if omega.device.type == "cuda":
        # staged through pinned memory, so the copy does not make the host
        # wait for the device (a search calls this once per iteration)
        intervals = intervals.pin_memory().to(omega.device, non_blocking=True)
    pe = phase_estimation(generator, omega, epsilon=delta_prime, gamma=gamma,
                          window=window).to(dtype)
    # bisect.bisect is bisect_right
    idx = torch.clamp(torch.searchsorted(intervals, pe.contiguous(),
                                         right=True),
                      1, intervals.shape[0] - 1)
    estimate = (intervals[idx - 1] + intervals[idx]) / 2
    out = torch.clamp(estimate, min=0.0)
    # consistent-PE contract: the snapped output lands within ε of ω with
    # prob ≥ 1−γ (the inner PE ran at δ' = ε·γ/2n)
    _observe_estimate("consistent_phase_estimation", omega, out,
                      float(epsilon), float(gamma))
    return out


def sv_to_theta(sv, eps):
    """Map a scaled singular value to the PE phase argument
    θ = 2·acos(σ)/(1/ε + π) (reference ``wrapper_phase_est_arguments`` 'sv',
    ``Utility.py:575-578``, with the /(1/ε+π) scaling of its call sites)."""
    sv = torch.as_tensor(sv)
    return 2 * torch.arccos(torch.clamp(sv, -1.0, 1.0)) / (1 / eps + math.pi)


def theta_to_sv(theta, eps):
    """Exact inverse of :func:`sv_to_theta` for the same ``eps``:
    σ = cos(θ·(1/ε + π)/2)."""
    return torch.cos(torch.as_tensor(theta) * (1 / eps + math.pi) / 2)


def ipe(generator, x_sq_norm, y_sq_norm, inner, epsilon, Q=None, gamma=0.1,
        window=64):
    """Robust Inner Product Estimation (reference ``ipe``,
    ``Utility.py:697-737``).

    Encodes a = (‖x‖²+‖y‖²−2⟨x,y⟩) / (2(‖x‖²+‖y‖²)), runs amplitude
    estimation at ε_a = ε·max(1,|⟨x,y⟩|)/(‖x‖²+‖y‖²) and inverts to an
    inner-product estimate; all arguments broadcast. ``Q`` is honored when
    given (the reference accepts and ignores it); otherwise it follows
    from ``gamma``.
    """
    x2 = _as_tensor(x_sq_norm, generator)
    y2 = _as_tensor(y_sq_norm, generator)
    ip = _as_tensor(inner, generator)
    ssum = x2 + y2
    a = torch.clamp((ssum - 2 * ip) / (2 * ssum), 0.0, 1.0)
    eps_a = epsilon * torch.clamp(torch.abs(ip), min=1.0) / ssum
    if Q is None:
        Q = median_q(gamma)
    a_tilde = amplitude_estimation_per_eps(generator, a, eps_a, Q=Q,
                                           window=window)
    out = ssum * (1 - 2 * a_tilde) / 2
    if _guarantees.enabled():
        # robust-IPE contract: |⟨x,y⟩_est − ⟨x,y⟩| ≤ ε·max(1, |⟨x,y⟩|)
        # with prob ≥ 1−γ
        _observe_estimate(
            "ipe", ip, out,
            float(epsilon) * torch.clamp(torch.abs(ip), min=1.0),
            float(gamma))
    return out


def ipe_matrix(generator, inner, x_sq, c_sq, epsilon, Q=None, gamma=0.1,
               window=64):
    """IPE over a precomputed (n, k) inner-product matrix, or an (R, n, k)
    batch of them (one per restart, with ``c_sq`` (R, k) and the rows'
    ``x_sq`` (n,) shared). The sampler's (R, rows, k, Q, 2·window+1)
    transient is capped at ``_IPE_BLOCK_ELEMS`` by taking the rows in
    blocks; no block fetches anything. A call of more than one block is
    what the JAX package runs as a ``lax.map``, so only a single-block
    call records guarantee draws."""
    n, k = inner.shape[-2:]
    batch = inner.numel() // max(n * k, 1)
    q_eff = Q if Q is not None else median_q(gamma)
    per_row = batch * k * q_eff * (2 * window + 1)
    block = max(1, _IPE_BLOCK_ELEMS // max(per_row, 1))
    c_sq = c_sq[..., None, :]
    out = torch.empty_like(inner)
    with (_guarantees.no_audit() if block < n
          else contextlib.nullcontext()):
        for r0 in range(0, n, block):
            r1 = min(n, r0 + block)
            out[..., r0:r1, :] = ipe(generator, x_sq[r0:r1, None], c_sq,
                                     inner[..., r0:r1, :], epsilon=epsilon,
                                     Q=Q, gamma=gamma, window=window)
    return out


def inner_product_estimates(generator, X, C, epsilon, Q=None, gamma=0.1,
                            window=64):
    """IPE for every (row of X, row of C) pair: an (n, k) matrix of
    estimated inner products (reference ``_dmeans.py:753-769`` runs these
    as n·k scalar calls)."""
    from ..linalg import row_norms

    x2 = row_norms(X, squared=True)
    c2 = row_norms(C, squared=True)
    return ipe_matrix(generator, X @ C.T, x2, c2, epsilon, Q=Q, gamma=gamma,
                      window=window)
