"""qPCA — quantum principal component analysis (counterpart of
``sq_learn_tpu/models/qpca.py``).

The reference's ``qPCA`` estimator (``sklearn/decomposition/_qPCA.py:113-1315``)
and its ``_BasePCA`` transform path (``_base.py:97-164``), on tensors. The
classical core is a centered SVD: tall matrices take the m×m Gram
``torch.linalg.eigh``, materializing only the U columns the fit keeps. Every
quantum estimator is a batched call over all singular values at once, and
the binary searches (spectral norm, σ_min, θ) are host loops over device
tensors: the bracket searches fetch nothing until they end, the θ search
one flag per iteration.

Random stream: one ``torch.Generator`` per fit, on the fit's device,
seeded from ``random_state``; each consumer (the JAX package splits a key
for each, ``_next_key``) draws from it in the same order. The μ(A) sketch
takes its own numpy ``default_rng`` seeded from the generator's seed and
``0x5CE7``, so its row sample is apart from the estimators' draws.

Fitted attributes are numpy arrays, as in the JAX package. ``transform``,
``fit_transform``, ``inverse_transform``, ``score_samples``,
``get_covariance`` and ``get_precision`` return tensors on the
estimator's device. ``cross_validate`` takes such a tensor as it takes
any input: it fetches X to the host once and indexes the folds there
(keeping the folds on the card is ROADMAP.md §1 item 2's follow-up).

Reference latent bugs NOT replicated (as in the JAX package):
- ``fit_transform`` forwards stale kwargs → TypeError (``_qPCA.py:467-473``);
  here it is the standard fit-then-transform.
- ``transform(classic_transform=False, quantum_representation=False)``
  returns ``None`` (``_qPCA.py:828-843``); here it returns the
  transformed matrix.
- ``left_sv`` slices *rows* of U (``_qPCA.py:634``); here left singular
  vectors are columns of U, stored row-wise with shape
  (n_components, n_samples).
- ``condition_number_estimation`` (``_qPCA.py:909-961``) converges to
  ≈σ_max; here the search brackets σ_min and κ = σ̂_max/σ̂_min.
- the whiten+quantum transform reads an attribute that is never set
  (``_base.py:125``); here it uses the top-k factor-score estimates.

Under an obs run (:mod:`sq_learn_tpu_torch.obs`) a fit records the
``qpca.fit`` span, a ledger step per quantum estimator (the query counts
its ε/δ buy, against the step's wall clock) and the ``qpca.sv_estimate``
guarantee draws of the top-k/least-k extraction; the quantum routines
record their own draws where the JAX package's eager calls do, and the
binary searches, which it runs under ``jit``, record none.

Ingest, as in the JAX package: the partial-U Gram route (integral
``n_components`` on tall host input, no μ(A)) streams X in tiles under
``ingest='streamed'``, or under 'auto' when X is larger than the tile cap
(:mod:`~sq_learn_tpu_torch.streaming`): X is never resident on the card,
and ``ingest_`` records the route. ``compute_dtype`` engages only that
route with the full solver (``effective_compute_dtype_``).

A shard store (:class:`~sq_learn_tpu_torch.oocore.ShardStore`, or any
row source) fits as in the JAX package: it has no resident form, so it
must take the streamed partial-U Gram route: ``svd_solver='auto'``
becomes 'full', ``ingest='monolithic'`` raises, and a fit off that route
(a QADRA estimator, whose μ(A) needs the resident centered matrix, or
``n_samples < 8·n_features``) raises ``ValueError``.

``mesh`` (a :class:`~sq_learn_tpu_torch.parallel.mesh.Mesh`) runs the
fit data-parallel, as in the JAX package: it forces ``svd_solver='full'``
(any other explicit solver raises); host data takes
:func:`~sq_learn_tpu_torch.parallel.pca.centered_svd_sharded`, the
streamed ingest :func:`~sq_learn_tpu_torch.parallel.streaming.
streamed_centered_svd_topk_sharded`, μ(A) the exact sweep over the
sharded centered rows, and the quantum transform
:func:`~sq_learn_tpu_torch.parallel.pca.tomography_sharded`; a store with
a mesh raises ``ValueError``. ``compute_dtype`` does not engage under a
mesh. The tiny-fit host routing is not ported (a fit computes on the
device it was given).
"""

import math
import numbers
import warnings

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, TransformerMixin, check_is_fitted,
                    check_n_features)
from ..ops.linalg import (centered_svd, centered_svd_topk,
                          check_compute_dtype, randomized_svd, stable_cumsum)
from ..ops.quantum import (QuantumState, amplitude_estimation,
                           consistent_phase_estimation, estimate_wald,
                           tomography)
from ..ops.quantum.norms import _search_grid
from ..parallel.mesh import ShardedRows, check_mesh
from ..sketch import engine as _sketch
from ..streaming import is_row_source, streamed_centered_svd_topk
from ..utils.plotting import plot_runtime_surfaces
from ..utils.random import as_generator
from ..utils.validation import (check_array, host_ingest,
                                validation_scope)

# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


def singular_value_estimates(generator, singular_values, scale_norm,
                             eps_scaled, n_features, window=64):
    """Consistent-PE estimates of a whole spectrum in one batched call.

    Encodes each σ/scale as θ = 2·acos(σ/scale)/(ε+π) (reference
    ``wrapper_phase_est_arguments`` 'sv', ``Utility.py:575-578``), runs
    consistent phase estimation at precision ``eps_scaled`` with failure
    probability γ = 1 − 1/n_features (the reference's choice at every call
    site), and decodes σ̂ = cos(θ̂·(ε+π)/2)·scale. ε = 0 returns the
    spectrum unchanged.
    """
    if eps_scaled == 0:
        return singular_values
    sv = torch.clamp(singular_values / scale_norm, 0.0, 1.0)
    enc = eps_scaled + math.pi
    theta = 2.0 * torch.arccos(sv) / enc
    gamma = 1.0 - 1.0 / n_features
    theta_est = consistent_phase_estimation(
        generator, theta, float(eps_scaled), float(gamma), window=window)
    return torch.cos(theta_est * enc / 2.0) * scale_norm


def _sv_ratio(true_sel, sv_est):
    """σ_true/σ̂ of a selected spectrum slice — the diagnostic the
    reference plots under ``check_sv_uniform_distribution``
    (``_qPCA.py:1041-1044``, ``:1089-1093``); stored instead."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(true_sel / np.where(sv_est != 0, sv_est, np.nan))


def estimated_mass(generator, S, scale, tau, denom, *, eps_scaled,
                   ae_epsilon, n_features, below=False):
    """Theorem-9 core shared by every spectral search: consistent-PE
    estimates of the spectrum, factor-score mass on one side of τ·scale
    (selection by the *estimated* values, mass from the true ones),
    amplitude-estimated at ``ae_epsilon`` (0 = exact). A 0-d tensor on
    S's device; nothing is fetched."""
    est = singular_value_estimates(generator, S, scale, eps_scaled,
                                   n_features)
    sel = (est <= tau * scale) if below else (est >= tau * scale)
    a = torch.clamp(torch.sum(torch.where(sel, S**2, torch.zeros_like(S)))
                    / denom, 0.0, 1.0)
    if ae_epsilon == 0:
        return a
    return amplitude_estimation(generator, a, epsilon=ae_epsilon)


def bracket_search_fused(generator, S, frob, *, eps_scaled, ae_epsilon,
                         n_iterations, n_features, find_min):
    """Binary search bracketing σ_max (``find_min=False``; reference
    ``spectral_norm_estimation``, ``_qPCA.py:882-907``) or σ_min
    (``find_min=True``; the corrected ``condition_number_estimation``
    bracket). Each iteration re-estimates the whole spectrum by consistent
    PE, masses the factor scores on the τ side of the bracket and
    amplitude-estimates that mass; zero estimated mass moves the bracket
    toward the surviving side. The bracket stays on the device: the loop
    fetches nothing, and the result is a 0-d tensor. The JAX package runs
    the search under ``jit``, so its estimates record no guarantee
    draws."""
    lo = torch.zeros((), dtype=S.dtype, device=S.device)
    hi = torch.ones((), dtype=S.dtype, device=S.device)
    with _obs.guarantees.no_audit():
        for _ in range(n_iterations):
            tau = (lo + hi) / 2
            eta_est = estimated_mass(
                generator, S, frob, tau, frob**2, eps_scaled=eps_scaled,
                ae_epsilon=ae_epsilon, n_features=n_features,
                below=find_min)
            zero = eta_est == 0.0
            if find_min:  # nothing below τ — σ_min is larger
                lo, hi = (torch.where(zero, tau, lo),
                          torch.where(zero, hi, tau))
            else:  # nothing above τ — σ_max is smaller
                lo, hi = (torch.where(zero, lo, tau),
                          torch.where(zero, tau, hi))
    return (lo + hi) / 2 * frob


def theta_search_fused(generator, S, muA, p, *, eps_scaled, eta,
                       n_iterations, n_features):
    """Theorem-10 θ binary search (reference ``estimate_theta``,
    ``_qPCA.py:1002-1022``): each step runs the factor-score-ratio-sum
    estimate (consistent-PE spectrum + AE of the mass ≥ τ·μ(A)) and stops
    once |p̂ − p| ≤ η/2 — one host fetch per iteration. Returns
    ``(theta, found)``. As the bracket searches, it records no guarantee
    draws (the JAX package's search is one ``jit``'d loop)."""
    total = torch.sum(S**2)
    lo, hi, tau = 0.0, 1.0, 0.5
    with _obs.guarantees.no_audit():
        for _ in range(n_iterations):
            p_est = float(estimated_mass(
                generator, S, muA, tau, total, eps_scaled=eps_scaled,
                ae_epsilon=eta / 2, n_features=n_features))
            if abs(p_est - p) <= eta / 2:
                return tau * muA, True
            if p_est < p:  # τ too high: too little mass retained
                hi = tau
            else:
                lo = tau
            tau = (lo + hi) / 2
    return tau * muA, False


def _assess_dimension(spectrum, rank, n_samples):
    """Log-evidence of PCA rank ``q`` under Minka's Laplace approximation
    ("Automatic Choice of Dimensionality for PCA", NIPS 2000, eq. 77) —
    the JAX package's vectorized re-derivation of the reference's
    ``_qPCA.py:30-98``."""
    from scipy.special import gammaln

    lam = np.asarray(spectrum, dtype=np.float64)
    p = lam.shape[0]
    q = int(rank)
    if not 1 <= q < p:
        raise ValueError("the tested rank should be in [1, n_features - 1]")
    eps = 1e-15
    if lam[q - 1] < eps:
        # a retained eigenvalue is numerically zero: never the argmax
        return -np.inf
    N = float(n_samples)

    sizes = p - np.arange(1, q + 1) + 1                  # p−i+1 for i=1..q
    log_p_u = -q * math.log(2.0) + np.sum(
        gammaln(sizes / 2.0) - (sizes / 2.0) * math.log(math.pi))

    log_lik_kept = -0.5 * N * np.sum(np.log(lam[:q]))
    v_bar = max(eps, lam[q:].sum() / (p - q))
    log_lik_tail = -0.5 * N * (p - q) * math.log(v_bar)

    n_free = p * q - q * (q + 1) / 2.0
    log_param_vol = 0.5 * (n_free + q) * math.log(2.0 * math.pi)

    # Hessian log-determinant over pairs i<j, discarded tail collapsed to v̄
    lam_t = np.where(np.arange(p) < q, lam, v_bar)       # λ̃ (p,)
    gaps = lam[:q, None] - lam[None, :]                  # λᵢ − λⱼ (raw)
    curv = 1.0 / lam_t[None, :] - 1.0 / lam_t[:q, None]  # λ̃ⱼ⁻¹ − λ̃ᵢ⁻¹
    pair = np.arange(p)[None, :] > np.arange(q)[:, None]
    prods = gaps * curv * N
    if np.any(prods[pair] <= 0):
        raise ValueError(
            "Minka's MLE log-evidence is undefined for spectra with exactly "
            "tied eigenvalues; perturb the data or pass an explicit "
            "n_components instead of 'mle'")
    log_hess = np.sum(np.where(pair, np.log(prods, where=pair,
                                            out=np.zeros_like(prods)), 0.0))

    return (log_p_u + log_lik_kept + log_lik_tail + log_param_vol
            - 0.5 * log_hess - 0.5 * q * math.log(N))


def _infer_dimension(spectrum, n_samples):
    """MLE rank = argmax of Minka's log-evidence over candidate ranks
    (reference ``_infer_dimension``, ``_qPCA.py:101-110``)."""
    ll = np.full(spectrum.shape[0], -np.inf)
    for rank in range(1, spectrum.shape[0]):
        ll[rank] = _assess_dimension(spectrum, rank, n_samples)
    return int(ll.argmax())


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class QPCA(TransformerMixin, BaseEstimator):
    """Quantum principal component analysis (reference ``qPCA``,
    ``_qPCA.py:113``).

    Classically fits PCA by centered SVD, then — gated by per-call fit
    kwargs, like the reference — layers the QADRA quantum estimators on
    top: spectral-norm / σ_min binary searches over consistent PE + AE,
    the factor-score-ratio sum (Thm 9), θ estimation for a target retained
    variance p (Thm 10) and top-k / least-k singular-vector extraction
    with tomography (Thm 11).

    Parameters are the JAX ``QPCA``'s, plus ``device`` (None = the
    configured one, ``'cuda'`` by default). ``svd_solver`` 'auto' picks
    'full' for small inputs and 'randomized' for small ``n_components``
    on large ones; the quantum estimators require 'full'. ``sketch`` sets
    the μ(A) row sample (:mod:`~sq_learn_tpu_torch.sketch`): 'auto' samples
    ``max(4096, 2·m)`` rows when the centered matrix is ≥4× larger and
    tall, and ``muA`` is the certified upper bound. ``ingest`` is 'auto',
    'monolithic' or 'streamed' (the module docstring says which fits
    stream); ``mesh`` runs the fit data-parallel (the module docstring
    says how).
    """

    #: public fitted attributes that keep the reference QPCA's exact
    #: names, as the JAX package's QPCA declares them (the parity tests
    #: and checkpoints read these spellings). Declared for sqcheck's
    #: estimator-contract rule — new fitted state takes the ``name_``
    #: form instead.
    _NONSTANDARD_FITTED_ATTRS = (
        "all_components", "check_sv_uniform_distribution",
        "condition_number_est", "delta", "eps", "eps_theta",
        "est_spectral_norm", "est_theta", "estimate_all",
        "estimate_least_k", "eta", "explained_variance_all",
        "explained_variance_ratio_all", "faster_measure_increment",
        "frob_norm", "fs_ratio_estimation", "incremental_measure",
        "least_k", "least_k_p", "least_k_true_singular_value",
        "leastk_left_singular_vectors", "leastk_right_singular_vectors",
        "left_sv", "muA", "n_components_flag", "norm_muA", "p",
        "quantum_retained_variance", "quantum_runtime_container",
        "ret_var", "spectral_norm", "spectral_norm_est",
        "stop_when_reached_accuracy", "theta", "theta_estimate",
        "theta_major", "theta_minor", "tomography_norm",
        "top_k_true_singular_value", "topk", "topk_left_singular_vectors",
        "topk_p", "topk_right_singular_vectors", "true_tomography",
        "use_computed_qcomponents",
    )

    def __init__(self, n_components=None, *, copy=True, whiten=False,
                 svd_solver="auto", tol=0.0, iterated_power="auto",
                 random_state=None, name=None, compute_mu="auto", mesh=None,
                 compute_dtype=None, ingest="auto", sketch="auto",
                 device=None):
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.random_state = random_state
        self.name = name
        self.compute_mu = compute_mu
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.ingest = ingest
        self.sketch = sketch
        self.device = device

    # -- fit ----------------------------------------------------------------

    def fit(self, X, y=None, *, quantum_retained_variance=False, eps=0,
            theta_major=0, theta_minor=0, eta=0, theta_estimate=False,
            use_computed_qcomponents=False, eps_theta=0, p=0,
            estimate_all=False, delta=0, true_tomography=True,
            fs_ratio_estimation=False, norm="L2",
            stop_when_reached_accuracy=False, incremental_measure=False,
            faster_measure_increment=0, check_sv_uniform_distribution=False,
            spectral_norm_est=False, condition_number_est=False,
            estimate_least_k=False):
        """Fit the model with X (reference ``qPCA.fit``, ``_qPCA.py:357-481``).

        The quantum kwargs mirror the reference: ``eps`` is the
        singular-value estimation error, ``delta`` the tomography error,
        ``theta_major``/``theta_minor`` the singular-value thresholds for
        top-k/least-k selection, ``p``+``eps_theta``+``eta`` drive the θ
        search, and the ``*_est``/``estimate_*`` booleans gate each
        estimator. ``incremental_measure``, ``stop_when_reached_accuracy``,
        ``faster_measure_increment``, ``use_computed_qcomponents`` and
        ``fs_ratio_estimation`` are stored as the JAX package stores them;
        ``check_sv_uniform_distribution`` stores the σ/σ̂ ratio arrays.
        """
        if quantum_retained_variance:
            if eps <= 0:
                raise ValueError("eps must be > 0")
            if theta_major <= 0 and not theta_estimate:
                raise ValueError("theta must be > 0")
        if theta_estimate:
            if p <= 0 and not isinstance(self.n_components, numbers.Integral):
                raise ValueError("p must be > 0")
        if estimate_all and theta_major <= 0 and not theta_estimate:
            raise ValueError(
                "estimate_all requires theta_major > 0 or "
                "theta_estimate=True (the reference crashes with an "
                "AttributeError here)")
        if estimate_least_k and theta_minor <= 0:
            raise ValueError(
                "estimate_least_k requires theta_minor > 0 (the "
                "reference falls back to a never-assigned attribute, "
                "_qPCA.py:1073-1074)")
        self._check_ported(X)

        # stash quantum params like the reference does (_qPCA.py:493-514)
        self.delta = delta
        self.eps = eps
        self.eps_theta = eps_theta
        self.eta = eta
        self.theta_major = theta_major
        self.theta_minor = theta_minor
        self.ret_var = p
        self.tomography_norm = norm
        self.true_tomography = true_tomography
        self.theta_estimate = theta_estimate
        self.estimate_all = estimate_all
        self.estimate_least_k = estimate_least_k
        self.quantum_retained_variance = quantum_retained_variance
        self.spectral_norm_est = spectral_norm_est
        self.condition_number_est = condition_number_est
        self.stop_when_reached_accuracy = stop_when_reached_accuracy
        self.incremental_measure = incremental_measure
        self.faster_measure_increment = faster_measure_increment
        self.use_computed_qcomponents = use_computed_qcomponents
        self.fs_ratio_estimation = fs_ratio_estimation
        self.check_sv_uniform_distribution = check_sv_uniform_distribution
        # a refit must not leave a previous fit's diagnostics behind
        for attr in ("sv_uniform_distribution_",
                     "least_k_sv_uniform_distribution_"):
            if hasattr(self, attr):
                delattr(self, attr)

        device = self._device()
        # host input is checked on the host first: a streamed fit never
        # uploads X whole, so its values are checked tile by tile (a
        # store's too: its manifest and per-read CRCs check its bytes)
        if is_row_source(X):
            Xh, over_cap = X, True
        else:
            Xh, over_cap = host_ingest(X)
        shape = tuple((X if Xh is None else Xh).shape)
        n_components, solver = self._plan(shape, is_row_source(X))
        streamed = self._resolve_ingest(Xh, over_cap, solver, n_components,
                                        shape)
        self.ingest_ = "streamed" if streamed else "monolithic"
        X = Xh if streamed else self._validated_X(X, device)
        self.n_features_in_ = X.shape[1]
        with _obs.span("qpca.fit", n_samples=X.shape[0],
                       n_features=X.shape[1]) as sp:
            self._fit_impl(X, device, n_components, solver)
            sp.set(backend=device.type, solver=self._fit_svd_solver,
                   ingest=self.ingest_)
        return self

    def _check_ported(self, X):
        """Check ``mesh``, ``ingest`` and ``compute_dtype``; a store with
        a mesh raises, as in the JAX package."""
        check_mesh(self.mesh)
        if self.mesh is not None and is_row_source(X):
            raise ValueError(
                "store-backed qPCA fits are single-device (the sharded "
                "streamed route takes host arrays)")
        if self.ingest not in ("auto", "monolithic", "streamed"):
            raise ValueError(
                f"ingest must be 'auto', 'monolithic' or 'streamed', got "
                f"{self.ingest!r}")
        check_compute_dtype(self.compute_dtype)

    def _plan(self, shape, store=False):
        """(n_components, solver) of a fit on data of ``shape``: the
        reference's n_components handling (``_qPCA.py:527-536``) and
        solver dispatch (``_qPCA.py:538-553``); a shard store (``store``)
        resolves 'auto' to the full solver's Gram route."""
        if self.n_components is None:
            self.n_components_flag = False
            n_components = min(shape)
        else:
            self.n_components_flag = True
            n_components = self.n_components

        quantum_requested = (
            self.quantum_retained_variance or self.theta_estimate
            or self.estimate_all or self.estimate_least_k
            or self.spectral_norm_est or self.condition_number_est)
        solver = self.svd_solver
        if solver == "auto" and store:
            # the truncated path would materialize X for its range finder
            solver = "full"
        elif solver == "auto":
            if quantum_requested:
                # the QADRA estimators need the full spectrum
                solver = "full"
            elif max(shape) <= 500 or n_components == "mle":
                solver = "full"
            elif isinstance(n_components, numbers.Integral) and \
                    1 <= n_components < 0.8 * min(shape):
                solver = "randomized"
            else:
                solver = "full"
        elif solver != "full" and quantum_requested:
            raise ValueError(
                f"quantum estimators require svd_solver='full' (or 'auto'); "
                f"got svd_solver={solver!r} with quantum fit kwargs set")
        if self.mesh is not None:
            # the truncated path is single-device: dropping the mesh would
            # hand the large inputs a mesh targets to one device
            if self.svd_solver not in ("auto", "full"):
                raise ValueError(
                    f"mesh requires svd_solver='full' (or 'auto'); got "
                    f"svd_solver={self.svd_solver!r}")
            solver = "full"
        self._fit_svd_solver = solver
        return n_components, solver

    def _resolve_ingest(self, Xh, over_cap, solver, n_components, shape):
        """Resolve ``ingest`` to streamed (True) or monolithic for this fit
        (the JAX package's ``_resolve_ingest``). The streamed engine
        serves the full solver's partial-U Gram route on host input
        (``Xh``, None for a tensor already on the card; ``over_cap`` from
        :func:`host_ingest`); μ(A) needs the resident centered matrix, so
        a QADRA fit never streams. 'streamed' on another route warns and
        ingests monolithically, on the same device; 'auto' streams when a
        monolithic upload would pass the tile cap. A row source has no
        resident form: off that route, or under 'monolithic', it raises."""
        if is_row_source(Xh):
            if self.ingest == "monolithic":
                raise ValueError(
                    "ingest='monolithic' cannot materialize a shard "
                    "store; store-backed fits stream")
            if not (solver == "full" and not self._need_mu()
                    and isinstance(n_components, numbers.Integral)
                    and n_components > 0
                    and self._partial_u_route(n_components, *shape)):
                raise ValueError(
                    "store-backed qPCA fits require the streamed "
                    "partial-U Gram route: svd_solver='full' (or 'auto'),"
                    " integral n_components > 0, n_samples >= "
                    "8*n_features, and no QADRA estimator (mu(A) needs "
                    "the resident centered matrix)")
            return True
        if self.ingest == "monolithic":
            return False
        structural = (
            solver == "full"
            and not self._need_mu()
            and isinstance(n_components, numbers.Integral)
            and n_components > 0
            and Xh is not None
            and (self._partial_u_route(n_components, *shape)
                 if self.mesh is None else shape[0] >= shape[1]))
        if self.ingest == "streamed":
            if not structural:
                warnings.warn(
                    "ingest='streamed' requires the full-solver Gram route "
                    "(integral n_components, tall host input, no QADRA "
                    "estimator — mu(A) needs the resident matrix); this "
                    "fit ingests monolithically.", RuntimeWarning)
            return structural
        return structural and over_cap

    def _fit_impl(self, X, device, n_components, solver):
        """The SVD and the quantum estimators, on the planned solver; every
        quantum fit kwarg was stashed on ``self`` by :meth:`fit`. ``X`` is
        a tensor on ``device``, or host data on the streamed route."""
        self._generator = as_generator(self.random_state, device)
        engaged = (self.compute_dtype is not None and solver == "full"
                   and self._partial_u_route(n_components, *X.shape))
        self.effective_compute_dtype_ = (
            check_compute_dtype(self.compute_dtype) if engaged else None)
        if self.compute_dtype is not None and not engaged:
            warnings.warn(
                "compute_dtype engages only the partial-U Gram route "
                "(svd_solver='full', integral n_components, aspect ratio "
                ">= 8, no mesh); this fit runs in the input dtype.",
                RuntimeWarning)

        if solver == "full":
            self._fit_full(X, n_components)
        elif solver in ("arpack", "randomized"):
            warnings.warn(
                "Attention! This computational path is purely classic!")
            self._fit_truncated(X, n_components)
        else:
            raise ValueError(f"Unrecognized svd_solver={solver!r}")
        return self

    def fit_transform(self, X, y=None, *, classic_transform=True,
                      epsilon_delta=0, quantum_representation=False,
                      norm="None", psi=0, use_classical_components=True,
                      **fit_kwargs):
        """Fit with the quantum kwargs, then transform, under one
        validate-once scope (the reference's version forwards stale kwargs
        and crashes, ``_qPCA.py:467-473``)."""
        with validation_scope(self):
            self.fit(X, **fit_kwargs)
            return self.transform(
                X, classic_transform=classic_transform,
                epsilon_delta=epsilon_delta,
                quantum_representation=quantum_representation, norm=norm,
                psi=psi,
                true_tomography=fit_kwargs.get("true_tomography", True),
                use_classical_components=use_classical_components)

    def _device(self):
        """The fit's device: the mesh's first under a mesh."""
        if self.mesh is not None:
            return resolve_device(check_mesh(self.mesh).lead)
        return resolve_device(self.device)

    def _next_key(self):
        """The fit's generator, for the next consumer of random draws (the
        JAX package splits a fresh key here; the torch generator advances
        with each draw instead). A fitted state carried over from the JAX
        package gets its generator here, from ``random_state``."""
        device = self._device()
        gen = getattr(self, "_generator", None)
        if gen is None or gen.device.type != device.type:
            gen = self._generator = as_generator(self.random_state, device)
        return gen

    def _partial_u_route(self, n_components, n_samples, n_features):
        """True when the fit takes the partial-U Gram route (never under
        a mesh)."""
        return (self.mesh is None
                and isinstance(n_components, numbers.Integral)
                and 0 < n_components and n_samples >= 8 * n_features)

    def _need_mu(self):
        """Whether this fit computes μ(A)."""
        if self.compute_mu == "auto":
            return (self.quantum_retained_variance or self.theta_estimate
                    or self.estimate_all or self.estimate_least_k)
        return bool(self.compute_mu)

    def _fit_full(self, X, n_components):
        """Full-SVD fit + gated quantum estimators (reference ``_fit_full``,
        ``_qPCA.py:557-676``)."""
        n_samples, n_features = X.shape
        if n_components == "mle":
            if n_samples < n_features:
                raise ValueError(
                    "n_components='mle' is only supported if "
                    "n_samples >= n_features")
        elif not 0 <= n_components <= min(n_samples, n_features):
            raise ValueError(
                f"n_components={n_components!r} must be between 0 and "
                f"min(n_samples, n_features)={min(n_samples, n_features)} "
                "with svd_solver='full'")
        elif n_components >= 1 and not isinstance(n_components, numbers.Integral):
            raise ValueError(
                f"n_components={n_components!r} must be of type int when "
                f">= 1, was of type={type(n_components)!r}")

        cd = check_compute_dtype(self.compute_dtype)
        if self.mesh is not None:
            from ..parallel.pca import centered_svd_sharded
            from ..parallel.streaming import \
                streamed_centered_svd_topk_sharded

            if self.ingest_ == "streamed":
                # tiles split over the mesh, partial Grams summed in shard
                # order: X is never resident
                from ..resilience import breaker

                breaker.preflight("qpca.fit", self._generator.device)
                mean, U, S, Vt = streamed_centered_svd_topk_sharded(
                    self.mesh, X, int(n_components), validate=True)
            else:
                mean, U, S, Vt = centered_svd_sharded(self.mesh, X)
        elif self.ingest_ == "streamed":
            # the same route, built tile by tile: the m×m Gram and the
            # column mean accumulate on the card while the next tile
            # uploads; X is never resident there. A tripped breaker gets
            # its half-open probe first, and raises if it stays open
            from ..resilience import breaker

            device = self._generator.device
            breaker.preflight("qpca.fit", device)
            mean, U, S, Vt = streamed_centered_svd_topk(
                X, int(n_components), compute_dtype=cd, device=device,
                validate=True)
        elif self._partial_u_route(n_components, n_samples, n_features):
            # only the U columns the fit keeps are materialized: the full
            # U product is the same O(n·m²) GEMM as the Gram matrix
            mean, U, S, Vt = centered_svd_topk(X, int(n_components), cd)
        else:
            mean, U, S, Vt = centered_svd(X)
        self.mean_ = mean.cpu().numpy()
        S_np, Vt_np = S.cpu().numpy(), Vt.cpu().numpy()

        explained_variance_ = (S_np**2) / (n_samples - 1)
        total_var = explained_variance_.sum()
        explained_variance_ratio_ = explained_variance_ / total_var

        if n_components == "mle":
            n_components = _infer_dimension(explained_variance_, n_samples)
        elif 0 < n_components < 1.0:
            ratio_cumsum = stable_cumsum(
                torch.from_numpy(explained_variance_ratio_)).numpy()
            n_components = int(
                np.searchsorted(ratio_cumsum, n_components, side="right") + 1)

        if n_components < min(n_features, n_samples):
            self.noise_variance_ = float(
                explained_variance_[n_components:].mean())
        else:
            self.noise_variance_ = 0.0

        self.n_samples_, self.n_features_ = n_samples, n_features

        # p given as a component count → retained-variance target
        # (reference _qPCA.py:617-618)
        if isinstance(self.ret_var, numbers.Integral) and self.ret_var != 0:
            self.ret_var = float(
                np.sum(explained_variance_ratio_[: self.ret_var]))
        if not self.n_components_flag and self.ret_var:
            # n_components=None + a retained-variance target p; None
            # without p keeps the full spectrum (the reference collapses
            # it to one component, _qPCA.py:620-623)
            n_components = self.ret_variance(
                explained_variance_ratio_, self.ret_var)
            self.components_retained_ = n_components

        self.components_ = Vt_np[:n_components]
        self.n_components_ = int(n_components)
        self.all_components = Vt_np
        self.explained_variance_all = explained_variance_
        self.explained_variance_ratio_all = explained_variance_ratio_
        self.explained_variance_ = explained_variance_[:n_components]
        self.explained_variance_ratio_ = explained_variance_ratio_[:n_components]
        self.singular_values_ = S_np[:n_components].copy()
        self.all_singular_values_ = S_np
        self.spectral_norm = float(S_np[0])
        # ‖Xc‖_F² = Σσ², from the fetched spectrum
        self.frob_norm = float(np.sqrt((S_np**2).sum()))
        # left singular vectors, row-wise; only the kept columns transfer.
        # The extractions below read both blocks where they already are
        if isinstance(U, ShardedRows):
            # only the kept columns leave their shards
            U = U.map(lambda u: u[:, :n_components]).to_tensor()
        left = U[:, :n_components].T
        self.left_sv = left.cpu().numpy()
        self._fit_rows = (Vt[:n_components], left)
        try:
            self._fit_estimators(X, mean)
        finally:
            del self._fit_rows

    def _fit_estimators(self, X, mean):
        """μ(A) and the quantum estimators ``fit`` asked for, on the
        fitted spectrum."""
        if self._need_mu() and self.mesh is not None:
            # the exact sweep over the sharded centered rows (padding rows
            # exactly zero), as the JAX package's mesh route takes it
            from ..parallel.pca import best_mu_sharded, centered_sharded

            self.norm_muA, self.muA = best_mu_sharded(
                centered_sharded(self.mesh, X, mean), 0.0, 1.0, 0.1)
            self.sketch_info_ = None
        elif self._need_mu():
            # the sketched μ route over the grid of the historical
            # best_mu(Xc, 0.0, step=0.1) call; muA is the certified upper
            # bound (never above ‖A‖_F). Computed on every fit, never
            # served from the digest cache: a cached μ of changed data
            # would scale every estimate below
            rng_sk = np.random.default_rng(
                [self._generator.initial_seed(), _sketch.SKETCH_SEED])
            stats = _sketch.spectral_stats(
                X - mean, _search_grid(0.0, 1.0, 0.1), sketch=self.sketch,
                with_sigma=False, rng=rng_sk)
            self.norm_muA, self.muA = stats.conservative_mu()
            self.sketch_info_ = stats.info()
        else:
            self.norm_muA = self.muA = None
            self.sketch_info_ = None

        if self.condition_number_est:
            (self.est_sigma_min, self.est_cond_number) = \
                self.condition_number_estimation(
                    epsilon=self.eps, delta=self.delta)
        if self.spectral_norm_est:
            self.est_spectral_norm = self.spectral_norm_estimation(
                epsilon=self.eps, delta=self.delta)
        if self.theta_estimate:
            self.est_theta = self.estimate_theta(
                epsilon=self.eps_theta, eta=self.eta, p=self.ret_var)
        if self.quantum_retained_variance:
            # the ratio sum works in σ/μ(A) units; fit's kwargs are in
            # absolute σ units
            self.p = float(self.quantum_factor_score_ratio_sum(
                eps=self.eps / self.muA, theta=self.theta_major / self.muA,
                eta=self.eta))
        if self.estimate_least_k:
            (self.estimate_least_right_sv, self.estimate_least_left_sv,
             self.estimate_least_s_values, self.estimate_least_fs,
             self.estimate_least_fs_ratio) = self.least_k_sv_extractors(
                delta=self.delta, eps=self.eps, theta=self.theta_minor,
                true_tomography=self.true_tomography,
                norm=self.tomography_norm)
        if self.estimate_all:
            (self.estimate_right_sv, self.estimate_left_sv,
             self.estimate_s_values, self.estimate_fs,
             self.estimate_fs_ratio) = self.topk_sv_extractors(
                delta=self.delta, eps=self.eps, theta=self.theta_major,
                true_tomography=self.true_tomography,
                norm=self.tomography_norm)

    def _fit_truncated(self, X, n_components):
        """Truncated randomized-SVD fit — the purely classical path
        (reference ``_fit_truncated``, ``_qPCA.py:678-771``)."""
        n_samples, n_features = X.shape
        if isinstance(n_components, str):
            raise ValueError(
                f"n_components={n_components!r} cannot be a string with "
                "svd_solver='randomized'")
        if not 1 <= n_components <= min(n_samples, n_features):
            raise ValueError(
                f"n_components={n_components!r} must be between 1 and "
                f"min(n_samples, n_features)={min(n_samples, n_features)} "
                "with svd_solver='randomized'")

        mean = torch.mean(X, dim=0)
        Xc = X - mean
        self.mean_ = mean.cpu().numpy()
        n_iter = 7 if self.iterated_power == "auto" else int(self.iterated_power)
        U, S, Vt = randomized_svd(
            self._next_key(), Xc, n_components, n_iter=n_iter)
        U_np, S_np, Vt_np = U.cpu().numpy(), S.cpu().numpy(), Vt.cpu().numpy()

        self.n_samples_, self.n_features_ = n_samples, n_features
        self.components_ = Vt_np
        self.n_components_ = int(n_components)
        self.explained_variance_ = (S_np**2) / (n_samples - 1)
        total_var = float(torch.var(Xc, dim=0, correction=1).sum())
        self.explained_variance_ratio_ = self.explained_variance_ / total_var
        self.singular_values_ = S_np.copy()
        self.left_sv = U_np.T
        self.spectral_norm = float(S_np[0])
        self.frob_norm = float(torch.linalg.norm(Xc))
        if self.n_components_ < min(n_features, n_samples):
            self.noise_variance_ = (
                total_var - self.explained_variance_.sum())
            self.noise_variance_ /= min(n_features, n_samples) - n_components
        else:
            self.noise_variance_ = 0.0

    # -- quantum estimators ---------------------------------------------------

    def _spectrum(self, values):
        return torch.as_tensor(np.asarray(values), device=self._device())

    def _sv_estimates(self, singular_values, scale_norm, eps_scaled):
        return singular_value_estimates(
            self._next_key(), singular_values, scale_norm, eps_scaled,
            self.n_features_)

    def spectral_norm_estimation(self, epsilon, delta):
        """Binary search for ‖A‖₂ (reference ``spectral_norm_estimation``,
        ``_qPCA.py:882-907``). ε = 0 short-circuits to the exact value."""
        if epsilon == 0:
            _obs.ledger.record("qpca", "spectral_norm_estimation",
                               queries={}, budget={"epsilon": 0.0},
                               short_circuit=True)
            return self.spectral_norm
        frob = self.frob_norm
        n_iterations = max(1, int(np.ceil(np.log(frob / epsilon))))
        with _obs.ledger.timed_step(
                "qpca", "spectral_norm_estimation",
                queries={"pe_spectrum_queries":
                         _obs.ledger.phase_estimation_queries(
                             len(self.singular_values_), n_iterations),
                         "ae_calls": n_iterations},
                budget={"epsilon": epsilon, "delta": delta}):
            return float(bracket_search_fused(
                self._next_key(), self._spectrum(self.singular_values_),
                frob, eps_scaled=float(epsilon / frob),
                ae_epsilon=float(delta), n_iterations=n_iterations,
                n_features=self.n_features_, find_min=False))

    def condition_number_estimation(self, epsilon, delta):
        """Binary search for σ_min over the FULL spectrum, then
        κ = σ̂_max/σ̂_min (the reference's version converges to ≈σ_max,
        ``_qPCA.py:909-961``). Returns (σ̂_min, κ̂); ε = 0 short-circuits
        to the exact values."""
        if epsilon == 0:
            _obs.ledger.record("qpca", "condition_number_estimation",
                               queries={}, budget={"epsilon": 0.0},
                               short_circuit=True)
            sigma_min = float(self.all_singular_values_[-1])
            return sigma_min, (self.spectral_norm / sigma_min
                               if sigma_min > 0 else np.inf)
        frob = self.frob_norm
        n_iterations = max(1, int(np.ceil(np.log(frob / epsilon))))
        with _obs.ledger.timed_step(
                "qpca", "condition_number_estimation",
                queries={"pe_spectrum_queries":
                         _obs.ledger.phase_estimation_queries(
                             len(self.all_singular_values_), n_iterations),
                         "ae_calls": n_iterations},
                budget={"epsilon": epsilon, "delta": delta}):
            sigma_min = float(bracket_search_fused(
                self._next_key(), self._spectrum(self.all_singular_values_),
                frob, eps_scaled=float(epsilon / frob),
                ae_epsilon=float(delta), n_iterations=n_iterations,
                n_features=self.n_features_, find_min=True))
        cond = self.spectral_norm / sigma_min if sigma_min > 0 else np.inf
        return sigma_min, cond

    def _require_mu(self):
        if getattr(self, "muA", None) is None:
            raise ValueError(
                "mu(A) was not computed during fit (no QADRA estimator flag "
                "was set); refit with a QADRA fit kwarg or construct with "
                "compute_mu=True to use this method post-fit")

    def quantum_factor_score_ratio_sum(self, eps, theta, eta):
        """Theorem 9 of QADRA (reference ``_qPCA.py:982-999``): estimated
        factor-score-ratio mass p̂ of singular values ≥ θ (θ in σ/μ(A)
        units), amplitude-estimated at precision ``eta``."""
        self._require_mu()
        if not theta:
            theta = self.est_theta / self.muA  # est_theta is stored unscaled
        S = self._spectrum(self.singular_values_)
        with _obs.ledger.timed_step(
                "qpca", "factor_score_ratio_sum",
                queries=({} if eps == 0 and eta == 0 else
                         {"pe_spectrum_queries": len(self.singular_values_),
                          "ae_calls": 1}),
                budget={"eps": eps, "eta": eta}):
            return float(estimated_mass(
                self._next_key(), S, float(self.muA), float(theta),
                torch.sum(S**2), eps_scaled=float(eps),
                ae_epsilon=float(eta), n_features=self.n_features_))

    def estimate_theta(self, epsilon, eta, p):
        """Theorem 10 of QADRA (reference ``estimate_theta``,
        ``_qPCA.py:1002-1022``): binary-search the threshold θ whose
        factor-score-ratio sum matches the target retained variance p;
        raises when no θ is found, as the reference does."""
        self._require_mu()
        if abs(0.0 - p) <= eta:
            return self.muA
        if abs(1.0 - p) <= eta:
            return 0.0
        if epsilon == 0:
            # zero error budget: θ = σ at the cumulative-mass step closest
            # to p, when within η/2
            _obs.ledger.record("qpca", "estimate_theta", queries={},
                               budget={"epsilon": 0.0, "eta": eta},
                               short_circuit=True)
            S = np.asarray(self.singular_values_, np.float64)
            cum = np.cumsum(S**2) / np.sum(S**2)
            j = int(np.argmin(np.abs(cum - p)))
            if abs(cum[j] - p) > eta / 2:
                raise ValueError("The binary search didn't find any value")
            return float(S[j])
        n_iterations = max(1, int(np.ceil(np.log(self.muA / epsilon))))
        # query counts are the n_iterations upper bound: the search stops
        # early on convergence
        with _obs.ledger.timed_step(
                "qpca", "estimate_theta",
                queries={"pe_spectrum_queries":
                         _obs.ledger.phase_estimation_queries(
                             len(self.singular_values_), n_iterations),
                         "ae_calls": n_iterations},
                budget={"epsilon": epsilon, "eta": eta}, upper_bound=True):
            theta, found = theta_search_fused(
                self._next_key(), self._spectrum(self.singular_values_),
                float(self.muA), float(p),
                eps_scaled=float(epsilon / self.muA), eta=float(eta),
                n_iterations=n_iterations, n_features=self.n_features_)
        if not found:
            raise ValueError("The binary search didn't find any value")
        return float(theta)

    def _sv_extract(self, delta, eps, theta, true_tomography, norm, *, top):
        """Shared Theorem-11 machinery for top-k / least-k extraction: one
        batched consistent-PE pass over the spectrum, host-side selection
        (the selected count is data-dependent), then one batched
        tomography call per side (U and V).

        Ledger: one PE spectrum pass (ε > 0) plus the tomography shots,
        2·N(d)·k per side with d the vector dimension; δ = 0 records 0
        shots. The spectrum estimate's |σ̂ − σ| is audited against ε at
        the ``qpca.sv_estimate`` site, at the reference's failure
        probability γ = 1 − 1/n_features."""
        self._require_mu()
        with _obs.ledger.timed_step(
                "qpca", "topk_extract" if top else "leastk_extract",
                budget={"eps": eps, "delta": delta}) as step:
            S = np.asarray(self.singular_values_)
            if not top:
                # least-k considers only the numerically nonzero σ
                S = S[~np.isclose(S, 0.0)]
            est = (self._sv_estimates(self._spectrum(S), float(self.muA),
                                      eps / self.muA).cpu().numpy()
                   if len(S) else S)
            if _obs.guarantees.enabled():
                if eps == 0:
                    _obs.guarantees.record_guarantee(
                        "qpca.sv_estimate", 0.0, 0.0, fail_prob=0.0,
                        short_circuit=True, estimator="qpca")
                elif len(S):
                    _obs.guarantees.observe(
                        "qpca.sv_estimate", np.abs(est - S), float(eps),
                        fail_prob=1.0 - 1.0 / self.n_features_,
                        estimator="qpca")
            sel = (est >= theta) if top else (est < theta)
            true_selected = S[sel]
            sv_estimation = est[sel]
            k = int(sel.sum())
            total_sq = float(np.sum(np.asarray(self.singular_values_) ** 2))
            p_mass = (float(np.sum(true_selected**2) / total_sq)
                      if total_sq else 0.0)

            right = np.asarray(self.components_)[: len(S)][sel]
            left = np.asarray(self.left_sv)[: len(S)][sel]
            if k:
                device = self._device()
                rows = torch.as_tensor(np.flatnonzero(sel), device=device)
                right_dev, left_dev = self._extraction_rows(device)
                right_est, left_est = (
                    tomography(self._next_key(), side[rows], delta,
                               true_tomography=true_tomography,
                               norm=norm).cpu().numpy()
                    for side in (right_dev, left_dev))
            else:
                right_est, left_est = right, left
            step.set_queries(
                pe_spectrum_queries=0 if eps == 0 else len(S),
                tomography_shots=sum(
                    _obs.ledger.tomography_shot_count(k, side.shape[1],
                                                      delta, norm)
                    for side in (right, left)) if k else 0)
            step.attrs["selected_k"] = k
        fs = sv_estimation**2 / (self.n_samples_ - 1)
        fs_ratio = sv_estimation**2 / self.frob_norm**2
        return (right_est, left_est, sv_estimation, fs, fs_ratio,
                true_selected, k, p_mass, right, left)

    def _extraction_rows(self, device):
        """(right, left) singular vectors, row-wise, on ``device``: during
        a fit the blocks the decomposition left there, otherwise the
        fitted arrays."""
        rows = getattr(self, "_fit_rows", None)
        if rows is not None:
            return rows
        return (torch.as_tensor(np.asarray(self.components_), device=device),
                torch.as_tensor(np.asarray(self.left_sv), device=device))

    def topk_sv_extractors(self, delta, eps, theta, true_tomography=True,
                           norm="L2", **_ignored):
        """Theorem 11 of QADRA (reference ``topk_sv_extractors``,
        ``_qPCA.py:1025-1068``): extract singular values/vectors whose
        estimated σ ≥ θ; vectors pass through tomography at error δ.

        Returns (right_sv_est, left_sv_est, σ̂, factor scores, fs ratios).
        """
        if theta == 0:
            theta = self.est_theta
        (right_est, left_est, sv_est, fs, fs_ratio, true_sel, k, p,
         right, left) = self._sv_extract(delta, eps, theta, true_tomography,
                                         norm, top=True)
        self.top_k_true_singular_value = true_sel
        self.topk = k
        self.topk_p = p
        self.topk_right_singular_vectors = right
        self.topk_left_singular_vectors = left
        self.theta = theta
        if getattr(self, "check_sv_uniform_distribution", False):
            self.sv_uniform_distribution_ = _sv_ratio(true_sel, sv_est)
        return right_est, left_est, sv_est, fs, fs_ratio

    def least_k_sv_extractors(self, delta, eps, theta, true_tomography=True,
                              norm="L2", **_ignored):
        """Least-k variant of Theorem 11 (reference
        ``least_k_sv_extractors``, ``_qPCA.py:1070-1121``): vectors whose
        estimated σ < θ among the numerically nonzero spectrum."""
        (right_est, left_est, sv_est, fs, fs_ratio, true_sel, k, p,
         right, left) = self._sv_extract(delta, eps, theta, true_tomography,
                                         norm, top=False)
        self.least_k_true_singular_value = true_sel
        self.least_k = k
        self.least_k_p = p
        self.leastk_right_singular_vectors = right
        self.leastk_left_singular_vectors = left
        if getattr(self, "check_sv_uniform_distribution", False):
            self.least_k_sv_uniform_distribution_ = _sv_ratio(true_sel,
                                                              sv_est)
        return right_est, left_est, sv_est, fs, fs_ratio

    # -- transform ------------------------------------------------------------

    def _validated(self, X):
        return check_n_features(self, self._validated_X(X, self._device()))

    def _project(self, X, use_classical_components=True, *,
                 validated=False):
        """(X − mean)·Wᵀ with W the classical components or the
        tomography-estimated ones (reference ``_base.py:97-128``), a tensor
        on the estimator's device."""
        check_is_fitted(self, "components_")
        if not validated:
            X = self._validated(X)
        Xc = X - torch.as_tensor(self.mean_, device=X.device)
        if use_classical_components:
            W = torch.as_tensor(self.components_, device=X.device)
            Xt = Xc @ W.T
            if self.whiten:
                Xt = Xt / torch.sqrt(torch.as_tensor(
                    self.explained_variance_, device=X.device))
        else:
            W = torch.as_tensor(self.estimate_right_sv, device=X.device)
            Xt = Xc @ W.T
            if self.whiten:
                # the reference reads a never-assigned attribute here
                # (_base.py:125); the top-k factor-score estimates are the
                # documented intent
                Xt = Xt / torch.sqrt(torch.as_tensor(self.estimate_fs,
                                                     device=X.device))
        return Xt

    def transform(self, X, classic_transform=True, epsilon_delta=0,
                  quantum_representation=False, norm="None", psi=0,
                  true_tomography=True, use_classical_components=True):
        """Apply dimensionality reduction (reference ``qPCA.transform``,
        ``_qPCA.py:773-843``); a tensor on the estimator's device.

        classic path: (X−μ)·Vᵀ. Quantum path: optionally project on the
        tomography-estimated components, and/or return a quantum
        representation of the projected data per ``norm``:
        'est_representation' (estimate + its error + F-norm deviation),
        'q_state' (a :class:`QuantumState` over rows), 'None' (noisy
        estimate), 'f_norm' (noisy estimate, F-normalized).
        """
        check_is_fitted(self, "components_")
        X = self._validated(X)
        if classic_transform:
            if epsilon_delta != 0 or quantum_representation or psi != 0:
                warnings.warn(
                    "Warning! You are using the classical transform, so the "
                    "quantum parameters are useless.")
            return self._project(X, validated=True)

        X_final = self._project(
            X, use_classical_components=use_classical_components,
            validated=True)
        if quantum_representation:
            if not (psi > 0 if norm != "est_representation" else psi >= 0):
                raise ValueError(f"psi={psi!r} must be > 0 (>= 0 for "
                                 f"norm='est_representation')")
            if not epsilon_delta > 0:
                raise ValueError(
                    f"epsilon_delta={epsilon_delta!r} must be > 0")
            result = self.compute_quantum_representation(
                X_final, psi=psi, epsilon_delta=epsilon_delta,
                type=norm, true_tomography=true_tomography)
            return {"quantum_representation_results": result}
        return X_final

    def _covariance(self):
        """Σ = Cᵀ·diag(λ−σ²)·C + σ²·I on the estimator's device."""
        device = self._device()
        C = torch.as_tensor(self.components_, device=device)
        ev = torch.as_tensor(self.explained_variance_, device=device)
        noise = float(self.noise_variance_)
        diff = torch.clamp(ev - noise, min=0.0)
        return ((C.T * diff) @ C
                + noise * torch.eye(C.shape[1], dtype=C.dtype, device=device))

    def _precision(self):
        """Σ⁻¹: with orthonormal component rows the Woodbury identity
        collapses to (1/σ²)(I − Cᵀ·diag((λ−σ²)/λ)·C); σ² = 0 takes the
        pseudo-inverse of the (then singular) covariance."""
        noise = float(self.noise_variance_)
        if noise == 0.0:
            return torch.linalg.pinv(self._covariance())
        device = self._device()
        C = torch.as_tensor(self.components_, device=device)
        ev = torch.as_tensor(self.explained_variance_, device=device)
        diff = torch.clamp(ev - noise, min=0.0)
        shrink = diff / torch.clamp(ev, min=1e-30)
        return (torch.eye(C.shape[1], dtype=C.dtype, device=device)
                - (C.T * shrink) @ C) / noise

    def get_covariance(self):
        """Model covariance (reference ``_base.py:25-44``)."""
        check_is_fitted(self, "components_")
        return self._covariance()

    def get_precision(self):
        """Σ⁻¹ in closed form (reference ``_base.py:46-77``)."""
        check_is_fitted(self, "components_")
        return self._precision()

    def score_samples(self, X):
        """Per-sample Gaussian log-likelihood under the probabilistic PCA
        model: −½(m·ln 2π − ln|Σ⁻¹| + xᵀΣ⁻¹x) for centered x."""
        check_is_fitted(self, "components_")
        X = self._validated(X)
        Xc = X - torch.as_tensor(self.mean_, device=X.device)
        P = self._precision()
        quad = torch.sum((Xc @ P) * Xc, dim=1)
        _, logdet = torch.linalg.slogdet(P)
        m = X.shape[1]
        return -0.5 * (m * math.log(2 * math.pi) - logdet + quad)

    def score(self, X, y=None):
        """Mean sample log-likelihood (stock sklearn ``PCA.score``)."""
        return float(torch.mean(self.score_samples(X)))

    def inverse_transform(self, X, use_classical_components=True):
        """Map back to feature space (reference ``_base.py:130-164``)."""
        check_is_fitted(self, "components_")
        X = check_array(X, device=self._device())
        if use_classical_components:
            W = torch.as_tensor(self.components_, device=X.device)
            if self.whiten:
                W = torch.sqrt(torch.as_tensor(
                    self.explained_variance_, device=X.device))[:, None] * W
        else:
            W = torch.as_tensor(self.estimate_right_sv, device=X.device)
            if self.whiten:
                W = torch.sqrt(torch.as_tensor(
                    self.estimate_fs, device=X.device))[:, None] * W
        return X @ W + torch.as_tensor(self.mean_, device=X.device)

    def compute_error(self, U, epsilon_delta, true_tomography):
        """Tomography-estimate U at total error ε+δ and report the F-norm
        deviation (reference ``compute_error``, ``_qPCA.py:845-856``)."""
        if not true_tomography:
            epsilon_delta = float(np.sqrt(self.n_components_) * epsilon_delta)
        A_sign = tomography(self._next_key(), U, epsilon_delta,
                            true_tomography=true_tomography)
        f_norm = float(torch.linalg.norm(U - A_sign))
        return A_sign, epsilon_delta, f_norm

    def compute_quantum_representation(self, X, psi, epsilon_delta,
                                       true_tomography, type="None"):
        """Quantum representations of projected data (reference
        ``compute_quantum_representation``, ``_qPCA.py:859-880``)."""
        if type == "est_representation":
            return self.compute_error(X, epsilon_delta, true_tomography)
        if self.mesh is not None:
            # each shard draws the estimates of its own rows
            from ..parallel.pca import tomography_sharded

            Y = tomography_sharded(self.mesh, self._next_key(), X, psi,
                                   true_tomography=true_tomography
                                   ).to_tensor()
        else:
            Y = tomography(self._next_key(), X, psi,
                           true_tomography=true_tomography)
        if type == "q_state":
            f_norm = torch.linalg.norm(Y)
            row_norms_ = torch.linalg.norm(Y, dim=1) / f_norm
            rows = [Y[i] / f_norm for i in range(len(Y))]
            return QuantumState(registers=rows, amplitudes=row_norms_)
        if type == "None":
            return Y
        if type == "f_norm":
            return Y / torch.linalg.norm(Y)
        raise ValueError(f"unknown quantum representation type {type!r}")

    # -- retained variance helpers -------------------------------------------

    def ret_variance(self, explained_variance_ratio_, variance):
        """Smallest k whose cumulated explained-variance ratio exceeds
        ``variance`` (reference ``ret_variance``, ``_qPCA.py:1228-1233``)."""
        ratio_cumsum = stable_cumsum(torch.as_tensor(
            np.asarray(explained_variance_ratio_))).numpy()
        return int(np.searchsorted(ratio_cumsum, variance, side="right") + 1)

    def q_ret_variance(self, measurements, variance):
        """Estimate the component count for a retained-variance target by
        measuring the singular-value quantum state ``measurements`` times
        (reference ``q_ret_variance``, ``_qPCA.py:1213-1226``; the state is
        built from σ/‖A‖_F amplitudes)."""
        if isinstance(self.n_components, numbers.Integral):
            return self.n_components
        S = np.asarray(self.all_singular_values_)
        state = QuantumState(registers=S, amplitudes=S)
        freqs = estimate_wald(
            state.measure_counts(self._next_key(), measurements),
            measurements).cpu().numpy()
        order = np.argsort(S)[::-1]
        cum = np.cumsum(freqs[order])
        return int(np.searchsorted(cum, variance) + 1)

    # -- theoretical runtime (reference accumulate_q_runtime,
    #    _qPCA.py:1123-1208) ------------------------------------------------

    def accumulate_q_runtime(self, n_samples, n_features,
                             estimate_components="all"):
        """Closed-form QADRA runtime accounting over an (n, m) mesh
        (reference ``_qPCA.py:1123-1208``), host numpy on the fitted
        statistics.

        ``quantum_runtime_container`` is rebuilt with one cost surface per
        estimator that ran: θ estimation μ·log(μ/ε_θ)·log(nm)/(ε_θ·η); the
        retained-variance cost μ/(ε·η); the top-k extraction's tomography
        costs (L2 or L∞) plus its singular-value term, for the left, right
        or both sides as ``estimate_components`` says; the least-k
        analogues.
        """
        # fresh accounting per call (the reference accumulates across
        # calls, counting twice on a repeated call)
        self.quantum_runtime_container = []
        n = np.asarray(n_samples, dtype=float)
        m = np.asarray(n_features, dtype=float)
        if self.theta_major == 0 and hasattr(self, "est_theta"):
            self.theta = self.est_theta
        if self.theta_estimate:
            self.quantum_runtime_container.append(
                (self.muA * np.log(self.muA / self.eps_theta)
                 * np.log(n * m)) / (self.eps_theta * self.eta))
        if self.quantum_retained_variance:
            self.quantum_runtime_container.append(
                np.broadcast_to(self.muA / (self.eps * self.eta), n.shape))
        if self.estimate_all:
            theta = getattr(self, "theta", self.theta_major)
            if self.tomography_norm == "L2":
                cost_left = (self.spectral_norm * self.muA * self.topk
                             * np.log(self.topk) * n * np.log(n)) / (
                    theta * np.sqrt(self.topk_p) * self.eps * self.delta**2)
                cost_right = ((self.spectral_norm / theta)
                              * (1 / np.sqrt(self.topk_p))
                              * (self.muA / self.eps)
                              * (self.topk * np.log(self.topk)
                                 * m * np.log(m)) / self.delta**2)
            else:
                fill = (self.spectral_norm * self.muA * self.topk) / (
                    theta * self.eps * self.delta**2)
                cost_left = np.full(n.shape, fill)
                cost_right = np.full(m.shape, fill)
            sv_term = (self.spectral_norm * self.muA * self.topk
                       * np.log(self.topk)) / (
                theta * np.sqrt(self.topk_p) * self.eps)
            self._append_extraction_cost(cost_left, cost_right, sv_term,
                                         estimate_components)
        if self.estimate_least_k and self.least_k:
            S = np.asarray(self.singular_values_)
            S_nz = S[~np.isclose(S, 0.0)]
            sigma_last = S_nz[-1]
            sigma_penult = S_nz[-2] if len(S_nz) > 1 else S_nz[-1]
            if self.tomography_norm == "L2":
                cost_left = ((self.theta_minor / sigma_last)
                             * (1 / np.sqrt(self.least_k_p))
                             * (self.muA / self.eps)
                             * (self.least_k * np.log(self.least_k)
                                * n * np.log(n)) / self.delta**2)
                cost_right = ((self.theta_minor / sigma_penult)
                              * (1 / np.sqrt(self.least_k_p))
                              * (self.muA / self.eps)
                              * (self.least_k * np.log(self.least_k)
                                 * m * np.log(m)) / self.delta**2)
            else:
                fill = (self.spectral_norm * self.muA * self.least_k) / (
                    self.theta_minor * self.eps * self.delta**2)
                cost_left = np.full(n.shape, fill)
                cost_right = np.full(m.shape, fill)
            sv_term = (self.theta_minor * self.muA * self.least_k) / (
                sigma_penult * np.sqrt(self.least_k_p) * self.eps)
            self._append_extraction_cost(cost_left, cost_right, sv_term,
                                         estimate_components)
        return self.quantum_runtime_container

    def _append_extraction_cost(self, cost_left, cost_right, sv_term,
                                estimate_components):
        """Add one extraction's cost for the sides asked for."""
        sides = {"all": cost_left + cost_right, "left_sv": cost_left,
                 "right_sv": cost_right}
        if estimate_components in sides:
            self.quantum_runtime_container.append(
                sides[estimate_components] + sv_term)

    def runtime_comparison(self, n_samples, n_features, saveas=None,
                           estimate_components="all",
                           classic_runtime="classic"):
        """Quantum-vs-classical runtime surfaces over the reference's
        100×100 mesh from 1 to (``n_samples``, ``n_features``) (reference
        ``_qPCA.py:1235-1315``, which plots through the MATLAB engine; a
        non-None ``saveas`` renders with matplotlib, imported only then).

        Returns (n_mesh, m_mesh, quantum_runtime, classic_runtime).
        """
        n, m = np.meshgrid(
            np.linspace(1, n_samples, dtype=np.int64, num=100),
            np.linspace(1, n_features, dtype=np.int64, num=100))
        if classic_runtime == "rand":
            c_runtime = n * m * np.log(self.n_components_)
        else:
            c_runtime = n * m.astype(float)**2
        q_runtime = self.accumulate_q_runtime(
            n_samples=n, n_features=m,
            estimate_components=estimate_components)
        if not q_runtime:
            raise ValueError(
                "no quantum estimator ran during fit — runtime_comparison "
                "needs at least one of theta_estimate, "
                "quantum_retained_variance, estimate_all, estimate_least_k")
        q_runtime = (np.sum(q_runtime, axis=0) if len(q_runtime) > 1
                     else q_runtime[0])
        if saveas:
            plot_runtime_surfaces(n, m, q_runtime, c_runtime, saveas)
        return n, m, q_runtime, c_runtime


class PCA(QPCA):
    """Classical PCA: the all-quantum-flags-off path of :class:`QPCA`
    (stock ``decomposition/_pca.py`` parity surface)."""

    def fit(self, X, y=None):
        return super().fit(X)

    def transform(self, X):
        return self._project(X)

    def fit_transform(self, X, y=None):
        with validation_scope(self):
            return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return super().inverse_transform(X)
