"""QLSSVC — quantum least-squares support vector classifier (counterpart of
``sq_learn_tpu/models/qlssvc.py``).

The reference's ``QLSSVC`` (``sklearn/svm/_qSVM.py:10-404``): a
least-squares SVM (Suykens & Vandewalle) trained by solving the saddle
system

    [[0, 1ᵀ], [1, K + γ⁻¹·I]] · [b, α] = [0, y]

through the symmetric eigendecomposition of F (optionally truncated at a
retained variance ``var``), plus a quantum inference error model: the
class probability P = ½(1 − h/β) is perturbed by truncated-Gaussian noise
of absolute or relative precision.

On tensors: the kernel matrix, the eigendecomposition of F, the decision
values h of a whole batch in one product, the β norms and the noise all
run on the estimator's device. The relative-error halving search is a
masked host loop over the whole batch whose "any active" flag the host
reads once every :data:`READ_EVERY` iterations. Every call that draws
noise seeds its own ``torch.Generator`` from ``random_state``, as the JAX
package builds its key from it on every call.

Under an obs run, ``fit`` and ``predict`` are spans (``qlssvc.fit``,
``qlssvc.predict``) with a ledger entry each (the training complexity
κ(F)·α_F; one amplitude-estimation call per predicted sample), and every
noisy P is audited against its per-row bound at the ``qlssvc.noisy_p``
site (declared failure probability 0: truncated noise cannot exceed it).

Not ported: the tiny-fit host routing of ``predict`` (a call computes on
the device it was given). The fit computes ‖X‖_F² itself on every fit;
it does not read the digest cache.
"""

import math

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, ClassifierMixin, check_is_fitted,
                    check_n_features)
from ..metrics.pairwise import (linear_kernel, polynomial_kernel, rbf_kernel,
                                sigmoid_kernel)
from ..ops.linalg import symmetric_eigh
from ..ops.quantum.noise import introduce_error, introduce_error_array
from ..utils.random import as_generator
from ..utils.validation import check_X_y

#: iterations of :func:`relative_error_routine` between two host reads of
#: its "any active" flag
READ_EVERY = 4


def _eigh_desc_abs(F):
    """Eigenpairs of the symmetric F ordered by descending |λ| (a stable
    order, as ``jnp.argsort``'s), decomposed in float64 for a float32 F
    (:func:`~sq_learn_tpu_torch.ops.linalg.symmetric_eigh`): the smallest
    |λ| sets ``cond_``. At 8 001² on an H100 float64 takes 616 ms against
    470 ms in float32 (``chip_profile.py``)."""
    evals, V = symmetric_eigh(F)
    order = torch.argsort(-torch.abs(evals), stable=True)
    return evals[order], V[:, order]


def saddle_matrix(K, penalty):
    """The LS-SVM saddle matrix F = [[0, 1ᵀ], [1, K + γ⁻¹·I]], (N+1)²."""
    N = K.shape[0]
    F = torch.zeros((N + 1, N + 1), dtype=K.dtype, device=K.device)
    F[0, 1:] = 1.0
    F[1:, 0] = 1.0
    F[1:, 1:] = K + (1.0 / penalty) * torch.eye(N, dtype=K.dtype,
                                                device=K.device)
    return F


def lssvc_solve(K, y, penalty, var=None):
    """Solve the LS-SVM saddle system by its (optionally truncated)
    eigendecomposition (reference ``_classical_fit``, ``_qSVM.py:84-130``).

    Parameters
    ----------
    K : (N, N) kernel tensor.
    y : (N,) ±1 labels (tensor or array).
    penalty : float — relative weight of the training error (γ).
    var : None, float in [0, 1), or int ≥ 1
        None keeps the full spectrum; a float truncates at that retained
        squared-singular-value mass; an int keeps that many singular
        values.

    Returns
    -------
    (b, alpha, singular_values, cond, normF): b a 0-d tensor and alpha an
    (N,) tensor on K's device, the kept singular values |λ| as a numpy
    array, cond = s_max/s_min and normF = s_max as floats.
    """
    N = K.shape[0]
    evals, V = _eigh_desc_abs(saddle_matrix(K, penalty))
    s = torch.abs(evals)
    if var is None:
        keep = N + 1
    elif isinstance(var, (int, np.integer)) or float(var) >= 1.0:
        keep = int(var)
    else:
        s_np = s.cpu().numpy()
        ratios = s_np**2 / np.sum(s_np**2)
        keep = int(np.searchsorted(np.cumsum(ratios), float(var)) + 1)
    keep = max(1, min(keep, N + 1))
    lam = evals[:keep]
    inv = torch.where(lam != 0, 1.0 / torch.where(lam != 0, lam, 1.0),
                      torch.zeros_like(lam))
    rhs = torch.cat([torch.zeros(1, dtype=K.dtype, device=K.device),
                     torch.as_tensor(y, dtype=K.dtype, device=K.device)])
    Vk = V[:, :keep]
    sol = Vk @ (inv * (Vk.T @ rhs))
    s_kept = s[:keep].cpu().numpy()
    return (sol[0], sol[1:], s_kept, float(s_kept[0] / s_kept[-1]),
            float(s_kept[0]))


def relative_error_routine(generator, x_max, x_real, relative_error,
                           delta=0.1, max_iter=64):
    """Batched halving search that mimics relative-error amplitude
    estimation (reference ``relative_error_routine``, ``_qSVM.py:245-261``):
    halve the scale X_r = X_max/2^r until a noisy estimate of X_real
    (absolute error ε_r = rel·X_r/2) reaches it.

    Every element advances in one masked host loop; an element stops when
    its estimate reaches its scale or after ``max_iter`` halvings, and a
    stopped element's state no longer changes, so the iterations run
    between two reads of the "any active" flag (one every
    :data:`READ_EVERY`) leave every result as it was. Nothing inside an
    iteration fetches.

    Returns (x_hat, delta_r, eps_abs) tensors.
    """
    x_max = torch.as_tensor(x_max)
    x_real = torch.broadcast_to(torch.as_tensor(x_real, device=x_max.device,
                                                dtype=x_max.dtype),
                                x_max.shape)
    r = torch.zeros_like(x_max)
    x_r, x_hat, eps = x_max.clone(), torch.zeros_like(x_max), \
        torch.zeros_like(x_max)
    for step in range(max_iter):
        active = (x_r > x_hat) & (r < max_iter)
        if step % READ_EVERY == 0 and not bool(active.any()):
            break
        r = torch.where(active, r + 1.0, r)
        x_r = torch.where(active, x_max / 2**r, x_r)
        eps = torch.where(active, relative_error * x_r / 2, eps)
        noisy = introduce_error(generator, x_real, eps)
        x_hat = torch.where(active, noisy, x_hat)
    delta_r = (6 * delta) / (math.pi**2 * torch.clamp(r, min=1.0) ** 2)
    return x_hat, delta_r, eps


class QLSSVC(ClassifierMixin, BaseEstimator):
    """Quantum least-squares SVM classifier (reference ``QLSSVC``,
    ``_qSVM.py:10``).

    Parameters mirror the JAX ``QLSSVC``: ``kernel`` ∈ {'linear', 'poly',
    'rbf', 'sigmoid'}; ``penalty`` is the LS-SVM regularization γ;
    ``low_rank`` + ``var`` truncate the solve; ``error_type`` selects the
    absolute or relative quantum inference error model with magnitudes
    ``absolute_error`` / ``relative_error``. ``device`` (None = the
    configured one, ``'cuda'`` by default) says where a fit computes.

    Fitted attributes: ``X_`` (the training rows, a tensor on the
    estimator's device), ``alpha_``, ``b_``, ``singular_values_F_``,
    ``cond_``, ``normF_``, ``alpha_F_``, ``Nu_``, ``n_features_in_`` and,
    for the linear kernel, ``coef_`` (numpy arrays and floats).
    """

    def __init__(self, kernel="linear", penalty=0.1, degree=3, gamma="scale",
                 coef0=0.0, verbose=False, algorithm="classic",
                 low_rank=False, var=0.9, error_type="absolute",
                 relative_error=0.5, absolute_error=0.01, train_error=0.01,
                 random_state=None, device=None):
        if error_type not in ("absolute", "relative"):
            raise ValueError(
                "The error should be either 'absolute' or 'relative'")
        self.kernel = kernel
        self.penalty = penalty
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.verbose = verbose
        self.algorithm = algorithm
        self.low_rank = low_rank
        self.var = var
        self.error_type = error_type
        self.relative_error = relative_error
        self.absolute_error = absolute_error
        self.train_error = train_error
        self.random_state = random_state
        self.device = device

    # -- kernels --------------------------------------------------------------

    def _get_gamma(self, X):
        if self.gamma == "scale":
            return 1.0 / (X.shape[1] * float(torch.var(X, correction=0)))
        if self.gamma == "auto":
            return 1.0 / self.n_features_in_
        return self.gamma

    def get_kernel(self, X, Y=None):
        """Kernel matrix (reference ``get_kernel``, ``_qSVM.py:375-389``);
        γ='scale' reads the variance of X."""
        if self.kernel == "linear":
            return linear_kernel(X, Y)
        if self.kernel == "poly":
            return polynomial_kernel(X, Y, degree=self.degree,
                                     gamma=self._get_gamma(X),
                                     coef0=self.coef0)
        if self.kernel == "rbf":
            return rbf_kernel(X, Y, gamma=self._get_gamma(X))
        if self.kernel == "sigmoid":
            return sigmoid_kernel(X, Y, gamma=self._get_gamma(X),
                                  coef0=self.coef0)
        raise ValueError(f"unknown kernel {self.kernel!r}")

    # -- fit ------------------------------------------------------------------

    def fit(self, X, y):
        """Fit the LS-SVM (reference ``fit``, ``_qSVM.py:133-176``) on the
        estimator's device, and the quantum complexity parameters: α_F =
        √N + γ⁻¹ + ‖X‖_F² and Nu = b² + Σᵢ αᵢ²‖xᵢ‖²."""
        with _obs.span("qlssvc.fit", n_samples=len(X), kernel=self.kernel):
            self._fit_impl(X, y)
        # theoretical quantum training cost κ(F)·α_F (_qSVM.py:300-301)
        _obs.ledger.record(
            "qlssvc", "fit",
            queries={"training_complexity": self.cond_ * self.alpha_F_},
            budget={"train_error": self.train_error},
            kernel=self.kernel, n_samples=self.X_.shape[0])
        return self

    def _fit_impl(self, X, y):
        device = resolve_device(self.device)
        X, y = check_X_y(X, y, device=device)
        self.X_ = X
        self.n_features_in_ = X.shape[1]
        var = None
        if self.low_rank:
            if isinstance(self.var, (int, np.integer)) or self.var >= 1.0:
                var = int(self.var)
            elif 0 <= self.var < 1.0:
                var = float(self.var)
            else:
                raise ValueError("QLSSVC.var should be greater than 0")
        b, alpha, s, cond, normF = lssvc_solve(self.get_kernel(X), y,
                                               self.penalty, var=var)
        row_sq = torch.sum(X * X, dim=1)
        # ‖X‖_F² exactly, in float64, on every fit (no digest cache)
        frob2 = torch.sum(row_sq.to(torch.float64))
        nu = b**2 + torch.sum(alpha**2 * row_sq)
        host = torch.stack([b.to(torch.float64), nu.to(torch.float64),
                            frob2]).cpu().numpy()
        self.b_ = float(host[0])
        self.Nu_ = float(host[1])
        self.alpha_ = alpha.cpu().numpy()
        self.singular_values_F_ = s
        self.cond_ = cond
        self.normF_ = normF
        self.alpha_F_ = float(np.sqrt(X.shape[0]) + self.penalty**-1
                              + host[2])
        if self.kernel == "linear":
            # the primal hyperplane w = Σ αᵢ xᵢ in one product
            self.coef_ = (alpha @ X).cpu().numpy()

    # -- decision pieces ------------------------------------------------------

    def _device(self):
        return resolve_device(self.device)

    def _input(self, X):
        check_is_fitted(self, "alpha_")
        return check_n_features(self, self._validated_X(X, self._device()))

    def _train_rows(self):
        """The training rows on the device (a model loaded from a
        checkpoint holds them as numpy)."""
        return torch.as_tensor(self.X_, device=self._device())

    def _h(self, X):
        """Decision values α·K(X_train, x) + b of the validated rows X."""
        Xt = self._train_rows()
        alpha = torch.as_tensor(self.alpha_, dtype=Xt.dtype,
                                device=Xt.device)
        return alpha @ self.get_kernel(Xt, X) + self.b_

    def _betas(self, X):
        """β(x) = √((N‖x‖²+1)·Nu) of the validated rows X."""
        N = self.X_.shape[0]
        return torch.sqrt((N * torch.sum(X * X, dim=1) + 1.0) * self.Nu_)

    def _generator(self):
        return as_generator(self.random_state, self._device())

    def get_h(self, X, approx=False):
        """Decision values h(x) = α·K(X_train, x) + b for all x in one
        product (reference ``get_h``, ``_qSVM.py:263-276``); with
        ``approx`` the inference error model perturbs them."""
        X = self._input(X)
        h = self._h(X)
        if approx:
            gen = self._generator()
            if self.error_type == "absolute":
                h = introduce_error(gen, h, self.absolute_error)
            else:
                _, _, eps_abs = relative_error_routine(
                    gen, self._betas(X), torch.abs(h), self.relative_error)
                h = introduce_error(gen, h, eps_abs)
        return h.cpu().numpy()

    def get_betas(self, X):
        """β(x) = √((N‖x‖²+1)·Nu) (reference ``get_betas``,
        ``_qSVM.py:278-282``)."""
        return self._betas(self._input(X)).cpu().numpy()

    def get_P(self, X, approx=False):
        """P(x) = ½(1 − h/β), optionally with the quantum error applied
        (reference ``get_P``, ``_qSVM.py:284-298``)."""
        X = self._input(X)
        h, beta = self._h(X), self._betas(X)
        P = 0.5 * (1.0 - h / beta)
        if approx:
            P, _ = self._noisy_P(P, h, beta)
        return P.cpu().numpy()

    def _noisy_P(self, P, h, beta):
        """P with the inference error model applied, and the per-row
        bound ε of the noise: truncnorm(±ε), so |P̃ − P| ≤ ε holds by
        construction, which the ``qlssvc.noisy_p`` site audits with
        declared failure probability 0. Tensors in and out."""
        gen = self._generator()
        if self.error_type == "absolute":
            eps = self.absolute_error / (2.0 * beta)
        else:
            _, _, eps_abs = relative_error_routine(
                gen, beta, torch.abs(h), self.relative_error)
            eps = eps_abs / (2.0 * beta)
        noisy = introduce_error(gen, P, eps)
        if _obs.guarantees.enabled():
            _obs.guarantees.observe(
                "qlssvc.noisy_p",
                torch.abs(noisy.to(torch.float64) - P.to(torch.float64)),
                eps, fail_prob=0.0, estimator="qlssvc",
                error_type=self.error_type)
        return noisy, eps

    # -- predict --------------------------------------------------------------

    def predict(self, X):
        """Quantum-error-model classification (reference ``predict``,
        ``_qSVM.py:178-215``): the noisy P thresholded at ½ → ±1."""
        X = self._input(X)
        with _obs.span("qlssvc.predict", n_queries=X.shape[0]):
            h, beta = self._h(X), self._betas(X)
            P, _ = self._noisy_P(0.5 * (1.0 - h / beta), h, beta)
            out = np.where(P.cpu().numpy() <= 0.5, 1.0, -1.0)
        # one amplitude-estimation call per sample in the inference error
        # model; the ledger carries the call count and the error budget
        err = (self.absolute_error if self.error_type == "absolute"
               else self.relative_error)
        _obs.ledger.record(
            "qlssvc", "predict", queries={"ae_calls": len(out)},
            budget={self.error_type + "_error": err})
        return out

    def classical_predict(self, X):
        """Noise-free classification sign(α·K+b) (reference
        ``classical_predict``, ``_qSVM.py:217-240``)."""
        h = self.get_h(X)
        return np.where(h >= 0, 1.0, -1.0)

    # -- quantum hyperplane + complexity accounting ---------------------------

    def get_approximated_hyperplane(self, x):
        """Noisy primal hyperplane (reference
        ``get_approximated_hyperplane``, ``_qSVM.py:313-332``): [b, α]
        perturbed with L2 budget ε_abs/β (absolute) or rel·|h|/β
        (relative), then w re-accumulated. Each mode uses its own knob
        (the reference's absolute branch reads ``relative_error``)."""
        x = self._input(x)
        beta = self._betas(x)
        Xt = self._train_rows()
        ba = torch.cat([torch.tensor([self.b_], dtype=Xt.dtype,
                                     device=Xt.device),
                        torch.as_tensor(self.alpha_, dtype=Xt.dtype,
                                        device=Xt.device)])
        if self.error_type == "absolute":
            norm_err = self.absolute_error / beta[0]
        else:
            norm_err = self.relative_error * torch.abs(self._h(x)[0]) / beta[0]
        approx = introduce_error_array(self._generator(), ba, norm_err)
        return float(approx[0]), (approx[1:] @ Xt).cpu().numpy()

    def get_training_complexity(self):
        """Theoretical quantum training cost κ(F)·α_F (reference
        ``_qSVM.py:300-301``)."""
        check_is_fitted(self, "alpha_")
        return self.cond_ * self.alpha_F_

    def get_classification_complexity(self, X, relative_error=False):
        """Theoretical quantum inference cost per sample (reference
        ``_qSVM.py:303-311``)."""
        betas = self.get_betas(X)
        ba_norm = np.linalg.norm(np.append(self.b_, self.alpha_), ord=2)
        if relative_error:
            hs = np.abs(self.get_h(X))
            return (self.cond_ * betas * self.alpha_F_) / (
                self.relative_error * hs * self.normF_**2 * ba_norm)
        return (self.cond_ * betas * self.alpha_F_) / (
            self.absolute_error * self.normF_**2 * ba_norm)

    def get_all_attributes(self, X):
        """(β, h, P, κ, relative cost, absolute cost) diagnostics bundle
        (reference ``get_all_attributes``, ``_qSVM.py:334-342``)."""
        betas = self.get_betas(X)
        hs = self.get_h(X)
        Ps = self.get_P(X)
        rel_comp = (self.cond_ * (betas - np.abs(hs)) * self.alpha_F_) / (
            np.abs(hs) * np.sqrt(np.maximum(Ps, 1e-30)))
        abs_comp = self.cond_ * betas * self.alpha_F_
        return betas, hs, Ps, self.cond_, rel_comp, abs_comp
