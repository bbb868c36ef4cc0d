"""Truncated SVD (LSA) without centering (counterpart of
``sq_learn_tpu/models/truncated_svd.py``).

``'randomized'`` is the Halko range finder of
:func:`~sq_learn_tpu_torch.ops.linalg.randomized_svd` with ``n_iter``
power iterations, drawn from the fit's :class:`torch.Generator`;
``'arpack'`` is the exact thin SVD (there is no ARPACK here either) with
V-based signs. The explained variances are computed on the device, and
``fit_transform``/``transform`` return tensors there. Under an obs run a
fit is one ``truncated_svd.fit_transform`` span and one classical ledger
entry (its wall clock, zero quantum queries).
"""

import time

import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, TransformerMixin, check_is_fitted,
                    check_n_features)
from ..ops.linalg import randomized_svd, svd_flip_v, thin_svd
from ..utils.random import as_generator

_MESH = "mesh is not ported yet: ROADMAP.md §1 item 6, multi-GPU"
_STREAMED = ("ingest='streamed' is not ported yet: ROADMAP.md §1 item 7, "
             "the data planes (streaming.py)")


class TruncatedSVD(TransformerMixin, BaseEstimator):
    """Dimensionality reduction by truncated SVD of the uncentered matrix.

    Parameters are the JAX ``TruncatedSVD``'s, plus ``device`` (None = the
    configured one). ``ingest`` 'auto' and 'monolithic' both ingest X in
    one upload; 'streamed' and ``mesh`` raise.
    """

    def __init__(self, n_components=2, *, algorithm="randomized", n_iter=5,
                 random_state=None, tol=0.0, mesh=None, ingest="auto",
                 device=None):
        self.n_components = n_components
        self.algorithm = algorithm
        self.n_iter = n_iter
        self.random_state = random_state
        self.tol = tol
        self.mesh = mesh
        self.ingest = ingest
        self.device = device

    def fit(self, X, y=None):
        self.fit_transform(X)
        return self

    def fit_transform(self, X, y=None):
        if self.mesh is not None:
            raise NotImplementedError(_MESH)
        if self.ingest == "streamed":
            raise NotImplementedError(_STREAMED)
        if self.ingest not in ("auto", "monolithic"):
            raise ValueError(
                f"ingest must be 'auto', 'monolithic' or 'streamed', got "
                f"{self.ingest!r}")
        if self.algorithm not in ("randomized", "arpack"):
            raise ValueError(
                f"algorithm must be 'randomized' or 'arpack', got "
                f"{self.algorithm!r}")
        X = self._validated_X(X, resolve_device(self.device))
        n_samples, n_features = X.shape
        k = self.n_components
        if not 1 <= k < n_features or k > n_samples:
            raise ValueError(
                f"n_components must be in [1, n_features={n_features}) and "
                f"<= n_samples={n_samples}; got {k}")
        self.ingest_ = "monolithic"
        t0 = time.perf_counter()
        with _obs.span("truncated_svd.fit_transform", n_samples=n_samples,
                       n_features=n_features, k=k, algorithm=self.algorithm,
                       ingest=self.ingest_):
            Xt = self._fit_transform_impl(X, k)
        # classical estimator: the wall-clock baseline the quantum
        # estimators' query counts trade against
        _obs.ledger.record(
            "truncated_svd", "fit", wall_s=time.perf_counter() - t0,
            queries={}, budget={}, algorithm=self.algorithm,
            ingest=self.ingest_)
        return Xt

    def _fit_transform_impl(self, X, k):
        n_features = X.shape[1]
        if self.algorithm == "randomized":
            U, S, Vt = randomized_svd(as_generator(self.random_state,
                                                   X.device),
                                      X, k, n_iter=self.n_iter)
        else:
            U, S, Vt = thin_svd(X)
            U, Vt = svd_flip_v(U, Vt)
            U, S, Vt = U[:, :k], S[:k], Vt[:k]
        Xt = U * S[None, :]
        # the variance of the projected columns against the input's total
        explained = torch.var(Xt, dim=0, correction=0)
        total = torch.sum(torch.var(X, dim=0, correction=0))
        ratio = torch.where(total > 0, explained / total,
                            torch.zeros_like(explained))
        self.components_ = Vt.cpu().numpy()
        (self.singular_values_, self.explained_variance_,
         self.explained_variance_ratio_) = torch.stack(
            [S, explained, ratio]).cpu().numpy()
        self.n_features_in_ = n_features
        return Xt

    def _components(self, X):
        return torch.as_tensor(self.components_, dtype=X.dtype,
                               device=X.device)

    def transform(self, X):
        check_is_fitted(self, "components_")
        X = check_n_features(self, self._validated_X(
            X, resolve_device(self.device)))
        return X @ self._components(X).T

    def inverse_transform(self, X):
        check_is_fitted(self, "components_")
        X = self._validated_X(X, resolve_device(self.device))
        return X @ self._components(X)


__all__ = ["TruncatedSVD"]
