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

Ingest, as in the JAX package: the randomized algorithm on host data
streams X in tiles under ``ingest='streamed'``, or under 'auto' when X is
larger than the tile cap (:func:`~sq_learn_tpu_torch.streaming.
streamed_randomized_svd`: the range finder and power iterations as tiled
passes, X never resident on the card); ``ingest_`` records the route.
"""

import time
import warnings

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, TransformerMixin, check_is_fitted,
                    check_n_features)
from ..ops.linalg import randomized_svd, svd_flip_v, thin_svd
from ..streaming import streamed_randomized_svd
from ..utils.random import as_generator
from ..utils.validation import host_ingest

_MESH = "mesh is not ported yet: ROADMAP.md §1 item 6, multi-GPU"


class TruncatedSVD(TransformerMixin, BaseEstimator):
    """Dimensionality reduction by truncated SVD of the uncentered matrix.

    Parameters are the JAX ``TruncatedSVD``'s, plus ``device`` (None = the
    configured one). ``ingest`` is 'auto', 'monolithic' or 'streamed' (the
    module docstring says which fits stream); ``mesh`` raises.
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
        if self.ingest not in ("auto", "monolithic", "streamed"):
            raise ValueError(
                f"ingest must be 'auto', 'monolithic' or 'streamed', got "
                f"{self.ingest!r}")
        if self.algorithm not in ("randomized", "arpack"):
            raise ValueError(
                f"algorithm must be 'randomized' or 'arpack', got "
                f"{self.algorithm!r}")
        device = resolve_device(self.device)
        # host input is checked on the host first: a streamed fit never
        # uploads X whole, so its values are checked tile by tile
        Xh, over_cap = host_ingest(X)
        streamed = self._resolve_ingest(Xh, over_cap)
        X = Xh if streamed else self._validated_X(X, device)
        n_samples, n_features = X.shape
        k = self.n_components
        if not 1 <= k < n_features or k > n_samples:
            raise ValueError(
                f"n_components must be in [1, n_features={n_features}) and "
                f"<= n_samples={n_samples}; got {k}")
        self.ingest_ = "streamed" if streamed else "monolithic"
        t0 = time.perf_counter()
        with _obs.span("truncated_svd.fit_transform", n_samples=n_samples,
                       n_features=n_features, k=k, algorithm=self.algorithm,
                       ingest=self.ingest_):
            if streamed:
                Xt = self._fit_transform_streamed(X, k, device)
            else:
                Xt = self._fit_transform_impl(X, k)
        # classical estimator: the wall-clock baseline the quantum
        # estimators' query counts trade against
        _obs.ledger.record(
            "truncated_svd", "fit", wall_s=time.perf_counter() - t0,
            queries={}, budget={}, algorithm=self.algorithm,
            ingest=self.ingest_)
        return Xt

    def _resolve_ingest(self, Xh, over_cap):
        """Streamed (True) or monolithic: the streamed engine serves the
        randomized algorithm on host input (``Xh``; None for a tensor on
        the card; ``over_cap`` from :func:`host_ingest`). 'streamed' on another route warns and ingests
        monolithically, on the same device; 'auto' streams above the tile
        cap (the JAX package's rule)."""
        if self.ingest == "monolithic":
            return False
        structural = self.algorithm == "randomized" and Xh is not None
        if self.ingest == "streamed":
            if not structural:
                warnings.warn(
                    "ingest='streamed' engages only the single-device "
                    "randomized path on host data; this fit ingests "
                    "monolithically.", RuntimeWarning)
            return structural
        return structural and over_cap

    def _fit_transform_streamed(self, X, k, device):
        """The tiled range finder and power iterations (per pass one
        (m, k + oversamples) accumulation Σ tileᵀ·(tile·Q) while the next
        tile uploads): X is never resident on the card. The total variance
        the ratios divide by is taken on the host, as the JAX package
        takes it."""
        from ..resilience import breaker

        breaker.preflight("truncated_svd.fit", device)
        U, S, Vt = streamed_randomized_svd(
            as_generator(self.random_state, device), X, k,
            n_iter=self.n_iter, device=device, validate=True)
        Xt = U * S[None, :]
        explained = torch.var(Xt, dim=0, correction=0)
        total = float(np.var(X, axis=0, dtype=np.float64).sum())
        ratio = (explained / total if total > 0
                 else torch.zeros_like(explained))
        self.components_ = Vt.cpu().numpy()
        (self.singular_values_, self.explained_variance_,
         self.explained_variance_ratio_) = torch.stack(
            [S, explained, ratio]).cpu().numpy()
        self.n_features_in_ = X.shape[1]
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
