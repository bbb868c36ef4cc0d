"""Preprocessing transformers (counterpart of ``sq_learn_tpu/preprocessing.py``).

The statistics are torch reductions on the estimator's device, fetched
once at the end of ``fit`` into numpy attributes as the JAX package keeps
them; ``transform`` returns a tensor on that device, so the next step of a
pipeline reads it there without another upload.
"""

import numpy as np
import torch

from ._config import resolve_device
from .base import (BaseEstimator, TransformerMixin, check_is_fitted,
                   check_n_features)


class _Scaler(TransformerMixin, BaseEstimator):
    """Validation shared by the scalers: inputs become float tensors on
    the estimator's device (None = the configured one)."""

    def _input(self, X, fitted=True):
        X = self._validated_X(X, resolve_device(self.device))
        return check_n_features(self, X) if fitted else X

    def _param(self, name, X):
        return torch.as_tensor(np.asarray(getattr(self, name)),
                               dtype=X.dtype, device=X.device)


class StandardScaler(_Scaler):
    """Standardize features to zero mean and unit variance (ddof 0, as
    ``jnp.var``); a constant column keeps scale 1."""

    def __init__(self, *, with_mean=True, with_std=True, copy=True,
                 device=None):
        self.with_mean = with_mean
        self.with_std = with_std
        self.copy = copy
        self.device = device

    def fit(self, X, y=None):
        X = self._input(X, fitted=False)
        n, m = X.shape
        self.n_features_in_ = m
        mean = (torch.mean(X, dim=0) if self.with_mean
                else torch.zeros(m, dtype=X.dtype, device=X.device))
        if self.with_std:
            var = torch.var(X, dim=0, correction=0)
            scale = torch.sqrt(var)
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            mean, var, scale = (t.cpu().numpy() for t in
                                torch.stack([mean, var, scale]))
            self.var_ = var
        else:
            mean = mean.cpu().numpy()
            self.var_ = None
            scale = np.ones(m, mean.dtype)
        self.mean_ = mean
        self.scale_ = scale
        self.n_samples_seen_ = n
        return self

    def transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._input(X)
        return (X - self._param("mean_", X)) / self._param("scale_", X)

    def inverse_transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._input(X)
        return X * self._param("scale_", X) + self._param("mean_", X)


class MinMaxScaler(_Scaler):
    """Scale features to ``feature_range``; a constant column keeps range
    1."""

    def __init__(self, feature_range=(0, 1), *, copy=True, device=None):
        self.feature_range = feature_range
        self.copy = copy
        self.device = device

    def fit(self, X, y=None):
        X = self._input(X, fitted=False)
        self.n_features_in_ = X.shape[1]
        lo, hi = self.feature_range
        data_min = torch.min(X, dim=0).values
        data_max = torch.max(X, dim=0).values
        rng = data_max - data_min
        rng = torch.where(rng == 0, torch.ones_like(rng), rng)
        scale = (hi - lo) / rng
        shift = lo - data_min * scale
        (self.data_min_, self.data_max_, self.scale_,
         self.min_) = torch.stack([data_min, data_max, scale,
                                   shift]).cpu().numpy()
        return self

    def transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._input(X)
        return X * self._param("scale_", X) + self._param("min_", X)

    def inverse_transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._input(X)
        return (X - self._param("min_", X)) / self._param("scale_", X)


class Normalizer(_Scaler):
    """Scale rows to unit norm ('l2', 'l1' or 'max'); a zero row stays
    zero."""

    def __init__(self, norm="l2", *, copy=True, device=None):
        self.norm = norm
        self.copy = copy
        self.device = device

    def fit(self, X, y=None):
        self.n_features_in_ = self._input(X, fitted=False).shape[1]
        return self

    def transform(self, X):
        X = self._input(X, fitted=False)
        if self.norm == "l2":
            norms = torch.linalg.vector_norm(X, dim=1, keepdim=True)
        elif self.norm == "l1":
            norms = torch.sum(torch.abs(X), dim=1, keepdim=True)
        elif self.norm == "max":
            norms = torch.max(torch.abs(X), dim=1, keepdim=True).values
        else:
            raise ValueError(f"unknown norm {self.norm!r}")
        return X / torch.where(norms == 0, torch.ones_like(norms), norms)


__all__ = ["MinMaxScaler", "Normalizer", "StandardScaler"]
