"""Estimator framework: the contract every model obeys.

A copy of ``sq_learn_tpu/base.py`` (the port keeps its own): ``__init__``
stores hyperparameters verbatim, ``fit`` returns ``self``, learned state
lives in trailing-underscore attributes, and ``get_params``/``set_params``/
``clone`` make estimators composable. Nothing here touches a tensor.
"""

import copy
import inspect
from collections import defaultdict

import numpy as np


class NotFittedError(ValueError, AttributeError):
    """Exception raised when an estimator is used before fitting."""


def _fitted_attributes(estimator):
    return [
        v for v in vars(estimator)
        if v.endswith("_") and not v.startswith("__") and not v.endswith("__")
    ]


def check_is_fitted(estimator, attributes=None):
    """Raise :class:`NotFittedError` if the estimator has no fitted
    attributes (or lacks one of ``attributes``)."""
    if attributes is not None:
        if isinstance(attributes, str):
            attributes = [attributes]
        fitted = all(hasattr(estimator, attr) for attr in attributes)
    else:
        fitted = len(_fitted_attributes(estimator)) > 0
    if not fitted:
        raise NotFittedError(
            f"This {type(estimator).__name__} instance is not fitted yet. "
            "Call 'fit' with appropriate arguments before using this estimator."
        )


def check_n_features(estimator, X):
    """Raise a clear width-mismatch error when a fitted estimator receives
    inference input whose feature count differs from fit's. No-op when the
    estimator never recorded a width."""
    seen = getattr(estimator, "n_features_in_", None)
    if seen is not None and X.shape[-1] != seen:
        raise ValueError(
            f"X has {X.shape[-1]} features, but {type(estimator).__name__} "
            f"is expecting {seen} features as input.")
    return X


def clone(estimator, *, safe=True):
    """Construct an unfitted estimator with the same hyperparameters."""
    if isinstance(estimator, (list, tuple, set, frozenset)):
        return type(estimator)([clone(e, safe=safe) for e in estimator])
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        if not safe:
            return copy.deepcopy(estimator)
        raise TypeError(
            f"Cannot clone object {estimator!r}: it does not implement get_params"
        )
    params = estimator.get_params(deep=False)
    new_params = {k: clone(v, safe=False) for k, v in params.items()}
    new_estimator = type(estimator)(**new_params)
    params_set = new_estimator.get_params(deep=False)
    for name in new_params:
        if params_set[name] is not new_params[name]:
            raise RuntimeError(
                f"Cannot clone {estimator!r}: constructor does not set "
                f"parameter {name}"
            )
    return new_estimator


class BaseEstimator:
    """Base class for all estimators in sq_learn_tpu_torch.

    Subclasses must list every hyperparameter as an explicit keyword argument
    of ``__init__`` (no ``*args``/``**kwargs``) and store them unmodified.
    """

    @classmethod
    def _get_param_names(cls):
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        params = [
            p for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]
        return sorted(p.name for p in params)

    def get_params(self, deep=True):
        """Get hyperparameters of this estimator as a dict."""
        out = {}
        for key in self._get_param_names():
            value = getattr(self, key)
            if deep and hasattr(value, "get_params") and not isinstance(value, type):
                for sub_key, sub_value in value.get_params().items():
                    out[f"{key}__{sub_key}"] = sub_value
            out[key] = value
        return out

    def set_params(self, **params):
        """Set hyperparameters of this estimator. Supports ``a__b`` nesting."""
        if not params:
            return self
        valid_params = self.get_params(deep=True)
        nested_params = defaultdict(dict)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid_params:
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: "
                    f"{sorted(valid_params)!r}."
                )
            if delim:
                nested_params[key][sub_key] = value
            else:
                setattr(self, key, value)
        for key, sub_params in nested_params.items():
            getattr(self, key).set_params(**sub_params)
        return self

    def _validated_X(self, X, device):
        """``check_array`` onto ``device`` under the estimator's
        validate-once cache (see
        :func:`~sq_learn_tpu_torch.utils.validation.validation_scope`)."""
        from .utils.validation import check_array, validated_once

        return validated_once(self, X,
                              lambda a: check_array(a, device=device))

    def __repr__(self):
        cls = type(self)
        try:
            defaults = {
                name: p.default
                for name, p in inspect.signature(cls.__init__).parameters.items()
            }
            shown = {
                k: v for k, v in self.get_params(deep=False).items()
                if not _param_is_default(v, defaults.get(k, inspect.Parameter.empty))
            }
        except Exception:
            shown = {}
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(shown.items()))
        return f"{cls.__name__}({args})"


def _param_is_default(value, default):
    if default is inspect.Parameter.empty:
        return False
    if isinstance(value, np.ndarray) or isinstance(default, np.ndarray):
        return False
    try:
        return bool(value == default)
    except Exception:
        return value is default


class TransformerMixin:
    """Mixin providing ``fit_transform``; the fit and transform halves run
    under one validate-once scope."""

    def fit_transform(self, X, y=None, **fit_params):
        from .utils.validation import validation_scope

        with validation_scope(self):
            if y is None:
                return self.fit(X, **fit_params).transform(X)
            return self.fit(X, y, **fit_params).transform(X)


class ClusterMixin:
    """Mixin providing ``fit_predict``."""

    _estimator_type = "clusterer"

    def fit_predict(self, X, y=None):
        self.fit(X)
        return self.labels_


class ClassifierMixin:
    """Mixin providing the accuracy ``score`` of classifiers."""

    _estimator_type = "classifier"

    def score(self, X, y):
        from .metrics import accuracy_score

        return accuracy_score(y, self.predict(X))
