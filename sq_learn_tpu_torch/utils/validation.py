"""Input validation utilities (counterpart of
``sq_learn_tpu/utils/validation.py``).

Validation returns tensors on the device the estimator computes on: numpy
arrays, lists and tensors are all accepted, floats are cast to the
configured ``default_dtype`` (the JAX reference computes in float32 unless
64-bit mode is on, so float64 input lands in float32 there too).
"""

import numbers
from contextlib import contextmanager

import numpy as np
import torch

from .._config import default_dtype


def check_array(X, *, device):
    """Validate a dense, finite 2-D input array and return it as a
    contiguous float tensor on ``device``. The port never writes into a
    validated input, so an input already of the right dtype and device is
    returned without a copy."""
    if hasattr(X, "toarray") or (isinstance(X, torch.Tensor)
                                 and X.layout != torch.strided):
        raise TypeError(
            "sparse input is not supported by the quantum estimators; "
            "densify with .toarray() first")
    dtype = default_dtype()
    if isinstance(X, torch.Tensor):
        out = X.to(device=device, dtype=dtype)
    else:
        out = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
    if out.ndim == 1:
        raise ValueError(
            "Expected 2D array, got 1D array instead. Reshape your data "
            "either using array.reshape(-1, 1) if your data has a single "
            "feature or array.reshape(1, -1) if it contains a single "
            "sample.")
    if out.ndim != 2:
        raise ValueError(f"Found array with dim {out.ndim}, expected 2.")
    if 0 in out.shape:
        raise ValueError(
            f"Found array with shape {tuple(out.shape)}: at least one "
            f"sample and one feature are required.")
    if not bool(torch.isfinite(out).all()):
        raise ValueError("Input contains NaN or infinity.")
    return out.contiguous()


def to_numpy(a):
    """``a`` as a numpy array; a tensor is fetched from its device."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def check_X_y(X, y, *, device):
    """Validate X as :func:`check_array` does and y as a 1-D host array of
    as many labels as X has rows; returns (tensor X, numpy y)."""
    X = check_array(X, device=device)
    y = to_numpy(y)
    if y.ndim != 1:
        y = np.ravel(y)
    if len(y) != X.shape[0]:
        raise ValueError(
            f"Found input variables with inconsistent numbers of samples: "
            f"[{X.shape[0]}, {len(y)}]")
    return X, y


@contextmanager
def validation_scope(estimator):
    """Open a validate-once scope on ``estimator``: while active, repeated
    :meth:`~sq_learn_tpu_torch.base.BaseEstimator._validated_X` calls on
    the SAME input object return the first call's validated tensor. The
    cache is keyed by object identity and lives only for the scope."""
    prev = getattr(estimator, "_validation_scope", None)
    if prev is None:
        estimator._validation_scope = {}
    try:
        yield
    finally:
        if prev is None:
            try:
                del estimator._validation_scope
            except AttributeError:
                pass


def validated_once(estimator, X, validator):
    """Run ``validator(X)`` under the estimator's validate-once cache (a
    passthrough when no :func:`validation_scope` is open)."""
    scope = getattr(estimator, "_validation_scope", None)
    if scope is None:
        return validator(X)
    hit = scope.get(id(X))
    if hit is not None:
        return hit[1]
    out = validator(X)
    # keep the input alive with its entry so its id cannot be reused
    scope[id(X)] = (X, out)
    scope[id(out)] = (out, out)
    return out


def check_sample_weight(sample_weight, X):
    """Validate sample weights into a (n,) tensor of X's dtype and device
    (reference ``_check_sample_weight``)."""
    n_samples = X.shape[0]
    if sample_weight is None:
        return torch.ones(n_samples, dtype=X.dtype, device=X.device)
    if isinstance(sample_weight, numbers.Number):
        return torch.full((n_samples,), float(sample_weight), dtype=X.dtype,
                          device=X.device)
    if isinstance(sample_weight, torch.Tensor):
        sw = sample_weight.to(device=X.device, dtype=X.dtype)
    else:
        sw = torch.as_tensor(np.asarray(sample_weight), dtype=X.dtype,
                             device=X.device)
    if sw.ndim != 1 or sw.shape[0] != n_samples:
        raise ValueError(
            f"sample_weight.shape == {tuple(sw.shape)}, "
            f"expected ({n_samples},)")
    return sw.contiguous()
