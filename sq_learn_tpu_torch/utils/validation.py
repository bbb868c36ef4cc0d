"""Input validation utilities (counterpart of
``sq_learn_tpu/utils/validation.py``).

Validation returns tensors on the device the estimator computes on: numpy
arrays, lists and tensors are all accepted, floats are cast to the
configured ``default_dtype`` (the JAX reference computes in float32 unless
64-bit mode is on, so float64 input lands in float32 there too). Host data
bound for the card above the streaming engine's tile cap
(``SQ_TRANSFER_CHUNK_BYTES``, 128 MiB) is uploaded through
:func:`~sq_learn_tpu_torch.streaming.streamed_resident_put`, as the JAX
package routes every accelerator upload. The streamed routes validate on
the host (:func:`host_ingest`, which also says whether the input passes
the cap) and check values per tile.
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
    _reject_sparse(X)
    dtype = default_dtype()
    on_card = torch.device(device).type == "cuda"
    if isinstance(X, torch.Tensor) and (X.is_cuda or not on_card):
        out = _check_2d(X.to(device=device, dtype=dtype))
    elif on_card:
        # host data over the tile cap reaches the card in bounded tiles,
        # staged through pinned memory (the JAX package's _put_host)
        from ..streaming import streamed_resident_put

        Xh, over_cap = host_ingest(X)
        out = (streamed_resident_put(Xh, device=device) if over_cap
               else torch.from_numpy(Xh).to(device))
    else:
        out = _check_2d(torch.as_tensor(np.asarray(X), dtype=dtype,
                                        device=device))
    if not bool(torch.isfinite(out).all()):
        raise ValueError("Input contains NaN or infinity.")
    return out.contiguous()


def _reject_sparse(X):
    if hasattr(X, "toarray") or (isinstance(X, torch.Tensor)
                                 and X.layout != torch.strided):
        raise TypeError(
            "sparse input is not supported by the quantum estimators; "
            "densify with .toarray() first")


def _check_2d(out):
    """The dimension and emptiness checks, on an ndarray or a tensor;
    returns ``out``."""
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
    return out


def host_array(X):
    """``X`` as a C-contiguous host ndarray in the canonical dtype: floats
    in the configured ``default_dtype`` (float32 unless set otherwise, as
    the JAX package canonicalizes float64 without x64), other dtypes as
    they are. A CPU tensor is viewed, not copied, where it conforms."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    X = np.asarray(X)
    if X.dtype.kind == "f":
        canonical = np.float64 if default_dtype() == torch.float64 \
            else np.float32
        if X.dtype != canonical:
            X = X.astype(canonical)
    return np.ascontiguousarray(X)


def _host_float(X):
    """Host input as a C-contiguous ndarray of the configured float
    dtype."""
    X = host_array(X)
    if X.dtype.kind != "f":
        X = X.astype(np.float64 if default_dtype() == torch.float64
                     else np.float32)
    return X


def check_array_host(X):
    """Validate host input for a streamed route without uploading it: the
    sparse, dimension and emptiness checks of :func:`check_array`, on the
    host, and the cast to the configured float dtype. The values are
    checked on the card, tile by tile, by the streaming engine
    (``validate=True``), with :func:`check_array`'s error. Returns a
    C-contiguous ndarray."""
    _reject_sparse(X)
    return _check_2d(_host_float(X))


def host_ingest(X):
    """The one rule of host ingest: ``(Xh, over_cap)`` with ``Xh`` the
    host input checked by :func:`check_array_host` and ``over_cap`` True
    when it passes the streaming engine's tile cap (the 'auto' rule that
    streams it); ``(None, False)`` for a tensor already on the card."""
    if not is_host_input(X):
        return None, False
    from ..streaming import worth_streaming

    Xh = check_array_host(X)
    return Xh, worth_streaming(Xh)


def is_host_input(X):
    """True unless ``X`` is a tensor already on a CUDA device."""
    return not (isinstance(X, torch.Tensor) and X.is_cuda)


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
