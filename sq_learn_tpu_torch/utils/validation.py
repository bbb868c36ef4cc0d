"""Input validation utilities (counterpart of
``sq_learn_tpu/utils/validation.py``).

Validation returns tensors on the device the estimator computes on: numpy
arrays, lists and tensors are all accepted. :func:`check_array` takes the
JAX function's keywords with their meaning and messages; under its
default ``dtype="float"`` every input lands in the validated float dtype,
float64 under ``default_dtype='float64'`` and float32 otherwise (the JAX
reference computes in float32 unless 64-bit mode is on, so float64 input
lands in float32 there too; nothing is cast to bfloat16). Host data bound
for the card above the streaming engine's tile cap
(``SQ_TRANSFER_CHUNK_BYTES``, 128 MiB) is uploaded through
:func:`~sq_learn_tpu_torch.streaming.streamed_resident_put`, as the JAX
package routes every accelerator upload. The streamed routes validate on
the host (:func:`host_ingest`, which also says whether the input passes
the cap) and check values per tile. ``set_config(assume_finite=True)``
turns the value check off everywhere: on the card it is a reduction and a
host sync per input, the ``sync.validation`` span
(:func:`sq_learn_tpu_torch.obs.span`).
"""

import numbers
from contextlib import contextmanager

import numpy as np
import torch

from .. import obs as _obs
from .._config import get_config, validated_float_dtype


def checks_finite(force_finite=None):
    """Whether validation checks values: ``force_finite`` when given, else
    ``not assume_finite`` of the configuration."""
    if force_finite is None:
        return not get_config()["assume_finite"]
    return bool(force_finite)


def check_array(X, *, dtype="float", ensure_2d=True, allow_nd=False,
                copy=False, ensure_min_samples=1, ensure_min_features=1,
                force_finite=None, device):
    """Validate a dense input array and return it as a contiguous tensor
    on ``device`` (reference ``check_array``, with its keywords, checks
    and messages).

    ``dtype``: ``"float"`` casts to the validated float dtype (module
    docstring), None keeps the input's dtype, anything else (a numpy or
    torch dtype) casts to it. ``copy=True`` never returns memory the
    input shares; otherwise an input already of the right dtype and
    device comes back without a copy (the port never writes into a
    validated input). ``force_finite`` None follows ``assume_finite``;
    when the check is off no reduction runs and nothing syncs.
    """
    _reject_sparse(X)
    target = _torch_dtype(dtype)
    on_card = torch.device(device).type == "cuda"
    if isinstance(X, torch.Tensor) and (X.is_cuda or not on_card):
        out = X.to(device=device, dtype=target or X.dtype)
        _check_dims(out, X, dtype, ensure_2d, allow_nd)
    else:
        Xh = _check_dims(_host_cast(X, dtype), X, dtype, ensure_2d,
                         allow_nd)
        if on_card:
            # host data over the tile cap reaches the card in bounded
            # tiles, staged through pinned memory (the JAX package's
            # _put_host); the engine uploads the canonical dtypes
            from ..streaming import streamed_resident_put, worth_streaming

            out = (streamed_resident_put(Xh, device=device)
                   if Xh.ndim == 2 and worth_streaming(Xh)
                   and host_array(Xh) is Xh
                   else torch.from_numpy(Xh).to(device))
        else:
            out = torch.from_numpy(Xh)
    if copy and _shares_memory(out, X):
        out = out.clone()
    if checks_finite(force_finite) and out.is_floating_point():
        with _obs.span("sync.validation"):
            finite = bool(torch.isfinite(out).all())
        if not finite:
            raise ValueError("Input contains NaN or infinity.")
    _check_min(out, ensure_2d, ensure_min_samples, ensure_min_features)
    return out.contiguous()


def _is_float_spec(dtype):
    """True for ``check_array``'s ``dtype="float"`` (a numpy dtype equals
    the string "float" too, so the type is checked first)."""
    return isinstance(dtype, str) and dtype == "float"


def _torch_dtype(dtype):
    """The torch dtype a ``check_array`` ``dtype`` asks for; None keeps
    the input's."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if _is_float_spec(dtype):
        return validated_float_dtype()
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _host_cast(X, dtype):
    """Host input as a C-contiguous ndarray in the dtype ``check_array``'s
    ``dtype`` asks for."""
    if _is_float_spec(dtype):
        return _host_float(X)
    X = to_numpy(X)
    if dtype is not None:
        target = (torch.empty(0, dtype=dtype).numpy().dtype
                  if isinstance(dtype, torch.dtype) else np.dtype(dtype))
        X = X.astype(target, copy=False)
    return np.ascontiguousarray(X)


def _shares_memory(out, X):
    """True when the tensor ``out`` may share memory with the input."""
    if isinstance(X, torch.Tensor):
        return (out.device == X.device and out.untyped_storage().data_ptr()
                == X.untyped_storage().data_ptr())
    return (out.device.type == "cpu" and isinstance(X, np.ndarray)
            and np.may_share_memory(out.numpy(), X))


def _reject_sparse(X):
    if hasattr(X, "toarray") or (isinstance(X, torch.Tensor)
                                 and X.layout != torch.strided):
        raise TypeError(
            "sparse input is not supported by the quantum estimators; "
            "densify with .toarray() first")


def _jax_view(X, dtype):
    """The ndarray the JAX function holds after its cast: under
    ``"float"`` float32 and float64 keep their dtype and the rest take
    the configured float dtype. Its repr goes into the 1-D message."""
    X = to_numpy(X.float() if isinstance(X, torch.Tensor)
                 and X.dtype == torch.bfloat16 else X)
    if _is_float_spec(dtype) and X.dtype in (np.float32, np.float64):
        return X
    return _host_cast(X, dtype)


def _check_dims(out, X, dtype, ensure_2d=True, allow_nd=False):
    """The dimension checks, on an ndarray or a tensor; returns ``out``.
    ``X`` and ``dtype`` only render the 1-D message."""
    if ensure_2d:
        if out.ndim == 1:
            raise ValueError(
                f"Expected 2D array, got 1D array instead:\n"
                f"array={_jax_view(X, dtype)!r}.\n"
                "Reshape your data either using array.reshape(-1, 1) if "
                "your data has a single feature or array.reshape(1, -1) if "
                "it contains a single sample.")
        if out.ndim != 2 and not allow_nd:
            raise ValueError(f"Found array with dim {out.ndim}, expected 2.")
    return out


def _check_min(out, ensure_2d=True, ensure_min_samples=1,
               ensure_min_features=1):
    """The sample and feature minimums of a 2-D input; returns ``out``."""
    if ensure_2d and out.ndim == 2:
        n_samples, n_features = out.shape
        if n_samples < ensure_min_samples:
            raise ValueError(
                f"Found array with {n_samples} sample(s) while a minimum of "
                f"{ensure_min_samples} is required.")
        if n_features < ensure_min_features:
            raise ValueError(
                f"Found array with {n_features} feature(s) while a minimum "
                f"of {ensure_min_features} is required.")
    return out


def host_array(X):
    """``X`` as a C-contiguous host ndarray in the canonical dtype: floats
    in the validated float dtype (float32 unless set otherwise, as the
    JAX package canonicalizes float64 without x64), other dtypes as they
    are. A CPU tensor is viewed, not copied, where it conforms."""
    X = to_numpy(X)
    if X.dtype.kind == "f":
        canonical = _np_float()
        if X.dtype != canonical:
            X = X.astype(canonical)
    return np.ascontiguousarray(X)


def _np_float():
    return (np.float64 if validated_float_dtype() == torch.float64
            else np.float32)


def _host_float(X):
    """Host input as a C-contiguous ndarray of the validated float
    dtype."""
    X = host_array(X)
    if X.dtype.kind != "f":
        X = X.astype(_np_float())
    return X


def check_array_host(X):
    """Validate host input for a streamed route without uploading it: the
    sparse, dimension and minimum-size checks of :func:`check_array`, on
    the host, and the cast to the validated float dtype. The values are
    checked on the card, tile by tile, by the streaming engine
    (``validate=True``, which follows ``assume_finite``), with
    :func:`check_array`'s error. Returns a C-contiguous ndarray."""
    _reject_sparse(X)
    return _check_min(_check_dims(_host_float(X), X, "float"))


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


def check_X_y(X, y, *, device, **kwargs):
    """Validate X as :func:`check_array` does (``kwargs`` are its
    keywords) and y as a 1-D host array of as many labels as X has rows;
    returns (tensor X, numpy y)."""
    X = check_array(X, device=device, **kwargs)
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


def check_sample_weight(sample_weight, X, dtype=None):
    """Validate sample weights into a (n,) tensor on X's device
    (reference ``_check_sample_weight``). ``dtype`` (a numpy or torch
    dtype) defaults to X's float dtype, float64 for other X."""
    n_samples = X.shape[0]
    if dtype is None:
        dtype = X.dtype if X.dtype in (torch.float32, torch.float64) \
            else torch.float64
    else:
        dtype = _torch_dtype(dtype)
    if sample_weight is None:
        return torch.ones(n_samples, dtype=dtype, device=X.device)
    if isinstance(sample_weight, numbers.Number):
        return torch.full((n_samples,), sample_weight, dtype=dtype,
                          device=X.device)
    if isinstance(sample_weight, torch.Tensor):
        sw = sample_weight.to(device=X.device, dtype=dtype)
    else:
        sw = torch.as_tensor(np.asarray(sample_weight), dtype=dtype,
                             device=X.device)
    if sw.ndim != 1 or sw.shape[0] != n_samples:
        raise ValueError(
            f"sample_weight.shape == {tuple(sw.shape)}, "
            f"expected ({n_samples},)")
    return sw.contiguous()
