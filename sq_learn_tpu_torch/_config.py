"""Global configuration for sq_learn_tpu_torch.

Counterpart of ``sq_learn_tpu/_config.py:14-140``, with its four settings:
the ``device`` every entry point computes on, the ``default_dtype`` of
validated inputs, ``assume_finite`` (validation skips its finiteness check,
a reduction and a host sync per input on the card) and
``interactive_checks``, which the port stores and, like the JAX package,
never reads. The device defaults to ``"cuda"``:
a caller who wants the CPU says so (``set_config(device="cpu")`` or
``config_context(device="cpu")``). A CUDA request on a host without CUDA
raises; nothing ever drops to the CPU on its own.
"""

import threading
from contextlib import contextmanager

import torch

_global_config = {
    "device": "cuda",  # 'cuda' | 'cuda:<i>' | 'cpu'
    "default_dtype": "float32",  # 'float32' | 'float64' | 'bfloat16'
    "assume_finite": False,
    "interactive_checks": True,
}

_threadlocal = threading.local()


def _get_threadlocal_config():
    """Per-thread view of the config (so config_context is thread-safe)."""
    if not hasattr(_threadlocal, "config"):
        _threadlocal.config = _global_config.copy()
    return _threadlocal.config


def get_config():
    """Current values of the settings :func:`set_config` takes."""
    return _get_threadlocal_config().copy()


def set_config(device=None, default_dtype=None, assume_finite=None,
               interactive_checks=None):
    """Set sq_learn_tpu_torch configuration for this thread.

    Parameters
    ----------
    device : str or torch.device, optional
        ``'cuda'`` (the default), ``'cuda:<i>'`` or ``'cpu'``.
    default_dtype : {'float32', 'float64', 'bfloat16'}, optional
        Default floating dtype. Validated inputs are float64 under
        ``'float64'`` and float32 otherwise: as in the JAX package, input
        is never cast to bfloat16.
    assume_finite : bool, optional
        Skip the finiteness check of validated inputs.
    interactive_checks : bool, optional
        Stored for the JAX package's callers; nothing reads it.
    """
    local_config = _get_threadlocal_config()
    if device is not None:
        local_config["device"] = str(_parse_device(device))
    if default_dtype is not None:
        if default_dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported default_dtype {default_dtype!r}")
        local_config["default_dtype"] = default_dtype
    if assume_finite is not None:
        local_config["assume_finite"] = bool(assume_finite)
    if interactive_checks is not None:
        local_config["interactive_checks"] = bool(interactive_checks)


@contextmanager
def config_context(**new_config):
    """Temporarily override the configuration of this thread."""
    old_config = get_config()
    set_config(**new_config)
    try:
        yield
    finally:
        local_config = _get_threadlocal_config()
        local_config.clear()
        local_config.update(old_config)


def _parse_device(device):
    err = ValueError(f"device must be 'cuda[:i]' or 'cpu', got {device!r}")
    try:
        dev = torch.device(device)
    except RuntimeError:
        raise err from None
    if dev.type not in ("cuda", "cpu"):
        raise err
    return dev


def resolve_device(device=None):
    """The :class:`torch.device` to compute on: ``device`` when given,
    else the configured one. A CUDA device raises when CUDA is absent.

    On a CUDA device, float32 matrix products and convolutions are set to
    full float32 (TF32 off): the JAX reference computes in float32, and
    TF32 keeps about three decimal digits.
    """
    dev = _parse_device(device if device is not None
                        else _get_threadlocal_config()["device"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' (set_config / config_context) to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def default_dtype():
    """The configured floating dtype as a :class:`torch.dtype`."""
    return _DTYPES[_get_threadlocal_config()["default_dtype"]]


def validated_float_dtype():
    """The float dtype validation casts to: float64 under
    ``default_dtype='float64'``, float32 otherwise (bfloat16 included:
    the JAX package's ``check_array`` never casts to it)."""
    return (torch.float64 if _get_threadlocal_config()["default_dtype"]
            == "float64" else torch.float32)
