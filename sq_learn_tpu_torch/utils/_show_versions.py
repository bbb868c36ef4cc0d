"""Debug-information printer (counterpart of
``sq_learn_tpu/utils/_show_versions.py``; reference
``utils/_show_versions.py:76``).

The reference prints platform, Python dependency versions, and its OpenMP
build flag; the port's equivalents of the last section are torch's CUDA
build and the cards — the facts a bug report here needs.
"""

import platform
import sys

#: the Python packages a report names (None where one is missing)
_DEPS = ("numpy", "scipy", "torch", "triton", "einops")


def _get_sys_info():
    return {
        "python": sys.version.replace("\n", " "),
        "executable": sys.executable,
        "machine": platform.platform(),
    }


def _get_deps_info():
    info = {}
    for modname in _DEPS:
        try:
            mod = __import__(modname)
            info[modname] = getattr(mod, "__version__", "installed")
        except ImportError:
            info[modname] = None
    return info


def _get_backend_info():
    """CUDA facts without starting CUDA: torch's CUDA build always; the
    cards only when this process has already initialized CUDA (a first
    device query would create a context, and can hang on a wedged
    card)."""
    import torch

    info = {"torch CUDA": torch.version.cuda,
            "CUDA arch list": " ".join(torch.cuda.get_arch_list()) or None}
    try:
        if torch.cuda.is_initialized():
            n = torch.cuda.device_count()
            info["device count"] = n
            info["devices"] = ", ".join(
                f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(n))
    except Exception as exc:  # pragma: no cover - defensive
        info["devices"] = f"unavailable ({type(exc).__name__})"
    return info


def show_versions():
    """Print useful debugging information (reference
    ``utils/_show_versions.py:76``)."""
    print("\nSystem:")
    for k, stat in _get_sys_info().items():
        print(f"{k:>12}: {stat}")
    print("\nPython dependencies:")
    for k, stat in _get_deps_info().items():
        print(f"{k:>13}: {stat}")
    print("\nCUDA backend:")
    for k, stat in _get_backend_info().items():
        print(f"{k:>20}: {stat}")
