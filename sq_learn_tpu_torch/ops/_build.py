"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``sq_learn_tpu_torch/_build/`` (git-ignored) and loaded with ``ctypes``.
The library's file name carries a digest of its source and flags, so an
edited source is rebuilt and an unchanged one is reused. A build failure
raises with the compiler's output; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

from .. import _knobs

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc():
    for root in (_knobs.get_raw("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name):
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path. The compiler's output (``-Xptxas -v`` register and
    shared-memory report) is kept beside the library as
    ``<library>.log``."""
    os.makedirs(_BUILD, exist_ok=True)
    path = library_path(name)
    if os.path.exists(path):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(f"{path}.log", "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise KernelBuildError(f"kernel build failed: {name}.cu (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def sources():
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def build_all():
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together; returns {name: library path}. The first
    failure raises."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def build_log(name):
    """The compiler's output for the current build of ``name``."""
    with open(f"{library_path(name)}.log") as f:
        return f.read()
