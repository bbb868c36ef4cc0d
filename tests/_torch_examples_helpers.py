"""Shared set-up of ``tests/test_torch_examples_*.py``: run a JAX driver
of ``examples/`` in a subprocess, offline; load a driver of
``examples_torch/`` in this process; compare the two drivers' printed
lines with their numbers masked; the tolerance of an accuracy's draw.
"""

import importlib.util
import math
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: runs ``examples/<driver>`` as ``__main__`` with its arguments, with
#: sklearn's fetchers replaced by a raise: the JAX package's ``load_mnist``
#: tries ``fetch_openml`` before its offline surrogate, and a test never
#: reaches for the network
_OFFLINE = r"""
import os, runpy, sys
import sklearn.datasets

def _offline(*args, **kwargs):
    raise OSError("the tests run offline")

sklearn.datasets.fetch_openml = _offline
sklearn.datasets.fetch_covtype = _offline
path = sys.argv[1]
sys.path[:0] = [os.path.dirname(path), os.path.dirname(os.path.dirname(path))]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
"""


def run_jax_driver(name, *args, env=None, timeout=600):
    """stdout of ``python examples/<name> <args>`` on JAX's CPU backend,
    offline, in a temporary directory of its own (``streaming_fit.py``
    leaves its files there); fails the test on a non-zero exit."""
    with tempfile.TemporaryDirectory() as tmp:
        full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                    TMPDIR=tmp, **(env or {}))
        # niced: the JAX drivers are throughput work, and the suite's
        # workers run tests beside them whose rendezvous wait on a clock
        out = subprocess.run(
            [sys.executable, "-c", _OFFLINE,
             os.path.join(REPO, "examples", name), *args], cwd=REPO,
            env=full, capture_output=True, text=True, timeout=timeout,
            preexec_fn=lambda: os.nice(10))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def load_driver(name):
    """The module ``examples_torch/<name>.py``, under a name of its own
    (the JAX drivers' files have the same names)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(REPO, "examples_torch",
                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?%?")


def masked(text):
    """The printed lines with every number replaced by ``#`` and runs of
    spaces collapsed: what two drivers' outputs share when their wording
    and format agree."""
    return [" ".join(_NUMBER.sub("#", line).split())
            for line in text.splitlines() if line.strip()]


def numbers(line):
    """The numbers of one printed line, in order."""
    return [float(v.rstrip("%")) for v in _NUMBER.findall(line)]


def line_after(text, prefix):
    """The first printed line that starts with ``prefix``."""
    for line in text.splitlines():
        if line.strip().startswith(prefix):
            return line
    raise AssertionError(f"no line starts with {prefix!r} in:\n{text}")


def acc_tol(p, n):
    """How far two accuracies over the same ``n`` rows may lie apart when
    each follows an independent noise draw: 4 standard deviations of the
    difference of two binomial shares, √(2·p(1−p)/n), with p(1−p) floored
    at 1/n so that a share of 1.0 still allows a row."""
    return 4.0 * math.sqrt(2.0 * max(p * (1.0 - p), 1.0 / n) / n)
