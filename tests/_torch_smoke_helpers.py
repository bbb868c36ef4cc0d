"""Shared set-up of the contract-smoke tests (``tests/test_torch_smoke_*
.py``): run a smoke of either package as its own process on the CPU and
read its summary line and artifact.

A port smoke runs as ``python -m sq_learn_tpu_torch.<module> --device
cpu`` with ``SQ_OBS=1`` and its artifact at ``SQ_OBS_PATH`` in a
temporary directory, as ``make smoke-torch`` and ``chip_smoke.py`` run
it on the card; its JAX counterpart runs as ``python -m
sq_learn_tpu.<module>`` under ``JAX_PLATFORMS=cpu``. The JAX records
without an object in eager torch (``xla_cost``, ``watchdog``) are left
out of every comparison of record types.
"""

import os
import subprocess
import sys

from sq_learn_tpu_torch._smoke import child_env, summary_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX record types the port does not write (ROADMAP.md, "Not ported")
NO_OBJECT_TYPES = frozenset({"xla_cost", "watchdog"})

TIMEOUT_S = 600


def run_smoke(package, module, key, artifact, *args, **overrides):
    """Run ``python -m <package>.<module> *args`` with ``SQ_OBS=1`` and
    its artifact at ``artifact``; returns (the completed process, its
    summary line or None)."""
    overrides.setdefault("SQ_OBS", "1")
    overrides.setdefault("SQ_OBS_PATH", str(artifact))
    if package == "sq_learn_tpu":
        overrides.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.{module}", *args], cwd=REPO,
        env=child_env(**overrides), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    return out, summary_line(out.stdout, key)


def run_port(module, key, artifact, **overrides):
    """The port's smoke on the CPU."""
    return run_smoke("sq_learn_tpu_torch", module, key, artifact,
                     "--device", "cpu", **overrides)


def run_jax(module, key, artifact):
    """The JAX package's smoke on the CPU."""
    return run_smoke("sq_learn_tpu", module, key, artifact)


def record_types(summary):
    """The summary's record types, less those without an object in the
    port."""
    return set(summary["jsonl"]) - NO_OBJECT_TYPES


def assert_ok(out, summary, key):
    """Exit 0, an ``ok`` summary and no error."""
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert summary is not None, out.stdout[-3000:]
    assert summary[key] == "ok", summary["errors"]
    assert summary["errors"] == []


def validate(artifact):
    """The port's schema check of an artifact: (errors, by_type)."""
    from sq_learn_tpu_torch.obs.schema import validate_jsonl

    result = validate_jsonl(str(artifact))
    return result["errors"], result["by_type"]
