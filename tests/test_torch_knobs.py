"""The port's knob registry (``sq_learn_tpu_torch._knobs``) against the JAX
package's, on the CPU: every knob the port registers has the JAX
registry's kind and default (``CUDA_HOME`` aside, which the port alone
reads), the accessors read the environment as the JAX ones do, the
module and ``obs`` import without torch, and no module of the port reads
the environment around the registry.
"""

import os
import re
import subprocess
import sys

import pytest

from sq_learn_tpu import _knobs as jknobs
from sq_learn_tpu_torch import _knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"CUDA_HOME"}


@pytest.mark.parametrize("name", sorted(set(_knobs.REGISTRY) - PORT_ONLY))
def test_registered_knob_matches_jax(name):
    ours, theirs = _knobs.knob(name), jknobs.knob(name)
    assert (ours.kind, ours.default, ours.scope) == (
        theirs.kind, theirs.default, theirs.scope)


def test_registry_holds_the_planes_the_port_has():
    names = set(_knobs.REGISTRY)
    assert {"SQ_OBS", "SQ_OBS_PATH", "SQ_OBS_AUDIT_STRICT", "SQ_FAULTS",
            "SQ_RESILIENCE_STRICT", "SQ_RETRY_MAX", "SQ_RETRY_BACKOFF_S",
            "SQ_RETRY_SEED", "SQ_TILE_DEADLINE_S", "SQ_BREAKER_K",
            "SQ_BREAKER_COOLDOWN_S", "SQ_STREAM_TILE_BYTES",
            "SQ_STREAM_MIN_BUCKET_ROWS", "SQ_STREAM_CKPT_DIR",
            "SQ_STREAM_CKPT_EVERY", "SQ_TRANSFER_CHUNK_BYTES"} <= names
    assert _knobs.get_int("SQ_TRANSFER_CHUNK_BYTES") == 128 * 2 ** 20
    assert [k.name for k in _knobs.iter_knobs()][-1] == "CUDA_HOME"


@pytest.mark.parametrize("name,raw", [
    ("SQ_OBS", None), ("SQ_OBS", "1"), ("SQ_OBS", "true"), ("SQ_OBS", "0"),
    ("SQ_STATS_CACHE", None), ("SQ_STATS_CACHE", "0"),
    ("SQ_STATS_CACHE", "no"), ("SQ_RESILIENCE_STRICT", "1")])
def test_flags_read_as_in_jax(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert _knobs.get_bool(name) == jknobs.get_bool(name)


def test_typed_accessors_and_defaults(monkeypatch):
    monkeypatch.setenv("SQ_RETRY_MAX", "7")
    monkeypatch.setenv("SQ_TILE_DEADLINE_S", "0.5")
    monkeypatch.delenv("SQ_STREAM_TILE_BYTES", raising=False)
    assert _knobs.get_int("SQ_RETRY_MAX") == jknobs.get_int("SQ_RETRY_MAX")
    assert _knobs.get_float("SQ_TILE_DEADLINE_S") == 0.5
    assert _knobs.get_raw("SQ_STREAM_TILE_BYTES") is None
    assert _knobs.get_int("SQ_STREAM_TILE_BYTES", 5) == 5
    assert _knobs.get_str("SQ_OBS_PATH") == "sq_obs.jsonl"
    assert _knobs.is_set("SQ_RETRY_MAX")
    assert _knobs.snapshot(["SQ_RETRY_MAX", "SQ_STREAM_TILE_BYTES"]) == {
        "SQ_RETRY_MAX": "7", "SQ_STREAM_TILE_BYTES": None}
    monkeypatch.delenv("SQ_STREAM_CKPT_EVERY", raising=False)
    assert _knobs.setdefault("SQ_STREAM_CKPT_EVERY", 4) == "4"
    with pytest.raises(_knobs.UnknownKnobError, match="SQ_NOPE"):
        _knobs.get_raw("SQ_NOPE")
    with pytest.raises(AttributeError):
        _knobs.knob("SQ_OBS").default = True


def test_knobs_and_obs_import_without_torch():
    code = ("import sys; sys.modules['torch'] = None; "
            "import sq_learn_tpu_torch._knobs, sq_learn_tpu_torch.obs; "
            "from sq_learn_tpu_torch.resilience import faults; "
            "print(sq_learn_tpu_torch._knobs.get_bool('SQ_OBS'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_the_port_reads_the_environment_only_through_the_registry():
    raw = re.compile(r"os\.environ|os\.getenv")
    offenders = []
    root = os.path.join(REPO, "sq_learn_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            if not name.endswith(".py") or path.endswith("_knobs.py"):
                continue
            with open(path) as fh:
                if raw.search(fh.read()):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
