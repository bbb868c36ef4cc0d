"""The port's knob registry (``sq_learn_tpu_torch._knobs``) against the JAX
package's, on the CPU: every knob the port registers has the JAX
registry's kind and default (``CUDA_HOME``, torch.distributed's
launcher variables and ``SQ_GPU_PEAK_FLOPS`` aside, which the port alone
reads), the accessors
read the environment as the JAX ones do, the module and ``obs`` import
without torch, and no module of the port reads the environment around
the registry.
"""

import os
import re
import subprocess
import sys

import pytest

from sq_learn_tpu import _knobs as jknobs
from sq_learn_tpu_torch import _knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port alone reads these: the CUDA toolkit, torch.distributed's
#: launcher variables (the JAX package reads JAX_NUM_PROCESSES instead)
#: and the card's peak override (the JAX package's is SQ_TPU_PEAK_FLOPS)
PORT_ONLY = {"CUDA_HOME", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
             "SQ_GPU_PEAK_FLOPS"}


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
    # the elastic world's knobs and obs's fleet envelope
    assert {"SQ_ELASTIC_HEARTBEAT_S", "SQ_ELASTIC_LEASE_S",
            "SQ_ELASTIC_MAX_SHRINKS", "SQ_ELASTIC_WINDOW", "SQ_ELASTIC_PORT",
            "SQ_OBS_FLEET_RUN_ID", "SQ_OBS_FLEET_HOST", "SQ_OBS_FLEET_DIR",
            "SQ_OBS_FLEET_CLOCK_SAMPLES"} <= names
    assert _knobs.get_int("SQ_TRANSFER_CHUNK_BYTES") == 128 * 2 ** 20
    assert [k.name for k in _knobs.iter_knobs()
            if k.scope == "external"] == ["CUDA_HOME", "MASTER_ADDR",
                                          "MASTER_PORT", "RANK",
                                          "WORLD_SIZE"]
    assert all(_knobs.knob(name).anchor.endswith("distributed.py")
               for name in PORT_ONLY - {"CUDA_HOME", "SQ_GPU_PEAK_FLOPS"})


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
    # the static checker (analysis/) names these calls to find them, so
    # the text search skips it; the checker's own knob-registry rule,
    # which parses every module, must find no raw read anywhere
    from sq_learn_tpu_torch.analysis import get_rules, run

    raw = re.compile(r"os\.environ|os\.getenv")
    offenders = []
    root = os.path.join(REPO, "sq_learn_tpu_torch")
    checker = os.path.join(root, "analysis")
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            if (not name.endswith(".py") or path.endswith("_knobs.py")
                    or path.startswith(checker + os.sep)):
                continue
            with open(path) as fh:
                if raw.search(fh.read()):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    findings, errors = run([root], get_rules(["knob-registry"]), root=REPO)
    assert errors == [] and findings == [], [str(f) for f in findings]


def test_environ_copies_for_a_child(monkeypatch):
    """``environ`` hands a child process a copy of the environment with
    overrides (None removes a variable) and leaves this one alone."""
    monkeypatch.setenv("SQ_ELASTIC_LEASE_S", "10")
    monkeypatch.setenv("SQ_OBS_FLEET_HOST", "w9")
    monkeypatch.delenv("SQ_ELASTIC_WINDOW", raising=False)
    env = _knobs.environ(SQ_OBS_FLEET_HOST=None, SQ_ELASTIC_WINDOW=8)
    assert env["SQ_ELASTIC_LEASE_S"] == "10"
    assert env["SQ_ELASTIC_WINDOW"] == "8"
    assert "SQ_OBS_FLEET_HOST" not in env
    assert os.environ["SQ_OBS_FLEET_HOST"] == "w9"
    assert _knobs.get_float("SQ_ELASTIC_LEASE_S") == 10.0
    assert "SQ_ELASTIC_WINDOW" not in os.environ
