"""The port's serving and control-plane contract smokes on the CPU
(``python -m sq_learn_tpu_torch.serving.smoke`` and ``...serving.
control_smoke``, ``--device cpu``), each held against its JAX counterpart
run once per module on the CPU: exit 0, an ``ok`` summary with no error,
an artifact the port's schema validates, the same record types less
those without an object in eager torch, the control smoke's ladder, and
the serving smoke's spill leg: a disk hit in a fresh process with zero
AOT misses after the warm-up."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_smoke_helpers import (assert_ok, record_types,  # noqa: E402
                                  run_jax, run_port, validate)

SMOKES = {
    "serving": ("serving.smoke", "serve_smoke"),
    "control": ("serving.control_smoke", "control_smoke"),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    runs = {}
    for name, (module, key) in SMOKES.items():
        artifact = tmp_path_factory.mktemp(f"port_{name}") / "run.jsonl"
        out, summary = run_port(module, key, artifact)
        runs[name] = (out, summary, artifact)
    return runs


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    runs = {}
    for name, (module, key) in SMOKES.items():
        artifact = tmp_path_factory.mktemp(f"jax_{name}") / "run.jsonl"
        out, summary = run_jax(module, key, artifact)
        assert_ok(out, summary, key)
        runs[name] = summary
    return runs


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_the_port_smoke_holds_its_contract(port, name):
    out, summary, _ = port[name]
    assert_ok(out, summary, SMOKES[name][1])
    assert summary["device"] == "cpu"
    assert summary["launches"] == {"lloyd_step": 0, "argkmin": 0}


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_the_artifact_validates(port, name):
    _, summary, artifact = port[name]
    errors, by_type = validate(artifact)
    assert errors == []
    assert by_type == summary["jsonl"]


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_record_types_equal_the_jax_smokes(port, jax, name):
    assert record_types(port[name][1]) == record_types(jax[name])


def test_the_ladder_equals_the_jax_smokes(port, jax):
    assert port["control"][1]["ladder"] == jax["control"]["ladder"] \
        == ["widen", "host"]


def test_the_banker_relaxes_as_the_jax_smoke_does(port, jax):
    """The relaxed δ and the banked cost follow from the declared
    contract and the relax steps alone."""
    assert port["control"][1]["banker"] == jax["control"]["banker"]


def test_the_spill_leg_serves_a_disk_hit_in_a_fresh_process(port):
    aot = port["serving"][1]["aot"]
    assert aot["spill_probe_disk_hits"] >= 1
    assert aot["spill_probe_misses"] == 0
    assert aot["misses"] == 0 and aot["hits"] > 0


def test_the_served_load_matches_the_jax_smokes(port, jax):
    """The same 40 requests, and the same bytes across the boundary."""
    ours, theirs = port["serving"][1], jax["serving"]
    assert ours["requests"] == theirs["requests"]
    for key in ("requests", "transfer_bytes", "degraded"):
        assert ours["slo"][key] == theirs["slo"][key], key
