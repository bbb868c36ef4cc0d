"""The port's resilience and out-of-core contract smokes on the CPU
(``python -m sq_learn_tpu_torch.resilience.smoke`` and ``...oocore.
smoke``, ``--device cpu``), each held against its JAX counterpart run
once per module on the CPU: exit 0, an ``ok`` summary with no error, an
artifact the port's schema validates, and the deterministic summary
fields equal to the JAX smoke's (the fault and breaker event counts, and
the record types less those without an object in eager torch)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_smoke_helpers import (assert_ok, record_types,  # noqa: E402
                                  run_jax, run_port, validate)

SMOKES = {
    "resilience": ("resilience.smoke", "faults_smoke"),
    "oocore": ("oocore.smoke", "oocore_smoke"),
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
    # the plain versions run on the CPU: no kernel launch to count
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


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_fault_events_equal_the_jax_smokes(port, jax, name):
    assert port[name][1]["fault_events"] == jax[name]["fault_events"]


def test_breaker_events_equal_the_jax_smoke(port, jax):
    summary = port["resilience"][1]
    assert summary["breaker_events"] == jax["resilience"]["breaker_events"]
    assert summary["breaker_events"] >= 3  # open, half_open, closed


def test_the_oocore_kill_lands_mid_fit_and_the_codec_matches(port, jax):
    summary = port["oocore"][1]
    assert summary["kill_cursor"] >= 1
    assert summary["codec_ratio"] == jax["oocore"]["codec_ratio"]
