"""The port's observability smoke on the CPU (``python -m
sq_learn_tpu_torch.obs.smoke --device cpu``) against the JAX package's
``obs/smoke.py`` run once per module on the CPU: exit 0, an ``ok``
summary with no error, an artifact the port's schema validates, and the
same record types less those without an object in eager torch. Then
every port smoke run with no ``--device`` on a torch without CUDA: a
non-zero exit, CUDA named on stderr, and no artifact."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_smoke_helpers import (assert_ok, record_types,  # noqa: E402
                                  run_jax, run_port, run_smoke, validate)

#: every port smoke, as ``python -m sq_learn_tpu_torch.<module>``
PORT_SMOKES = ("obs.smoke", "resilience.smoke", "oocore.smoke",
               "serving.smoke", "serving.control_smoke",
               "parallel.elastic_smoke")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    artifact = tmp_path_factory.mktemp("port_obs") / "run.jsonl"
    out, summary = run_port("obs.smoke", "obs_smoke", artifact)
    return out, summary, artifact


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    artifact = tmp_path_factory.mktemp("jax_obs") / "run.jsonl"
    out, summary = run_jax("obs.smoke", "obs_smoke", artifact)
    assert_ok(out, summary, "obs_smoke")
    return summary


def test_the_port_smoke_holds_its_contract(port):
    out, summary, _ = port
    assert_ok(out, summary, "obs_smoke")
    assert summary["device"] == "cpu"
    assert summary["launches"] == {"lloyd_step": 0, "argkmin": 0}
    assert summary["budget_tenants"] == ["smoke_tenant"]


def test_the_artifact_validates(port):
    _, summary, artifact = port
    errors, by_type = validate(artifact)
    assert errors == []
    assert by_type == summary["jsonl"]


def test_record_types_equal_the_jax_smokes(port, jax):
    assert record_types(port[1]) == record_types(jax)


def test_the_ledger_and_the_audit_cover_the_jax_smokes_sites(port, jax):
    """The same audited sites, and the same deterministic ledger
    queries; the tomography shots follow from the same (ε, δ)."""
    summary = port[1]
    assert set(summary["audit_sites"]) == set(jax["audit_sites"])
    for name in ("pe_spectrum_queries", "tomography_shots",
                 "classical_cost"):
        assert (summary["ledger_totals"]["queries"][name]
                == jax["ledger_totals"]["queries"][name]), name


@pytest.mark.parametrize("module", PORT_SMOKES)
def test_without_cuda_the_smoke_refuses_and_writes_nothing(tmp_path,
                                                          module):
    artifact = tmp_path / "run.jsonl"
    out, summary = run_smoke("sq_learn_tpu_torch", module, "errors",
                             artifact, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 2, out.stderr[-2000:]
    assert "CUDA" in out.stderr
    assert summary is None
    assert not artifact.exists()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("plane", ("obs", "faults", "oocore", "serve",
                                   "control", "elastic"))
def test_the_default_artifact_is_the_ports_own(tmp_path, monkeypatch,
                                               plane):
    """Without ``SQ_OBS_PATH`` a smoke writes ``sq_<plane>_smoke-torch
    .jsonl`` in the temporary directory (``TMPDIR``), never the JAX smoke's
    ``/tmp/sq_<plane>_smoke.jsonl``; with it, there."""
    import tempfile

    from sq_learn_tpu_torch import _smoke

    monkeypatch.delenv("SQ_OBS_PATH", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert _smoke.artifact_path(plane) == str(
        tmp_path / f"sq_{plane}_smoke-torch.jsonl")
    monkeypatch.setenv("SQ_OBS_PATH", str(tmp_path / "run.jsonl"))
    assert _smoke.artifact_path(plane) == str(tmp_path / "run.jsonl")


def test_the_summary_line_is_the_last_that_carries_its_key():
    from sq_learn_tpu_torch._smoke import summary_line

    stdout = "\n".join(['{"obs_smoke": "fail"}', "not json", "[1]",
                        '{"obs_smoke": "ok", "errors": []}', '{"x": 1}'])
    assert summary_line(stdout, "obs_smoke") == {"obs_smoke": "ok",
                                                 "errors": []}
    assert summary_line(stdout, "serve_smoke") is None
