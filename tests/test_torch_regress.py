"""The port's regression gate (``sq_learn_tpu_torch.obs.regress``) against
the JAX package's (``sq_learn_tpu.obs.regress``), on the CPU.

Identical records go through both ``check_record``s, which must give the
same verdict, reference and tolerance on every gate they share (latency,
accuracy, throughput, total_transfer_bytes, peak_hbm_bytes, vs_baseline),
under the default bands and under ``SQ_REGRESS_TOL_*``/``_SLACK_*``
overrides. The port's own rules are pinned too: no ``compile_count``
gate, history banded only within one ``backend``, the recorder's schema
version, the CLI's exit codes, and a selftest whose injected regression
goes red.
"""

import json
import os
import subprocess
import sys

import pytest

from sq_learn_tpu.obs import regress as jregress
from sq_learn_tpu.obs import schema as jschema
from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.obs import recorder, regress, schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_GATES = ("latency", "accuracy", "throughput", "total_transfer_bytes",
                "peak_hbm_bytes", "vs_baseline")
BACKEND = "torch/cpu"


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _bench_line(value=1.0, metric="m", backend=None, unit="s", **obs_fields):
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": 1.0}
    if backend is not None:
        rec["backend"] = backend
    if obs_fields:
        rec["obs"] = obs_fields
    return rec


def _by_gate(verdicts):
    return {v["gate"]: v for v in verdicts}


# -- the JAX package's cases (tests/test_obs_xla.py's TestRegress), ported --


def test_green_within_bands():
    history = {"m": [_bench_line(1.0, total_transfer_bytes=1 << 20,
                                 peak_hbm_bytes=1 << 24)]}
    verdicts = regress.check_record(
        _bench_line(1.2, total_transfer_bytes=int(1.1 * (1 << 20)),
                    peak_hbm_bytes=1 << 24), history)
    assert {v["gate"] for v in verdicts} == {
        "latency", "total_transfer_bytes", "peak_hbm_bytes"}
    assert all(v["verdict"] == "green" for v in verdicts), verdicts


def test_compile_count_gets_no_verdict():
    """The JAX package's forced-retracing case: its compile_count gate
    goes red; eager torch has no retrace, and the port has no such gate."""
    history = {"m": [_bench_line(1.0, compile_count=3)]}
    leaked = _bench_line(1.0, compile_count=40)
    assert "compile_count" not in _by_gate(
        regress.check_record(leaked, history))
    assert all(v["verdict"] != "red"
               for v in regress.check_record(leaked, history))
    jax_red = [v["gate"] for v in jregress.check_record(leaked, history)
               if v["verdict"] == "red"]
    assert jax_red == ["compile_count"]


def test_inflated_transfer_and_latency_go_red():
    history = {"m": [_bench_line(1.0, total_transfer_bytes=1 << 20)]}
    by_gate = _by_gate(regress.check_record(
        _bench_line(5.0, total_transfer_bytes=10 << 20), history))
    assert by_gate["latency"]["verdict"] == "red"
    assert by_gate["total_transfer_bytes"]["verdict"] == "red"


def test_missing_history_skips_not_passes():
    # history without obs: latency comparable, the obs gates SKIP
    history = {"m": [{"metric": "m", "value": 1.0}]}
    verdicts = regress.check_record(_bench_line(1.0, peak_hbm_bytes=1e12),
                                    history)
    by_gate = _by_gate(verdicts)
    assert by_gate["latency"]["verdict"] == "green"
    assert by_gate["peak_hbm_bytes"]["verdict"] == "skip"
    for v in verdicts:
        assert schema.validate_record(v) == [], v
        assert jschema.validate_record(v) == [], v


def test_check_file_against_repo_history(tmp_path):
    root = tmp_path
    (root / "bench" / "records").mkdir(parents=True)
    (root / "BENCH_r01.json").write_text(json.dumps(
        {"n": 1, "parsed": _bench_line(1.0, total_transfer_bytes=4096)}))
    rec = root / "fresh.txt"
    rec.write_text("# suite run\n"
                   + json.dumps(_bench_line(10.0, total_transfer_bytes=4096))
                   + "\n")
    by_gate = _by_gate(regress.check_file(str(rec), str(root)))
    assert by_gate["latency"]["verdict"] == "red"
    assert by_gate["total_transfer_bytes"]["verdict"] == "green"
    assert by_gate["peak_hbm_bytes"]["verdict"] == "skip"


def test_selftest_contract(capsys):
    assert regress.selftest(device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["regress_selftest"] == "ok"
    assert out["clean"]["total_transfer_bytes"] == "green"
    assert out["leaked"]["total_transfer_bytes"] == "red"
    # the CPU has no device memory to measure: skip, never a silent green
    assert out["clean"]["peak_hbm_bytes"] == "skip"
    assert out["peak_hbm_bytes"] == [None, None, None]
    t = out["total_transfer_bytes"]
    assert t[0] == t[1] == out["bytes"] >= 16 << 20 and t[2] == 2 * t[0]


def test_selftest_takes_the_configured_device(capsys):
    """Without ``--device`` the selftest runs on the configured device, so
    it asks for the card unless the caller asks for the CPU."""
    import torch

    from sq_learn_tpu_torch.obs.__main__ import main

    assert main(["regress", "--selftest"]) == 0  # the fixture's CPU
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["regress_selftest"] == "ok"
    if not torch.cuda.is_available():
        with config_context(device="cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                regress.selftest()


# -- the same verdicts as the JAX package's on every shared gate ----------

_OBS = {"total_transfer_bytes": 1 << 20, "peak_hbm_bytes": 1 << 24}

#: (history values, fresh record): each gate green, red and at its edge
_CASES = {
    "latency green": ([_bench_line(1.0, **_OBS), _bench_line(1.4, **_OBS),
                       _bench_line(0.9, **_OBS)],
                      _bench_line(2.0, **_OBS)),
    "latency red, obs red": (
        [_bench_line(1.0, **_OBS)],
        _bench_line(2.06, total_transfer_bytes=(1 << 21),
                    peak_hbm_bytes=(1 << 25))),
    "obs at the band's edge": (
        [_bench_line(1.0, **_OBS)],
        _bench_line(1.0, total_transfer_bytes=1.25 * (1 << 20) + 4096,
                    peak_hbm_bytes=1.25 * (1 << 24) + (1 << 20))),
    "accuracy green": ([_bench_line(0.95, unit="accuracy"),
                        _bench_line(0.97, unit="accuracy")],
                       _bench_line(0.9, unit="accuracy")),
    "accuracy red": ([_bench_line(0.95, unit="accuracy")],
                     _bench_line(0.83, unit="accuracy")),
    "throughput red": ([_bench_line(8000.0, unit="qps"),
                        _bench_line(7600.0, unit="qps")],
                       _bench_line(3000.0, unit="qps")),
    "throughput green": ([_bench_line(8000.0, unit="qps")],
                         _bench_line(4000.0, unit="qps")),
    "vs_baseline red": ([], dict(_bench_line(1.0), vs_baseline=0.9,
                                 vs_baseline_floor=0.95)),
    "vs_baseline green": ([_bench_line(2.0)],
                          dict(_bench_line(1.0), vs_baseline=0.96,
                               vs_baseline_floor=0.95)),
    "vs_baseline skip": ([], dict(_bench_line(1.0), vs_baseline=None,
                                  vs_baseline_floor=0.95)),
    "no history": ([], _bench_line(1.0, **_OBS)),
}


def _same_as_jax(history, fresh):
    hist = {"m": history}
    ours = _by_gate(regress.check_record(fresh, hist))
    theirs = _by_gate(jregress.check_record(fresh, hist))
    shared = set(ours) & set(SHARED_GATES)
    assert shared == set(theirs) & set(SHARED_GATES) and shared
    for gate in shared:
        for field in ("verdict", "reference", "tolerance", "current",
                      "history_n"):
            assert ours[gate][field] == theirs[gate][field], (gate, field)
    return ours


@pytest.mark.parametrize("case", sorted(_CASES))
def test_check_record_gives_the_jax_verdicts(case):
    history, fresh = _CASES[case]
    ours = _same_as_jax(history, fresh)
    for v in ours.values():
        assert schema.validate_record(v) == [], v
        assert v["v"] == v["schema_version"] == recorder.SCHEMA_VERSION
    gate, expect = case.split()[0], case.split()[-1]
    if expect in ("green", "red", "skip"):
        assert ours[gate]["verdict"] == expect, ours[gate]


def test_edge_of_the_band_is_green():
    ours = _same_as_jax(*_CASES["obs at the band's edge"])
    assert ours["total_transfer_bytes"]["verdict"] == "green"
    assert ours["peak_hbm_bytes"]["verdict"] == "green"


def test_tolerance_table_is_the_jax_packages_less_compile_count():
    shared = {g: t for g, t in jregress.TOLERANCES.items()
              if g != "compile_count"}
    assert regress.TOLERANCES == shared
    assert regress.OBS_GATES == tuple(g for g in jregress.OBS_GATES
                                      if g != "compile_count")


@pytest.mark.parametrize("env,gate,tolerance", [
    ({"SQ_REGRESS_TOL_LATENCY": "3"}, "latency", 3.05),
    ({"SQ_REGRESS_SLACK_LATENCY": "0"}, "latency", 2.0),
    ({"SQ_REGRESS_TOL_TOTAL_TRANSFER_BYTES": "2",
      "SQ_REGRESS_SLACK_TOTAL_TRANSFER_BYTES": "0"},
     "total_transfer_bytes", float(2 << 20)),
    ({"SQ_REGRESS_TOL_PEAK_HBM_BYTES": "1.5"}, "peak_hbm_bytes",
     1.5 * (1 << 24) + (1 << 20)),
    ({"SQ_REGRESS_TOL_ACCURACY": "0.5", "SQ_REGRESS_SLACK_ACCURACY": "0.1"},
     "accuracy", 0.4),
    ({"SQ_REGRESS_TOL_VS_BASELINE": "0.9"}, "vs_baseline", 0.9 * 0.95),
])
def test_env_overrides_band_as_in_jax(monkeypatch, env, gate, tolerance):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    unit = "accuracy" if gate == "accuracy" else "s"
    history = [_bench_line(1.0, unit=unit, **_OBS)]
    fresh = dict(_bench_line(1.0, unit=unit, **_OBS), vs_baseline=0.9,
                 vs_baseline_floor=0.95)
    ours = _same_as_jax(history, fresh)
    assert ours[gate]["tolerance"] == pytest.approx(tolerance)


def test_override_names_resolve_to_the_knob_families():
    from sq_learn_tpu_torch import _knobs

    for gate in regress.TOLERANCES:
        for family in ("SQ_REGRESS_TOL_*", "SQ_REGRESS_SLACK_*"):
            name = family[:-1] + gate.upper()
            assert _knobs.knob(name).name == family
            assert _knobs.knob(name).is_family


# -- the port's own rules ------------------------------------------------


def test_history_is_banded_within_one_backend():
    history = {"m": [_bench_line(1.0, backend="cpu", **_OBS),
                     _bench_line(1.0, backend="tpu", **_OBS),
                     _bench_line(1.0, **_OBS),
                     _bench_line(4.0, backend=BACKEND,
                                 total_transfer_bytes=1 << 22,
                                 peak_hbm_bytes=1 << 26)]}
    fresh = _bench_line(5.0, backend=BACKEND, total_transfer_bytes=1 << 22,
                        peak_hbm_bytes=1 << 26)
    by_gate = _by_gate(regress.check_record(fresh, history))
    # only the torch/cpu line counts: every gate green against it
    assert {v["verdict"] for v in by_gate.values()} == {"green"}
    assert {v["history_n"] for v in by_gate.values()} == {1}
    assert by_gate["latency"]["reference"] == 4.0
    # a backend with no history of its own gets skip, not green
    other = _by_gate(regress.check_record(
        _bench_line(1.0, backend="torch/NVIDIA H100 80GB HBM3", **_OBS),
        history))
    assert {v["verdict"] for v in other.values()} == {"skip"}
    assert {v["history_n"] for v in other.values()} == {0}


def _repo_shaped_root(root):
    """The JAX package's trajectory: BENCH_r*.json lines of a TPU and of
    the CPU, and a suite record without a backend."""
    (root / "bench" / "records").mkdir(parents=True)
    for n, backend in ((1, "tpu"), (2, "cpu")):
        (root / f"BENCH_r0{n}.json").write_text(json.dumps(
            {"n": n, "parsed": _bench_line(0.01, metric="digits",
                                           backend=backend, **_OBS)}))
    (root / "bench" / "records" / "20260731T110505Z_cpu.txt").write_text(
        "# suite run\n" + json.dumps(_bench_line(0.01, metric="digits"))
        + "\n")


def test_a_port_record_skips_against_the_jax_trajectory(tmp_path, capsys):
    _repo_shaped_root(tmp_path)
    fresh = tmp_path / "fresh.txt"
    fresh.write_text(json.dumps(_bench_line(
        5.0, metric="digits", backend=BACKEND,
        total_transfer_bytes=1 << 30, peak_hbm_bytes=1 << 35)) + "\n")
    verdicts = regress.check_file(str(fresh), str(tmp_path))
    assert [v["verdict"] for v in verdicts] == ["skip"] * 3
    # the JAX package's gate bands the same line against its trajectory
    assert "red" in {v["verdict"]
                     for v in jregress.check_file(str(fresh), str(tmp_path))}
    assert regress.main([str(fresh), "--root", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["regression_summary"] == {
        "green": 0, "red": 0, "skip": 3}


def test_a_fresh_file_in_the_records_is_not_its_own_history(tmp_path):
    records = tmp_path / "bench" / "records"
    records.mkdir(parents=True)
    (records / "old.txt").write_text(json.dumps(
        _bench_line(1.0, backend=BACKEND, **_OBS)) + "\n")
    fresh = records / "new.txt"
    fresh.write_text(json.dumps(_bench_line(
        3.0, backend=BACKEND, **_OBS)) + "\n")
    by_gate = _by_gate(regress.check_file(str(fresh), str(tmp_path)))
    assert by_gate["latency"]["verdict"] == "red"
    assert by_gate["latency"]["history_n"] == 1


def test_cli_exit_codes(tmp_path, capsys):
    from sq_learn_tpu_torch.obs.__main__ import main

    records = tmp_path / "bench" / "records"
    records.mkdir(parents=True)
    (records / "old.txt").write_text(json.dumps(
        _bench_line(1.0, backend=BACKEND, **_OBS)) + "\n")
    green, red = tmp_path / "green.txt", tmp_path / "red.txt"
    green.write_text(json.dumps(_bench_line(1.1, backend=BACKEND, **_OBS)))
    red.write_text(json.dumps(_bench_line(9.0, backend=BACKEND, **_OBS)))
    root = ["--root", str(tmp_path)]
    assert main(["regress", str(green), *root]) == 0
    assert main(["regress", str(red), *root]) == 1
    assert main(["regress", str(red), *root, "--no-exit-code"]) == 0
    assert main(["regress"]) == 2
    assert main(["regress", "--root"]) == 2
    assert main(["regress", str(red), "--device", "cpu"]) == 2
    assert main(["regress", "--selftest", str(red)]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["regression_summary"] == {
        "green": 2, "red": 1, "skip": 0}


def test_cli_bands_without_torch(tmp_path):
    records = tmp_path / "bench" / "records"
    records.mkdir(parents=True)
    (records / "old.txt").write_text(json.dumps(
        _bench_line(1.0, backend=BACKEND, **_OBS)) + "\n")
    red = tmp_path / "red.txt"
    red.write_text(json.dumps(_bench_line(9.0, backend=BACKEND, **_OBS)))
    code = ("import sys; sys.modules['torch'] = None; "
            "from sq_learn_tpu_torch.obs.__main__ import main; "
            f"sys.exit(main(['regress', {str(red)!r}, '--root', "
            f"{str(tmp_path)!r}]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    verdicts = [json.loads(ln) for ln in out.stdout.splitlines()[:-1]]
    assert [v["gate"] for v in verdicts if v["verdict"] == "red"] == [
        "latency"]


def test_schema_version_is_the_recorders():
    assert regress.SCHEMA_VERSION == recorder.SCHEMA_VERSION
    # the JAX module pins 9 while its recorder writes 11 (ROADMAP.md §3)
    from sq_learn_tpu.obs import recorder as jrecorder

    assert jregress.SCHEMA_VERSION == 9 != jrecorder.SCHEMA_VERSION


def test_verdicts_render_in_the_report_and_the_trace(tmp_path, capsys):
    from sq_learn_tpu_torch.obs.__main__ import main

    history = {"m": [_bench_line(1.0, **_OBS)]}
    path = tmp_path / "verdicts.jsonl"
    with open(path, "w") as fh:
        for v in regress.check_record(_bench_line(5.0, **_OBS), history):
            fh.write(json.dumps(v) + "\n")
    assert obs.schema.validate_jsonl(str(path))["errors"] == []
    capsys.readouterr()
    assert main(["report", str(path)]) == 0
    text = capsys.readouterr().out
    assert "regression latency [m] -> red" in text
    assert "regression peak_hbm_bytes [m] -> green" in text
    out = tmp_path / "trace.json"
    assert main(["trace", str(path), "-o", str(out)]) == 0
    names = {e.get("name") for e in json.loads(out.read_text())[
        "traceEvents"]}
    assert "regress latency:red" in names


def test_snapshot_peak_is_none_without_cuda():
    obs.enable()
    try:
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert "peak_hbm_bytes" in snap and snap["peak_hbm_bytes"] is None
