"""A run end to end: no card means no result, the result line's shape, the
check for JAX in the process, and the cells on the card."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness


def _cicids_rows(share):
    """The cicids2017 configuration at 1/``share`` of each class's rows."""
    counts = harness.load_cell("cicids2017.delta_sweep")[1]["class_counts"]
    return {"class_counts": {k: max(1, v // share)
                             for k, v in counts.items()}}


#: the sweep's estimator settings at 4 restarts, for a small CPU run
SMALL_FIT = {**harness.load_cell("cicids2017.delta_sweep")[2]["estimator"],
             "n_init": 4}

ROOT = harness.ROOT
SMALL = {
    "mnist784.qmeans": ({"n_samples": 2000}, {}),
    "mnist784.knn": ({"n_samples": 3000},
                     {"train_rows": 2000, "query_rows": 1000}),
    "cicids2017.delta_sweep": (_cicids_rows(400), {"estimator": SMALL_FIT}),
}


def _cli(args, cwd=ROOT, env=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    out = _cli(["--workload", "mnist784.knn", "--seed", str(2**31 + 9),
                "--seconds", "1", "--trace", "0"])
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(["--workload", "mnist784.qmeans", "--seed", "1", "--seconds",
                "1", "--trace", "0"], cwd=tmp_path,
               env={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")


def test_a_cpu_run_prints_the_contract_line():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench import harness\n"
        "r = harness.run('mnist784.knn', 77, 0.5, 0, device='cpu',\n"
        f"    config_overrides={SMALL['mnist784.knn'][0]!r},\n"
        f"    traffic_overrides={SMALL['mnist784.knn'][1]!r})\n"
        "harness.finish(r)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"query_rows_per_s", "predict_p95_ms",
                                    "setup_s"}
    last = out.stderr.strip().splitlines()[-3:]
    assert all(s.startswith("check ") and " limit " in s for s in last)


def test_finish_refuses_a_process_holding_jax(monkeypatch, capsys):
    result = {"correct": True, "checks": {}}
    for name in list(sys.modules):          # a test session may hold JAX
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sq_learn_tpu_torch_extra",
                        types.ModuleType("sq_learn_tpu_torch_extra"))
    harness.finish(result)                  # a longer name is not the package
    assert capsys.readouterr().out.strip() == json.dumps(result)
    for name in ("jax", "jaxlib.xla_client", "flax", "sq_learn_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        with pytest.raises(harness.Forbidden):
            harness.finish(result)
        monkeypatch.delitem(sys.modules, name)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_small_sound_run_is_correct(workload):
    cfg, traffic = SMALL[workload]
    r = harness.run(workload, 2**31 + 17, 0.5, 0, device="cpu",
                    config_overrides=cfg, traffic_overrides=traffic,
                    log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    r = harness.run(workload, 2**31 + 23, 2.0, trace, log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0
        assert all(0 < m["value"] <= 105 for name, m in r["metrics"].items()
                   if m["unit"] == "%" and "idle" not in name)
