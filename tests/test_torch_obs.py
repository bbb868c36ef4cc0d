"""The port's ``obs`` (recorder, ledger, guarantee auditor, frontier,
schema, CLI) against the JAX package's, on the CPU.

- The auditor's and the frontier's math equals the JAX package's on the
  same inputs: the Clopper–Pearson bound to 1e-12 on a grid, ``audit``,
  ``collect``, ``pareto`` and ``render`` exactly, the ≤ 64-draw subsample
  index for index, the ledger's shot and query counts exactly.
- A batch of tensor draws records what the JAX package records for the
  same draws as numpy.
- An artifact the port writes validates under both packages' schema with
  0 errors, and the JAX package's ``audit`` and ``frontier`` CLIs read it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sq_learn_tpu import obs as jax_obs
from sq_learn_tpu.obs import guarantees as jax_guarantees
from sq_learn_tpu_torch import QKMeans, config_context, obs
from sq_learn_tpu_torch.obs import guarantees
from sq_learn_tpu_torch.obs._files import load_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield
    obs.disable()


def _records():
    """Guarantee and tradeoff records exercising every branch of the
    aggregation: violations, short-circuits, sites without a declared
    failure probability, ties and undominated points."""
    rng = np.random.default_rng(0)
    recs = []
    for i in range(40):
        recs.append({"type": "guarantee", "site": "a", "realized": 0.1,
                     "tol": 0.2, "violated": i % 7 == 0,
                     "fail_prob": 0.05 if i % 2 else 0.1})
    for i in range(12):
        recs.append({"type": "guarantee", "site": "b", "realized": 0.0,
                     "tol": 0.0, "violated": False, "fail_prob": 0.0,
                     "short_circuit": True})
    recs.append({"type": "guarantee", "site": "c", "realized": 1.0,
                 "tol": 0.5, "violated": True, "fail_prob": None})
    for i in range(9):
        recs.append({"type": "guarantee", "site": "d", "realized": 2.0,
                     "tol": 1.0, "violated": True, "fail_prob": 0.0})
    for sweep in ("s1", "s2"):
        for p in (0.0, 0.1, 0.5, 1.0, 2.0):
            recs.append({
                "type": "tradeoff", "sweep": sweep, "point": p,
                "accuracy": float(rng.uniform()),
                "q_runtime": None if p == 0 else float(rng.uniform(1, 1e9)),
                "c_runtime": 1e6, "wall_s": 0.5,
                "accuracy_metric": "ari"})
    recs.append({"type": "tradeoff", "sweep": "s1", "point": 3.0,
                 "accuracy": recs[-1]["accuracy"], "q_runtime": 5.0,
                 "c_runtime": None})
    recs.append({"type": "span", "name": "x"})
    return recs


@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_clopper_pearson_lower_equals_the_jax_packages(confidence):
    for trials in (1, 2, 5, 17, 64, 200):
        for violations in sorted({0, 1, trials // 3, trials - 1, trials}):
            a = guarantees.clopper_pearson_lower(violations, trials,
                                                 confidence)
            b = jax_guarantees.clopper_pearson_lower(violations, trials,
                                                     confidence)
            assert a == pytest.approx(b, abs=1e-12)
    with pytest.raises(ValueError):
        guarantees.clopper_pearson_lower(3, 2)


def test_audit_and_render_equal_the_jax_packages():
    recs = _records()
    for confidence in (0.9, 0.95):
        ours = guarantees.audit(recs, confidence)
        assert ours == jax_guarantees.audit(recs, confidence)
        assert guarantees.render(ours) == jax_guarantees.render(ours)
    flagged = sorted(s for s, a in guarantees.audit(recs).items()
                     if a["flagged"])
    assert flagged == ["d"]
    assert guarantees.render({}) == jax_guarantees.render({})


def test_collect_pareto_and_render_equal_the_jax_packages():
    recs = _records()
    sweeps = obs.frontier.collect(recs)
    assert sweeps == jax_obs.frontier.collect(recs)
    for pts in sweeps.values():
        pts = sorted(pts, key=lambda p: p["point"])
        assert obs.frontier.pareto(pts) == jax_obs.frontier.pareto(pts)
    assert obs.frontier.render(sweeps) == jax_obs.frontier.render(sweeps)
    assert obs.frontier.render({}) == jax_obs.frontier.render({})


@pytest.mark.parametrize("n", [1, 63, 64, 65, 70_000])
def test_subsample_equals_the_jax_packages(n):
    assert guarantees._subsample(n) == jax_guarantees._subsample(n)
    assert len(guarantees._subsample(n)) == min(n, 64)
    # the same indices, made on the device of the draws
    assert guarantees._subsample_on(n, "cpu").tolist() == \
        jax_guarantees._subsample(n)


def test_ledger_counts_equal_the_jax_packages():
    for d in (2, 16, 61, 784, 70_000):
        for delta in (0.0, 0.1, 0.4, 1.6):
            for norm in ("L2", "inf"):
                for k in (0, 1, 30):
                    assert obs.ledger.tomography_shot_count(
                        k, d, delta, norm) == jax_obs.ledger.\
                        tomography_shot_count(k, d, delta, norm)
    for s, it in ((61, 1), (784, 7), (8, 30)):
        assert obs.ledger.phase_estimation_queries(s, it) == \
            jax_obs.ledger.phase_estimation_queries(s, it)


def test_tensor_draws_record_what_the_jax_package_records_for_numpy():
    errs = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 0.3, 1000))
    tols = torch.full((1000,), 0.25, dtype=torch.float64)
    recs = {}
    for name, module, e, t in (("port", obs, errs, tols),
                               ("jax", jax_obs, errs.numpy(), tols.numpy())):
        module.enable()
        module.guarantees.observe("s", e, t, fail_prob=0.1, estimator="x")
        module.guarantees.observe("s", e[:10], 0.25, fail_prob=0.1)
        recs[name] = module.disable().guarantee_records
    strip = [{k: v for k, v in r.items() if k != "ts"} for r in recs["port"]]
    assert strip == [{k: v for k, v in r.items() if k != "ts"}
                     for r in recs["jax"]]
    assert len(strip) == 74 and strip[0]["n_total"] == 1000


def test_strict_audit_raises_on_a_broken_contract(monkeypatch):
    monkeypatch.setenv("SQ_OBS_AUDIT_STRICT", "1")
    obs.enable()
    # one draw over tolerance is consistent with a 0.5 failure probability
    guarantees.record_guarantee("s", 1.0, 0.5, fail_prob=0.5)
    with pytest.raises(guarantees.GuaranteeViolationError, match="'t'"):
        guarantees.record_guarantee("t", 1.0, 0.5, fail_prob=0.0)


def test_spans_nest_and_sync():
    obs.enable()
    with obs.span("outer", n=1) as outer:
        with obs.span("inner") as inner:
            x = inner.sync(torch.ones(3))
        outer.set(done=True)
    rec = obs.disable()
    inner_rec, outer_rec = rec.spans
    assert (inner_rec["name"], inner_rec["depth"]) == ("inner", 1)
    assert inner_rec["parent"] == outer_rec["seq"]
    assert inner_rec["synced"] and not outer_rec["synced"]
    assert outer_rec["attrs"] == {"n": 1, "done": True}
    assert x.shape == (3,)


def _write_artifact(path):
    """A port artifact with a record of every type the port writes."""
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(300, 6)) + np.repeat(np.eye(6)[:3] * 8, 100,
                                                axis=0)).astype(np.float32)
    obs.enable(str(path))
    est = QKMeans(n_clusters=3, n_init=2, delta=0.5, random_state=0,
                  true_distance_estimate=False).fit(X)
    obs.counter_add("c", 2)
    obs.gauge("g", 1.5, unit="s")
    obs.record_span("external", 0.25, k=1)
    # a shard store's reads: the storage ledger's io records, flushed at
    # disable
    from sq_learn_tpu_torch.oocore import store_from_array

    store_from_array(str(path) + ".store", X,
                     shard_bytes=2048).read_rows(0, X.shape[0])
    # a fault injection and the breaker transitions it feeds
    from sq_learn_tpu_torch.resilience import faults, supervisor

    faults.arm("put_fail:tiles=0,times=1")
    breaker = supervisor.CircuitBreaker()
    try:
        faults.get_plan().on_put(0)
    except faults.InjectedTransferError:
        breaker.record_failure("InjectedTransferError")
    finally:
        faults.disarm()
    for _ in range(2):  # SQ_BREAKER_K = 3 consecutive failures trip it
        breaker.record_failure("InjectedTransferError")
    breaker.reset()
    # a serving run: a tenant with an impossible p99 (slo, budget and
    # alert records at close), its controller plan, and one probe
    from sq_learn_tpu_torch import serving
    from sq_learn_tpu_torch.obs import probe

    reg = serving.ModelRegistry(device="cpu")
    reg.controller()
    reg.register("t", est, quantize=None, slo_p99_ms=1e-6)
    with serving.MicroBatchDispatcher(reg, background=False,
                                      autotune=False) as d:
        d.serve("t", "predict", X[:4])
    probe.probe_device(platform="cpu")
    # the elastic world's records: the simulator's transitions across a
    # shrink, and one clock sample
    from sq_learn_tpu_torch.oocore import ArraySource
    from sq_learn_tpu_torch.parallel import elastic

    faults.arm("host_fail:window=1,host=0,times=1")
    try:
        elastic.elastic_fit_local(ArraySource(X, shard_rows=64), 3,
                                  n_hosts=2, seed=0, window=2,
                                  device="cpu")
    finally:
        faults.disarm()
    elastic._emit_clock("w1", 100.0, 100.25, 0, "hb")
    quantum, classical = est.quantum_runtime_model(*X.shape)
    for delta in (0.0, 0.5):
        obs.frontier.record_tradeoff(
            "qkmeans_delta", delta, accuracy=0.9 + delta / 10,
            accuracy_metric="ari",
            q_runtime=None if delta == 0 else float(quantum.ravel()[0]),
            c_runtime=float(classical), wall_s=0.1, budget={"delta": delta})
    snap = obs.snapshot()
    obs.disable()
    return snap


def test_artifact_validates_under_both_schemas(tmp_path):
    from sq_learn_tpu.obs import schema as jax_schema

    path = tmp_path / "run.jsonl"
    snap = _write_artifact(path)
    ours = obs.schema.validate_jsonl(str(path))
    theirs = jax_schema.validate_jsonl(str(path))
    assert ours["errors"] == [] and theirs["errors"] == []
    assert ours == theirs
    assert set(ours["by_type"]) == set(obs.schema.RECORD_TYPES)
    assert snap["guarantee_records"] > 0 and snap["audit_flagged"] == []
    first = json.loads(path.read_text().splitlines()[0])
    assert first["type"] == "meta" and first["schema"] == 11
    assert first["v"] == first["schema_version"] == 11


def test_schema_rejects_types_the_port_does_not_write():
    base = {"v": 11, "schema_version": 11, "ts": 1.0}
    errors = obs.schema.validate_record(dict(base, type="watchdog"))
    assert len(errors) == 1 and "'watchdog'" in errors[0]
    assert obs.schema.validate_record(dict(base, type="span"))
    assert "unknown schema version" in obs.schema.validate_record(
        {"v": 12, "schema_version": 12, "ts": 1.0, "type": "meta",
         "pid": 1, "schema": 12})[0]
    assert obs.schema.validate_jsonl("/nonexistent.jsonl")["errors"]


def _cli(package, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", f"{package}.obs", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_both_packages_clis_read_the_ports_artifact(tmp_path):
    path = tmp_path / "run.jsonl"
    _write_artifact(path)
    records = load_jsonl(str(path))
    table = obs.frontier.render(obs.frontier.collect(records))
    audit = guarantees.render(guarantees.audit(records))
    for package in ("sq_learn_tpu", "sq_learn_tpu_torch"):
        front = _cli(package, "frontier", str(path))
        assert front.returncode == 0, front.stderr
        assert front.stdout.splitlines()[1:1 + len(table.splitlines())] == \
            table.splitlines()
        aud = _cli(package, "audit", str(path))
        assert aud.returncode == 0, aud.stderr
        assert aud.stdout.splitlines()[1:-1] == audit.splitlines()
        assert aud.stdout.splitlines()[-1] == "flagged: none"
    # the JAX package's in-process readers agree
    assert jax_obs.frontier.main([str(path), "--json"]) == 0
    assert jax_guarantees.main([str(path)]) == 0


def test_cli_reads_an_artifact_without_torch(tmp_path):
    """The CLI is a file tool: with torch blocked, importing the package
    and running ``frontier`` and ``audit`` still work."""
    path = tmp_path / "run.jsonl"
    _write_artifact(path)
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from sq_learn_tpu_torch.obs.__main__ import main\n"
            "assert main(['frontier', sys.argv[1]]) == 0\n"
            "assert main(['audit', sys.argv[1]]) == 0\n")
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "frontier:" in out.stdout and "flagged: none" in out.stdout


def test_cli_usage_and_later_subcommands(tmp_path, capsys):
    """``trace``, ``storage``, ``report``, ``budget``, ``control`` and
    ``fleet`` run now (their own tests are ``tests/test_torch_obs_trace.py``,
    ``tests/test_torch_obs_storage.py``, ``tests/test_torch_obs_report.py``,
    ``tests/test_torch_obs_budget.py`` and ``tests/test_torch_obs_fleet.py``);
    ``regress`` (the port's benchmark) raises, naming its ROADMAP item."""
    from sq_learn_tpu_torch.obs.__main__ import main

    assert main([]) == 2
    assert main(["nope"]) == 2
    assert guarantees.main([]) == 2 and obs.frontier.main([]) == 2
    for cmd in ("report", "budget", "control", "fleet"):
        assert main([cmd]) == 2  # usage: no artifact named
    assert main(["fleet", str(tmp_path)]) == 2  # no obs shard there
    with pytest.raises(NotImplementedError,
                       match="the port's benchmark") as err:
        main(["regress", str(tmp_path)])
    assert "ROADMAP.md" in str(err.value)
    empty = tmp_path / "empty.jsonl"
    obs.enable(str(empty))
    obs.disable()
    assert obs.frontier.main([str(empty)]) == 1  # no trade-off stated
    assert main(["storage", str(empty)]) == 2  # no io record
    assert main(["trace", str(empty), "-o", str(tmp_path / "t.json")]) == 0
    assert main(["report", str(empty)]) == 0
    assert main(["budget", str(empty)]) == 2  # no budget telemetry
    assert main(["control", str(empty)]) == 2  # no control telemetry
    path = tmp_path / "run.jsonl"
    _write_artifact(path)
    capsys.readouterr()
    assert main(["storage", str(path)]) == 0
    assert "storage-plane ledger" in capsys.readouterr().out


def test_sq_obs_enables_at_import(tmp_path):
    path = tmp_path / "auto.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO, SQ_OBS="1",
               SQ_OBS_PATH=str(path))
    code = ("from sq_learn_tpu_torch import obs\n"
            "assert obs.enabled()\n"
            "with obs.span('auto'):\n"
            "    pass\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    types = [json.loads(line)["type"]
             for line in path.read_text().splitlines()]
    assert types == ["meta", "span"]
