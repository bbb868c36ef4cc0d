"""The port's obs readers of the serving plane (``report``, ``budget``,
``control``) and its device-health probe, against the JAX package's, on
the CPU.

- A JAX-written artifact of a serving run (quantized tenants, a burn
  alert, controller decisions, cache traffic, a probe) renders to the same
  text under the port's ``report``, ``budget`` and ``control`` as under
  the JAX package's (the CLI hints name each package's own module), and
  so does a port-written one.
- ``python -m sq_learn_tpu_torch.obs report`` runs with torch blocked.
- The probe under an injected ``probe_timeout`` records a timeout and
  feeds the breaker, as the JAX probe does; its TTL cache answers without
  re-feeding it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import serving as jserving
from sq_learn_tpu.obs import probe as jprobe
from sq_learn_tpu.obs import report as jreport
from sq_learn_tpu.resilience import faults as jfaults
from sq_learn_tpu.resilience.supervisor import breaker as jbreaker
from sq_learn_tpu_torch import obs, serving
from sq_learn_tpu_torch.obs import budget, control, probe, report
from sq_learn_tpu_torch.obs._files import load_jsonl
from sq_learn_tpu_torch.resilience import faults
from sq_learn_tpu_torch.resilience.supervisor import breaker

from _torch_serving_helpers import jax_tenants, request_stream, reset_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return jax_tenants(tmp_path_factory.mktemp("tenants"))


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("SQ_PROBE_CACHE", str(tmp_path / "probe.json"))
    reset_serving()
    yield
    reset_serving()


def _serving_run(pkg, obs_pkg, probe_pkg, tenants, path):
    """A serving run written to ``path``: a q-means tenant with an
    impossible p99 under a static dispatcher (a burn alert), an int8 twin
    with live audits, a controller-planned tenant, repeated transforms
    (cache hits), and one probe."""
    obs_pkg.enable(path)
    reg = (serving.ModelRegistry(device="cpu") if pkg is serving
           else pkg.ModelRegistry())
    reg.controller(patience=1)
    ckpt = tenants["km"][1]
    reg.register("hot", ckpt, quantize=None, slo_p99_ms=1e-6)
    reg.register("q8", ckpt, quantize="int8", slo_p99_ms=1e4)
    reg.register("greedy", ckpt, quantize=None, slo_p99_ms=1e4,
                 slo_eps=0.01, slo_delta=1e-3)
    reg.register("pca", tenants["pca"][1], quantize=None)
    with pkg.MicroBatchDispatcher(reg, background=False, autotune=False,
                                  max_batch_rows=16) as d:
        for X in request_stream(n=24):
            d.submit("hot", "predict", X)
            d.submit("q8", "transform", X)
        d.submit("pca", "transform", X)
        d.submit("pca", "transform", X)
        d.flush()
    with pkg.MicroBatchDispatcher(reg, background=False, autotune=True,
                                  autotune_every=2) as d:
        for X in request_stream(n=12, seed=3):
            d.submit("greedy", "predict", X)
        d.flush()
    probe_pkg.probe_device(platform="cpu")
    obs_pkg.disable()


def _texts(records, paths, capsys):
    """The port's and the JAX package's report text, and their budget and
    control CLI outputs, for the same records."""
    from sq_learn_tpu.obs import budget as jbudget
    from sq_learn_tpu.obs import control as jcontrol

    out = {}
    for name, rep, bud, ctl in (("ours", report, budget, control),
                                ("theirs", jreport, jbudget, jcontrol)):
        text = rep.render(rep.summarize(records))
        capsys.readouterr()
        codes = (bud.main(paths), ctl.main(paths))
        cli = capsys.readouterr().out
        out[name] = (text.replace("sq_learn_tpu_torch", "sq_learn_tpu"),
                     codes, cli)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_render_like_jax(tenants, tmp_path, capsys, writer):
    path = str(tmp_path / "run.jsonl")
    if writer == "jax":
        _serving_run(jserving, jobs, jprobe, tenants, path)
    else:
        _serving_run(serving, obs, probe, tenants, path)
    records = load_jsonl(path)
    by_type = {r["type"] for r in records}
    assert {"slo", "budget", "alert", "control", "probe", "guarantee",
            "counter", "gauge"} <= by_type
    if writer == "port":
        assert obs.schema.validate_jsonl(path)["errors"] == []
    out = _texts(records, [path], capsys)
    assert out["ours"] == out["theirs"]
    text, codes, _ = out["ours"]
    assert codes == (1, 0)  # the static arm's alert burns; control ran
    for section in ("serving SLOs", "tenant error budgets",
                    "effective (eps, delta)", "controller decisions",
                    "probes"):
        assert section in text
    assert "(no slo records)" not in text and "ALERT hot" in text


def test_report_cli_runs_without_torch(tenants, tmp_path):
    path = str(tmp_path / "run.jsonl")
    _serving_run(jserving, jobs, jprobe, tenants, path)
    code = ("import sys; sys.modules['torch'] = None; "
            "from sq_learn_tpu_torch.obs.__main__ import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd, rc in (("report", 0), ("budget", 1), ("control", 0)):
        res = subprocess.run([sys.executable, "-c", code, cmd, path],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == rc, res.stderr
    res = subprocess.run([sys.executable, "-m", "sq_learn_tpu_torch.obs",
                          "report", path], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == jreport.render(jreport.summarize(
        load_jsonl(path))).strip()


def test_probe_timeout_feeds_the_breaker_like_jax():
    outcomes = {}
    for name, pkg, probe_pkg, flt, brk in (
            ("ours", obs, probe, faults, breaker),
            ("theirs", jobs, jprobe, jfaults, jbreaker)):
        rec = pkg.enable()
        flt.arm("probe_timeout:n=1")
        before = brk.consecutive_failures
        first = probe_pkg.probe_device(timeout_s=7, platform="cuda:0",
                                       force=True)
        after = brk.consecutive_failures
        # inside the TTL the answer is cached: no new information, no feed
        second = probe_pkg.probe_device(timeout_s=7, platform="cuda:0")
        flt.disarm()
        pkg.disable()
        assert brk.consecutive_failures == after == before + 1
        outcomes[name] = (first, second,
                          [{k: v for k, v in r.items() if k != "ts"}
                           for r in rec.probe_events],
                          [f["kind"] for f in rec.fault_events])
        brk.reset("test")
    assert outcomes["ours"] == outcomes["theirs"]
    first, second, events, kinds = outcomes["ours"]
    assert first == {"outcome": "timeout", "latency_s": 7.0,
                     "platform": "cuda:0"}
    assert second["cached"] is True and events[1]["cached"] is True
    assert kinds == ["probe_timeout"]
    for r in events:
        assert obs.schema.validate_record(dict(r, ts=1.0)) == []


def test_probe_platforms_and_half_open_trial(monkeypatch):
    assert probe.probe_device(platform="cpu")["outcome"] == "cpu"
    assert probe.probe_device(platform="")["outcome"] == "skipped"
    # a fresh subprocess initializes CUDA: "ok" on a card, "error" here
    import torch

    got = probe.probe_device(timeout_s=120, platform="cuda", force=True)
    assert got["outcome"] == ("ok" if torch.cuda.is_available()
                              else "error")
    breaker.reset("test")
    # the breaker's half-open trial is a forced probe of the device
    from sq_learn_tpu_torch.resilience import supervisor

    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", "0")
    for _ in range(3):
        breaker.record_failure("test")
    faults.arm("probe_timeout:n=1")
    with pytest.raises(supervisor.BreakerOpenError):
        breaker.preflight(site="t", device="cuda:0")
    assert probe.last_probe["outcome"] == "timeout"
    faults.disarm()
    assert breaker.preflight(site="t", device="cpu") == "closed"
    assert probe.last_probe == {"outcome": "cpu", "latency_s": 0.0,
                                "platform": "cpu"}
    assert np.isfinite(got["latency_s"])
