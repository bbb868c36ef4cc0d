"""The port's Chrome-trace renderer (``sq_learn_tpu_torch.obs.trace``) and
the ``trace`` subcommand, against the JAX package's.

Both renderers turn the same JSONL into the same trace-event dict (equal
dicts, no tolerance) when the JAX package wrote the file; for the port's,
whose spans carry their start on the profiler's clock (``start_ns``), the
same events with each span at that start, within a millisecond of where
the JAX renderer puts it (the close stamp less the length). The CLI
writes valid trace JSON and runs without torch; ``SQ_OBS_TRACE`` renders
a run when it closes; several files merge onto pid lanes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import oocore as joo
from sq_learn_tpu.obs import trace as jtrace
from sq_learn_tpu_torch import obs, oocore
from sq_learn_tpu_torch.obs import trace
from sq_learn_tpu_torch.resilience import faults, supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _hygiene():
    supervisor.breaker.reset("test setup")
    yield
    supervisor.breaker.reset("test teardown")
    faults.disarm()
    if obs.enabled():
        obs.disable()
    if jobs.enabled():
        jobs.disable()


def _run(package, tmp_path, name):
    """A small obs run of ``package`` (either obs module with its oocore):
    spans, counters, a gauge, a fault and per-shard io records."""
    obs_mod, ooc = (obs, oocore) if package == "port" else (jobs, joo)
    path = str(tmp_path / f"{name}.jsonl")
    obs_mod.enable(path)
    X = np.arange(48 * 8, dtype=np.float32).reshape(48, 8)
    store = ooc.store_from_array(str(tmp_path / f"{name}_store"), X,
                                 shard_bytes=512)
    with obs_mod.span("outer", n=3):
        with obs_mod.span("inner"):
            obs_mod.counter_add("c", 2)
    obs_mod.gauge("g", 1.5, site="x")
    obs_mod.gauge("text_gauge", "not a number")
    fault_mod = faults if package == "port" else \
        __import__("sq_learn_tpu.resilience.faults", fromlist=["arm"])
    fault_mod.arm("read_fail:tiles=1,times=1")
    try:
        for i in range(store.n_shards):
            store.read_shard(i)
    finally:
        fault_mod.disarm()
    obs_mod.disable()
    return path


def _assert_same_trace(ours, theirs):
    """Equal traces, but that the port places each span carrying a
    ``start_ns`` there: within 1 ms of the JAX renderer's start."""
    def key(e):
        return json.dumps(e, sort_keys=True)

    def placed(doc):
        out, starts = [], {}
        for e in doc["traceEvents"]:
            if e.get("cat") == "span" and "start_ns" in e["args"]:
                starts[(e["pid"], e["args"]["seq"])] = (
                    e["ts"], e["args"]["start_ns"])
                e = {k: v for k, v in e.items() if k != "ts"}
            out.append(e)
        return sorted(out, key=key), starts

    (a, starts), (b, jstarts) = placed(ours), placed(theirs)
    assert a == b
    assert starts.keys() == jstarts.keys()
    for span, (ts, start_ns) in starts.items():
        assert ts == start_ns / 1e3
        assert abs(ts - jstarts[span][0]) <= 1e3, span
    return starts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_renderers_agree_on_an_artifact(tmp_path, writer):
    path = _run(writer, tmp_path, writer)
    records = trace.load_jsonl(path)
    assert records == jtrace.load_jsonl(path)
    ours = trace.to_chrome_trace([("run", records)])
    starts = _assert_same_trace(ours,
                                jtrace.to_chrome_trace([("run", records)]))
    assert bool(starts) == (writer == "port")
    names = {e["name"] for e in ours["traceEvents"]}
    assert {"outer", "inner", "c", "g", "fault:read_fail"} <= names
    assert "text_gauge" not in names  # no counter track for a string
    assert any(e.get("cat") == "io" for e in ours["traceEvents"])
    lanes = {e["args"]["name"] for e in ours["traceEvents"]
             if e["name"] == "thread_name"}
    assert {"spans", "faults", "storage io"} <= lanes
    inner = next(e for e in ours["traceEvents"] if e["name"] == "inner")
    outer = next(e for e in ours["traceEvents"] if e["name"] == "outer")
    # a span's start is its close stamp (1 ms resolution) less its length
    assert outer["ts"] - 1e3 <= inner["ts"] and inner["dur"] <= outer["dur"]


def test_files_merge_onto_pid_lanes(tmp_path):
    a, b = _run("port", tmp_path, "a"), _run("jax", tmp_path, "b")
    out = str(tmp_path / "merged.json")
    doc = trace.write_trace([a, b], out)
    assert _assert_same_trace(doc, jtrace.to_chrome_trace(
        [(os.path.basename(p), jtrace.load_jsonl(p)) for p in (a, b)]))
    with open(out) as fh:
        assert json.load(fh) == doc
    procs = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert len({e["pid"] for e in procs}) >= 2
    # a file without a meta line gets a synthetic pid; bad lines skip
    bare = tmp_path / "bare.jsonl"
    bare.write_text('not json\n{"type": "span", "name": "s", "ts": 1.0, '
                    '"dur_s": 0.5}\n[1, 2]\n')
    one = trace.to_chrome_trace([("bare", trace.load_jsonl(str(bare)))])
    span = next(e for e in one["traceEvents"] if e["name"] == "s")
    assert span["pid"] == 100000 and span["dur"] == 0.5e6


def test_cli_writes_valid_trace_json(tmp_path, capsys):
    from sq_learn_tpu_torch.obs.__main__ import main

    path = _run("port", tmp_path, "cli")
    assert main(["trace", path]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["trace"] == path + ".trace.json" and line["sources"] == 1
    with open(line["trace"]) as fh:
        doc = json.load(fh)
    assert len(doc["traceEvents"]) == line["events"]
    assert doc["displayTimeUnit"] == "ms"
    out = str(tmp_path / "o.json")
    assert main(["trace", path, "-o", out]) == 0 and os.path.exists(out)
    assert trace.main([]) == 2


def test_sq_obs_trace_renders_on_disable(tmp_path, monkeypatch):
    out = str(tmp_path / "auto.trace.json")
    monkeypatch.setenv("SQ_OBS_TRACE", out)
    path = str(tmp_path / "run.jsonl")
    obs.enable(path)
    with obs.span("work"):
        obs.counter_add("n", 1)
    obs.disable()
    with open(out) as fh:
        doc = json.load(fh)
    assert any(e["name"] == "work" for e in doc["traceEvents"])
    # an in-memory run has no sink to render: nothing is written
    os.remove(out)
    obs.enable(None)
    obs.disable()
    assert not os.path.exists(out)


def test_gzipped_artifacts_render(tmp_path):
    import gzip

    path = _run("port", tmp_path, "gz")
    gz = path + ".gz"
    with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    assert trace.load_jsonl(gz) == trace.load_jsonl(path)


def test_trace_cli_runs_without_torch(tmp_path):
    path = _run("port", tmp_path, "notorch")
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from sq_learn_tpu_torch.obs.__main__ import main\n"
            "sys.exit(main(['trace', sys.argv[1], '-o', sys.argv[2]]))\n")
    out = str(tmp_path / "t.json")
    done = subprocess.run([sys.executable, "-c", code, path, out], cwd=REPO,
                          env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    with open(out) as fh:
        assert json.load(fh)["traceEvents"]
