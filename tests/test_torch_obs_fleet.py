"""The port's fleet observability (``sq_learn_tpu_torch.obs.fleet``, the
recorder's fleet envelope) on the CPU — the classes of
``tests/test_obs_fleet.py`` on the port, and parity with the JAX package.

The contract: per-process obs shards correlated by the coordinator-minted
``fleet.run_id`` envelope merge into ONE clock-aligned timeline —
NTP-style offsets from the ``clock`` samples the elastic world piggybacks
on its store exchanges, a monotone ``ts_fleet`` merge, each generation's
detect → shrink → re-init → resume path, and a commit-ledger
reconciliation that proves every committed window appears exactly once.
Parity: the JAX package's ``obs.fleet.summarize`` and the port's, over
the same shard files, are JSON-equal, and the same records validate under
both schemas. Shards of a real multi-process run:
``tests/test_torch_elastic_world.py``.
"""

import gzip
import json
import os

import numpy as np
import pytest

from sq_learn_tpu.obs import fleet as jax_fleet
from sq_learn_tpu.obs import schema as jax_schema
from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.obs import fleet, report, schema
from sq_learn_tpu_torch.obs import recorder as obs_recorder
from sq_learn_tpu_torch.obs.recorder import Recorder
from sq_learn_tpu_torch.oocore import ArraySource
from sq_learn_tpu_torch.parallel import elastic
from sq_learn_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


V = schema.SCHEMA_VERSION


def _rec(type_, ts, **kw):
    rec = {"v": V, "schema_version": V, "ts": ts, "type": type_}
    rec.update(kw)
    return rec


def _clock(ts, peer, sent, recv, **kw):
    return _rec("clock", ts, peer=peer, sent_ts=sent, recv_ts=recv, **kw)


def _el(ts, event, gen, **kw):
    kw.setdefault("n_hosts", 2)
    return _rec("elastic", ts, event=event, generation=gen, **kw)


def _write_shard(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return str(path)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


class TestClockOffsets:
    def test_reference_host_is_zero(self):
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)])]
        assert fleet.clock_offsets(shards) == {"coord": 0.0}

    def test_one_way_bound(self):
        # w1's clock reads 0.5 s ahead of coord's (message can only age
        # in flight, so recv − sent upper-bounds the offset)
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)]),
                  ("w1", [_clock(1.0, "coord", 100.0, 100.5)])]
        offs = fleet.clock_offsets(shards)
        assert offs["coord"] == 0.0
        assert offs["w1"] == pytest.approx(0.5)

    def test_min_over_samples_is_tightest(self):
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)]),
                  ("w1", [_clock(1.0, "coord", 100.0, 100.9),
                          _clock(2.0, "coord", 200.0, 200.5)])]
        assert fleet.clock_offsets(shards)["w1"] == pytest.approx(0.5)

    def test_two_way_midpoint_cancels_delay(self):
        # w0 → coord bound: +2.0; coord → w0 bound: −1.5; the midpoint
        # (2.0 − (−1.5)) / 2 = 1.75 cancels the symmetric delay part
        shards = [("coord", [_clock(1.0, "w0", 200.0, 198.5)]),
                  ("w0", [_clock(1.0, "coord", 100.0, 102.0)])]
        assert fleet.clock_offsets(shards)["w0"] == pytest.approx(1.75)

    def test_bfs_propagates_through_intermediate_host(self):
        # w2 only ever exchanged samples with w1 — its offset composes
        # w1's coord-relative offset with the w2−w1 pair estimate
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)]),
                  ("w1", [_clock(1.0, "coord", 100.0, 100.5)]),
                  ("w2", [_clock(1.0, "w1", 50.0, 50.2)])]
        offs = fleet.clock_offsets(shards)
        assert offs["w1"] == pytest.approx(0.5)
        assert offs["w2"] == pytest.approx(0.7)

    def test_unreachable_host_defaults_to_zero(self):
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)]),
                  ("w9", [_rec("gauge", 1.0, name="g", value=1)])]
        assert fleet.clock_offsets(shards)["w9"] == 0.0

    def test_reference_override(self):
        shards = [("coord", [_rec("gauge", 1.0, name="g", value=1)]),
                  ("w1", [_clock(1.0, "coord", 100.0, 100.5)])]
        offs = fleet.clock_offsets(shards, reference="w1")
        assert offs["w1"] == 0.0
        assert offs["coord"] == pytest.approx(-0.5)


class TestMerge:
    def test_aligned_merge_is_monotone(self):
        # raw timestamps interleave the wrong way; after subtracting
        # w0's +1.0 s offset the fleet order is causal
        shards = [("coord", [_rec("gauge", 1.0, name="a", value=1),
                             _rec("gauge", 3.0, name="c", value=1)]),
                  ("w0", [_rec("gauge", 2.5, name="b", value=1)])]
        merged = fleet.merge(shards, offsets={"coord": 0.0, "w0": 1.0})
        assert [r["name"] for r in merged] == ["a", "b", "c"]
        assert [r["_host"] for r in merged] == ["coord", "w0", "coord"]
        ts = [r["ts_fleet"] for r in merged]
        assert ts == sorted(ts)
        assert merged[1]["ts_fleet"] == pytest.approx(1.5)

    def test_tie_breaks_by_host_then_file_order(self):
        shards = [("w1", [_rec("gauge", 5.0, name="x", value=1),
                          _rec("gauge", 5.0, name="y", value=1)]),
                  ("w0", [_rec("gauge", 5.0, name="z", value=1)])]
        merged = fleet.merge(shards, offsets={})
        assert [(r["_host"], r["name"]) for r in merged] == \
            [("w0", "z"), ("w1", "x"), ("w1", "y")]

    def test_records_without_numeric_ts_dropped(self):
        shards = [("w0", [{"type": "gauge", "name": "g"},
                          _rec("gauge", 1.0, name="h", value=1)])]
        merged = fleet.merge(shards, offsets={})
        assert [r["name"] for r in merged] == ["h"]

    def test_source_records_not_mutated(self):
        rec = _rec("gauge", 1.0, name="g", value=1)
        fleet.merge([("w0", [rec])], offsets={"w0": 0.5})
        assert "_host" not in rec and "ts_fleet" not in rec


class TestCriticalPath:
    def _merged(self):
        recs = [_el(10.0, "host_fail", 0, detect_s=0.7, failed_host=2),
                _el(10.1, "host_fail", 0, detect_s=0.4, failed_host=2),
                _el(10.5, "shrink", 1),
                _el(11.0, "world_up", 1),
                _el(11.2, "resume", 1, cursor=8),
                _el(12.0, "done", 1)]
        return fleet.merge([("w0", recs)], offsets={"w0": 0.0})

    def test_segments_hand_math(self):
        paths = fleet.critical_path(self._merged())
        assert len(paths) == 1
        p = paths[0]
        assert p["generation"] == 1
        # slowest surviving host's own lease-layer measurement
        assert p["detect_s"] == pytest.approx(0.7)
        assert p["shrink_s"] == pytest.approx(0.5)
        assert p["reinit_s"] == pytest.approx(0.5)
        assert p["resume_s"] == pytest.approx(0.2)
        assert p["finish_s"] == pytest.approx(0.8)
        assert p["total_s"] == pytest.approx(2.0)

    def test_missing_anchor_segments_are_none(self):
        recs = [_el(10.0, "host_fail", 0, detect_s=0.7),
                _el(11.0, "world_up", 1)]
        p = fleet.critical_path(fleet.merge([("w0", recs)], offsets={}))[0]
        assert p["resume_s"] is None
        assert p["finish_s"] is None
        assert p["total_s"] is None
        assert p["detect_s"] == pytest.approx(0.7)

    def test_no_shrink_means_no_paths(self):
        recs = [_el(1.0, "world_up", 0), _el(5.0, "done", 0)]
        assert fleet.critical_path(
            fleet.merge([("w0", recs)], offsets={})) == []


class TestReconcile:
    def _commits(self, windows):
        return fleet.merge(
            [("coord", [_el(float(i), "commit", 1, window=w, cursor=w)
                        for i, w in enumerate(windows)])], offsets={})

    def test_each_window_exactly_once_is_ok(self):
        r = fleet.reconcile(self._commits([0, 1, 2]))
        assert r["ok"] and r["windows"] == 3 and r["committed"] == 3
        assert r["duplicates"] == [] and r["gaps"] == []
        assert r["max_cursor"] == 2

    def test_duplicate_commit_flagged(self):
        r = fleet.reconcile(self._commits([0, 1, 1]))
        assert not r["ok"]
        assert r["duplicates"] == [1]

    def test_gap_flagged(self):
        r = fleet.reconcile(self._commits([0, 2]))
        assert not r["ok"]
        assert r["gaps"] == [1]

    def test_vacuously_ok_without_commits(self):
        r = fleet.reconcile([])
        assert r["ok"] and r["windows"] == 0 and r["max_cursor"] is None


class TestLoadShards:
    def test_envelope_wins_filename_falls_back(self, tmp_path):
        env = {"run_id": "r1", "host": "workerA", "pid": 1, "gen": 0}
        _write_shard(tmp_path / "obs.w0.jsonl",
                     [_rec("gauge", 1.0, name="g", value=1, fleet=env)])
        _write_shard(tmp_path / "obs.zz.jsonl",
                     [_rec("gauge", 1.0, name="g", value=1)])
        hosts = [h for h, _ in fleet.load_shards(str(tmp_path))]
        assert hosts == ["workerA", "zz"]

    def test_coordinator_sorts_first_and_empty_dropped(self, tmp_path):
        env = {"run_id": "r1", "host": "coord", "pid": 1, "gen": 0}
        _write_shard(tmp_path / "obs.w0.jsonl",
                     [_rec("gauge", 1.0, name="g", value=1)])
        _write_shard(tmp_path / "obs.zcoord.jsonl",
                     [_rec("gauge", 1.0, name="g", value=1, fleet=env)])
        _write_shard(tmp_path / "obs.empty.jsonl", [])
        hosts = [h for h, _ in fleet.load_shards(str(tmp_path))]
        assert hosts == ["coord", "w0"]

    def test_gzipped_shard_loads(self, tmp_path):
        p = tmp_path / "obs.w3.jsonl.gz"
        with gzip.open(p, "wt") as f:
            f.write(json.dumps(_rec("gauge", 1.0, name="g", value=1)) + "\n")
        shards = fleet.load_shards([str(p)])
        assert [h for h, _ in shards] == ["w3"]
        assert shards[0][1][0]["name"] == "g"

    def test_run_ids_collected(self, tmp_path):
        env = {"run_id": "elastic-ab12", "host": "w0", "pid": 1, "gen": 0}
        _write_shard(tmp_path / "obs.w0.jsonl",
                     [_rec("gauge", 1.0, name="g", value=1, fleet=env)])
        assert fleet.run_ids(fleet.load_shards(str(tmp_path))) == \
            ["elastic-ab12"]


class TestRecorderFleetEnvelope:
    def test_envelope_stamped_on_every_record(self, tmp_path,
                                              monkeypatch):
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        path = str(tmp_path / "obs.h0.jsonl")
        rec = Recorder(path, run_id="r-42", host="h0")
        rec.record(_rec("gauge", 1.0, name="g", value=1))
        rec.fleet_generation = 2
        rec.record(_rec("gauge", 2.0, name="g", value=2))
        rec.close()
        lines = [json.loads(ln) for ln in open(path)]
        # meta + two gauges, every one carrying the envelope
        assert lines[0]["type"] == "meta"
        for ln in lines:
            assert ln["fleet"]["run_id"] == "r-42"
            assert ln["fleet"]["host"] == "h0"
            assert ln["fleet"]["pid"] == os.getpid()
            assert not schema.validate_record(ln)
        assert lines[1]["fleet"]["gen"] is None
        assert lines[2]["fleet"]["gen"] == 2

    def test_no_envelope_without_run_id(self, tmp_path, monkeypatch):
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        path = str(tmp_path / "obs.jsonl")
        rec = Recorder(path)
        rec.record(_rec("gauge", 1.0, name="g", value=1))
        rec.close()
        lines = [json.loads(ln) for ln in open(path)]
        assert all("fleet" not in ln for ln in lines)

    def test_set_fleet_and_generation_adopt_active(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        path = str(tmp_path / "obs.sim.jsonl")
        obs.enable(path)
        try:
            obs_recorder.set_fleet("r-sim", host="sim")
            obs_recorder.set_generation(3)
            obs_recorder.get_recorder().record(
                _rec("gauge", 1.0, name="g", value=1))
            assert obs_recorder.flush(fsync=True) is True
        finally:
            obs.disable()
        gauge = [json.loads(ln) for ln in open(path)
                 if json.loads(ln)["type"] == "gauge"]
        assert gauge[0]["fleet"] == {"run_id": "r-sim", "host": "sim",
                                     "pid": os.getpid(), "gen": 3}

    def test_flush_without_sink_is_false(self):
        rec = Recorder()
        assert rec.flush(fsync=True) is False

    def test_flush_without_active_recorder_is_false(self):
        obs.disable()
        assert obs_recorder.flush(fsync=True) is False
        assert obs_recorder.set_fleet("r") is None
        assert obs_recorder.set_generation(1) is None

    def test_fleet_dir_shards_the_sink_per_host(self, tmp_path):
        """``SQ_OBS=1`` with ``SQ_OBS_FLEET_DIR`` and no ``SQ_OBS_PATH``:
        the process's sink is ``<dir>/obs.<host>.jsonl``, every record
        enveloped — what the fleet loader globs."""
        import subprocess
        import sys

        from sq_learn_tpu_torch import _knobs

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = ("from sq_learn_tpu_torch import obs; "
                "obs.gauge('g', 1.0); obs.disable()")
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=str(tmp_path),
            capture_output=True, text=True, timeout=120,
            env=_knobs.environ(PYTHONPATH=repo, SQ_OBS="1", SQ_OBS_PATH=None,
                               SQ_OBS_FLEET_DIR=str(tmp_path / "fleet"),
                               SQ_OBS_FLEET_HOST="h7",
                               SQ_OBS_FLEET_RUN_ID="r-dir",
                               SQ_OBS_TRACE=None))
        assert out.returncode == 0, out.stderr
        shards = fleet.load_shards(str(tmp_path / "fleet"))
        assert [h for h, _ in shards] == ["h7"]
        records = shards[0][1]
        assert [r["type"] for r in records] == ["meta", "gauge"]
        assert all(r["fleet"]["run_id"] == "r-dir" for r in records)
        assert fleet.run_ids(shards) == ["r-dir"]

    def test_private_recorder_beside_the_global_one(self, tmp_path,
                                                    monkeypatch):
        """The elastic coordinator's private recorder stamps its own
        identity and leaves the process's recorder alone."""
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        glob = obs.enable(str(tmp_path / "obs.main.jsonl"))
        try:
            coord = Recorder(str(tmp_path / "obs.coord.jsonl"),
                             run_id="r-c", host="coord")
            elastic._emit("shrink", 1, 2, rec=coord, failed_host=0)
            coord.close()
            assert glob.fleet_run_id is None and not glob.elastic_records
            assert [e["event"] for e in coord.elastic_records] == ["shrink"]
        finally:
            obs.disable()
        shards = fleet.load_shards(str(tmp_path))
        assert [h for h, _ in shards] == ["coord", "main"]


def _fleet_run_dir(tmp_path):
    """Hand-built 3-process shards of one run spanning generations
    0 → 1: coordinator ledger (windows 0–3, window 2 recommitted by the
    shrunk world after w1 dies mid-window), per-worker fold progress,
    and two-way clock samples. w1's shard ends mid-window — SIGKILL."""
    env = {"run_id": "r-e2e", "pid": 1, "gen": 0}

    def fl(host, gen=0):
        return dict(env, host=host, gen=gen)

    # true offsets: w0 clock = coord + 10.3, w1 clock = coord + 19.5;
    # each direction's sample carries 0.1 s of in-flight delay, which
    # the two-way midpoints cancel exactly
    coord = [
        _rec("meta", 0.0, pid=1, schema=V, fleet=fl("coord")),
        _clock(0.2, "w0", 10.4, 0.2, via="manifest", fleet=fl("coord")),
        _clock(0.2, "w1", 19.6, 0.2, via="manifest", fleet=fl("coord")),
        _el(0.5, "world_up", 0, n_hosts=2, fleet=fl("coord")),
        _el(1.0, "commit", 0, window=0, cursor=0, fleet=fl("coord")),
        _el(2.0, "commit", 0, window=1, cursor=1, fleet=fl("coord")),
        _el(3.0, "host_fail", 0, detect_s=0.6, failed_host=1,
            fleet=fl("coord")),
        _el(3.4, "shrink", 1, fleet=fl("coord")),
        _el(4.0, "world_up", 1, n_hosts=1, fleet=fl("coord", 1)),
        _el(4.2, "resume", 1, cursor=1, fleet=fl("coord", 1)),
        _el(5.0, "commit", 1, window=2, cursor=2, fleet=fl("coord", 1)),
        _el(6.0, "commit", 1, window=3, cursor=3, fleet=fl("coord", 1)),
        _el(6.5, "done", 1, fleet=fl("coord", 1)),
    ]
    w0 = [
        _rec("meta", 10.3, pid=2, schema=V, fleet=fl("w0")),
        _clock(10.5, "coord", 0.1, 10.5, via="hb", fleet=fl("w0")),
        _el(10.9, "window", 0, window=0, fleet=fl("w0")),
        _el(11.9, "window", 0, window=1, fleet=fl("w0")),
        _el(14.9, "window", 1, window=2, fleet=fl("w0", 1)),
        _el(15.9, "window", 1, window=3, fleet=fl("w0", 1)),
    ]
    w1 = [
        _rec("meta", 19.6, pid=3, schema=V, fleet=fl("w1")),
        _clock(19.7, "coord", 0.1, 19.7, via="hb", fleet=fl("w1")),
        _el(20.2, "window", 0, window=0, fleet=fl("w1")),
        # killed mid-window 2: progress recorded, commit never issued
        _el(22.1, "window", 0, window=2, fleet=fl("w1")),
    ]
    run = tmp_path / "run"
    run.mkdir()
    _write_shard(run / "obs.coord.jsonl", coord)
    _write_shard(run / "obs.w0.jsonl", w0)
    _write_shard(run / "obs.w1.jsonl", w1)
    return run


class TestFleetEndToEnd:
    def test_summarize_multi_host_two_generations(self, tmp_path):
        run = _fleet_run_dir(tmp_path)
        s = fleet.summarize(str(run))
        assert s["run_ids"] == ["r-e2e"]
        assert sorted(s["hosts"]) == ["coord", "w0", "w1"]
        assert s["generations"] == [0, 1]
        # clock alignment: w0 ≈ +10.3 s, w1 ≈ +19.5 s vs coord
        offs = s["clock_offsets_s"]
        assert offs["coord"] == 0.0
        assert offs["w0"] == pytest.approx(10.3, abs=1e-6)
        assert offs["w1"] == pytest.approx(19.5, abs=1e-6)
        # ledger: 4 windows, the voided one recommitted exactly once
        recon = s["reconciliation"]
        assert recon["ok"] and recon["windows"] == 4
        assert recon["duplicates"] == [] and recon["gaps"] == []
        # gen-1 shrink critical path fully decomposed
        cp = [p for p in s["critical_path"] if p["generation"] == 1]
        assert len(cp) == 1
        assert cp[0]["detect_s"] == pytest.approx(0.6)
        assert cp[0]["total_s"] == pytest.approx(3.5)
        # the dead worker's pre-kill progress is in the rollups
        assert s["rollups"]["w1"]["by_type"]["elastic"] == 2
        txt = fleet.render(s)
        assert "r-e2e" in txt and "w1" in txt

    def test_merged_artifact_monotone_and_schema_valid(self, tmp_path):
        run = _fleet_run_dir(tmp_path)
        shards = fleet.load_shards(str(run))
        out = str(tmp_path / "merged.jsonl")
        fleet.write_merged(shards, out)
        summary = schema.validate_jsonl(out)
        assert summary["errors"] == []
        merged = [json.loads(ln) for ln in open(out)]
        n_records = sum(len(recs) for _, recs in shards)
        assert len(merged) == n_records
        ts = [r["ts_fleet"] for r in merged]
        assert ts == sorted(ts)
        assert {r["_host"] for r in merged} == {"coord", "w0", "w1"}

    def test_cli_json_trace_and_exit_codes(self, tmp_path, capsys):
        run = _fleet_run_dir(tmp_path)
        trace = tmp_path / "trace.json"
        merged = tmp_path / "m.jsonl"
        rc = fleet.main([str(run), "--json", "-o", str(trace),
                         "--merged", str(merged)])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert out["run_ids"] == ["r-e2e"]
        assert trace.exists() and merged.exists()
        tr = json.loads(trace.read_text())
        events = tr["traceEvents"] if isinstance(tr, dict) else tr
        assert events

    def test_cli_exit_1_on_broken_ledger(self, tmp_path):
        run = tmp_path / "run"
        run.mkdir()
        _write_shard(run / "obs.coord.jsonl",
                     [_el(1.0, "commit", 0, window=0, cursor=0),
                      _el(2.0, "commit", 0, window=0, cursor=0)])
        assert fleet.main([str(run)]) == 1

    def test_cli_exit_2_without_shards(self, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        assert fleet.main([str(empty)]) == 2

    def test_sim_shard_reconciles_through_fleet(self, tmp_path,
                                                monkeypatch):
        # the in-process elastic sim, shrunk mid-epoch, must produce a
        # shard whose ledger reconciles and whose gen-1 path decomposes
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        path = str(tmp_path / "obs.sim.jsonl")
        obs.enable(path)
        try:
            obs_recorder.set_fleet("r-sim", host="sim")
            rng = np.random.default_rng(5)
            x = np.asarray(rng.normal(size=(230, 7)), np.float64)
            src = ArraySource(x, shard_rows=16)  # 15 shards
            faults.arm("host_fail:window=1,host=0,times=1")
            elastic.elastic_fit_local(src, 3, n_hosts=3, seed=1,
                                      epochs=1, window=4)
        finally:
            faults.disarm()
            obs.disable()
        s = fleet.summarize([(h, r) for h, r in
                             fleet.load_shards(str(path))])
        assert s["run_ids"] == ["r-sim"]
        assert len(s["generations"]) >= 2
        recon = s["reconciliation"]
        assert recon["ok"]
        assert recon["windows"] == 4  # ceil(15 / 4) windows, 1 epoch


class TestReportFleetSection:
    def test_summary_counts_envelope_and_ledger(self, tmp_path):
        run = _fleet_run_dir(tmp_path)
        records = [r for _, recs in fleet.load_shards(str(run))
                   for r in recs]
        s = report.summarize(records)
        fl = s["fleet"]
        assert fl["run_ids"] == ["r-e2e"]
        assert fl["hosts"] == {"coord": 13, "w0": 6, "w1": 4}
        assert fl["generations"] == [0, 1]
        assert fl["commits"] == 4
        assert fl["windows"] == 6
        assert fl["clock_samples"] == 4
        txt = report.render(s)
        assert "fleet (cross-process correlation)" in txt
        assert "r-e2e" in txt

    def test_section_silent_without_fleet_records(self):
        s = report.summarize([_rec("gauge", 1.0, name="g", value=1)])
        assert s["fleet"]["run_ids"] == []
        assert "fleet (cross-process correlation)" not in report.render(s)


class TestJaxParity:
    def test_summaries_json_equal(self, tmp_path):
        run = _fleet_run_dir(tmp_path)
        ours, theirs = fleet.summarize(str(run)), jax_fleet.summarize(
            str(run))
        assert json.dumps(ours, sort_keys=True) == json.dumps(
            theirs, sort_keys=True)
        assert fleet.render(ours) == jax_fleet.render(theirs)

    def test_sim_shard_summaries_json_equal(self, tmp_path, monkeypatch):
        monkeypatch.delenv("SQ_OBS_FLEET_RUN_ID", raising=False)
        path = str(tmp_path / "obs.sim.jsonl")
        obs.enable(path)
        try:
            obs_recorder.set_fleet("r-sim", host="sim")
            src = ArraySource(
                np.random.default_rng(5).normal(size=(230, 7)),
                shard_rows=16)
            faults.arm("host_fail:window=1,host=0,times=1")
            elastic.elastic_fit_local(src, 3, n_hosts=3, seed=1, epochs=1,
                                      window=4)
        finally:
            faults.disarm()
            obs.disable()
        ours, theirs = fleet.summarize(path), jax_fleet.summarize(path)
        assert json.dumps(ours, sort_keys=True) == json.dumps(
            theirs, sort_keys=True)

    def test_fixture_records_validate_in_both_schemas(self, tmp_path):
        run = _fleet_run_dir(tmp_path)
        for _, records in fleet.load_shards(str(run)):
            for rec in records:
                assert schema.validate_record(rec) == []
                assert jax_schema.validate_record(rec) == []
        merged = str(tmp_path / "merged.jsonl")
        fleet.write_merged(fleet.load_shards(str(run)), merged)
        assert schema.validate_jsonl(merged) == jax_schema.validate_jsonl(
            merged)

    def test_cli_exit_codes_equal_jax(self, tmp_path, capsys):
        run = _fleet_run_dir(tmp_path)
        broken = tmp_path / "broken"
        broken.mkdir()
        _write_shard(broken / "obs.coord.jsonl",
                     [_el(1.0, "commit", 0, window=0, cursor=0),
                      _el(2.0, "commit", 0, window=2, cursor=2)])
        empty = tmp_path / "none"
        empty.mkdir()
        for args in ([str(run)], [str(run), "--json"], [str(broken)],
                     [str(empty)], []):
            assert fleet.main(args) == jax_fleet.main(args), args
        capsys.readouterr()
