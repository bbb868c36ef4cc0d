"""The port's elastic world (``sq_learn_tpu_torch.parallel.elastic``), its
pure core in one process, on the CPU — the classes of
``tests/test_elastic.py`` on the port, and parity with the JAX package.

The contract: the window-synchronous fold's state is a pure function of
(data, seed, k, epochs, window), never of the host count, so a fit that
loses a host, shrinks and resumes from the committed checkpoint is
bit-equal to an uninterrupted run, and the per-shard fold ledger proves no
shard lost or folded twice. Against the JAX package on the same
``ArraySource`` (230 × 7, ``shard_rows=16``): ``init_centers`` picks the
same rows; ``shard_partial`` gives equal counts and labels, and sums and
inertia within rtol 1e-12 (the port sums a one-hot float64 product where
the JAX package's ``np.add.at`` adds row by row); ``elastic_fit_local``
gives equal counts and ``folds``, and centers and inertia within rtol
1e-10, at 1, 2 and 3 hosts. Real processes: ``tests/test_torch_elastic_
world.py``.
"""

import json
import os

import numpy as np
import pytest

from sq_learn_tpu.obs import schema as jax_schema
from sq_learn_tpu.oocore import ArraySource as JaxArraySource
from sq_learn_tpu.parallel import elastic as jax_elastic
from sq_learn_tpu.resilience import faults as jax_faults
from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.obs import schema
from sq_learn_tpu_torch.oocore import ArraySource, EpochPlan
from sq_learn_tpu_torch.parallel import elastic
from sq_learn_tpu_torch.parallel.elastic import (HostFailure,
                                                 StaleGenerationError)
from sq_learn_tpu_torch.resilience import faults
from sq_learn_tpu_torch.resilience.faults import FaultSpecError

RNG = np.random.default_rng(19)
X = np.asarray(RNG.normal(size=(230, 7)), np.float64)
SUMS_RTOL = 1e-12
FIT_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture()
def src():
    return ArraySource(X, shard_rows=16)  # 15 shards, ragged tail


@pytest.fixture()
def jax_src():
    return JaxArraySource(X, shard_rows=16)


@pytest.fixture()
def recorder(tmp_path):
    rec = obs.enable(str(tmp_path / "obs.jsonl"))
    yield rec
    obs.disable()


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


class TestHostPartition:
    def test_disjoint_and_complete(self, src):
        plan = EpochPlan(seed=3)
        for epoch in (0, 1):
            order = plan.shard_order(src, epoch)
            for n_hosts in (1, 2, 3, 5, src.n_shards + 2):
                parts = [plan.host_partition(src, epoch, n_hosts, h)
                         for h in range(n_hosts)]
                seen = {}
                for h, part in enumerate(parts):
                    for p, s in part:
                        assert p not in seen, f"position {p} owned twice"
                        seen[p] = (h, s)
                assert sorted(seen) == list(range(len(order)))
                for p, (h, s) in seen.items():
                    assert h == p % n_hosts
                    assert s == int(order[p])

    def test_start_pos_and_shrink_repartition(self, src):
        plan = EpochPlan(seed=3)
        full = plan.host_partition(src, 0, 2, 1)
        assert plan.host_partition(src, 0, 2, 1, start_pos=6) == [
            (p, s) for p, s in full if p >= 6]
        cursor = 7
        positions = sorted(p for h in range(2) for p, _ in
                           plan.host_partition(src, 0, 2, h,
                                               start_pos=cursor))
        assert positions == list(range(cursor, src.n_shards))

    def test_validation(self, src):
        plan = EpochPlan(seed=0)
        with pytest.raises(ValueError, match="n_hosts"):
            plan.host_partition(src, 0, 0, 0)
        with pytest.raises(ValueError, match="host_id"):
            plan.host_partition(src, 0, 2, 2)


class TestJaxParity:
    def test_init_centers_same_rows(self, src, jax_src):
        for k, seed in ((4, 7), (3, 1), (10, 0)):
            np.testing.assert_array_equal(
                elastic.init_centers(src, k, seed),
                jax_elastic.init_centers(jax_src, k, seed))

    @pytest.mark.parametrize("shard", [0, 7, 14])
    def test_shard_partial(self, src, jax_src, shard):
        C = elastic.init_centers(src, 4, 7)
        counts, sums, inertia, labels = elastic.shard_partial(
            C, src.read_shard(shard), return_labels=True)
        jc, js, ji = jax_elastic.shard_partial(C, jax_src.read_shard(shard))
        rows = np.asarray(jax_src.read_shard(shard), np.float64)
        d2 = ((rows[:, None, :] - C[None]) ** 2).sum(axis=2)
        np.testing.assert_array_equal(labels, np.argmin(d2, axis=1))
        np.testing.assert_array_equal(counts, jc)
        np.testing.assert_allclose(sums, js, rtol=SUMS_RTOL, atol=0)
        assert inertia == pytest.approx(ji, rel=SUMS_RTOL, abs=0)

    def test_shard_partial_of_a_block_boundary(self):
        """More rows than one 1024-row block: the block loop's sums."""
        rows = np.random.default_rng(3).normal(size=(2500, 5))
        C = rows[:6]
        counts, sums, inertia = elastic.shard_partial(C, rows)
        jc, js, ji = jax_elastic.shard_partial(C, rows)
        np.testing.assert_array_equal(counts, jc)
        np.testing.assert_allclose(sums, js, rtol=SUMS_RTOL, atol=1e-12)
        assert inertia == pytest.approx(ji, rel=SUMS_RTOL, abs=0)

    @pytest.mark.parametrize("n_hosts", [1, 2, 3])
    def test_elastic_fit_local(self, src, jax_src, n_hosts):
        ours = elastic.elastic_fit_local(src, 4, n_hosts=n_hosts, seed=7,
                                         epochs=2, window=4)
        theirs = jax_elastic.elastic_fit_local(jax_src, 4, n_hosts=n_hosts,
                                               seed=7, epochs=2, window=4)
        np.testing.assert_array_equal(ours["counts"], theirs["counts"])
        np.testing.assert_array_equal(ours["folds"], theirs["folds"])
        np.testing.assert_allclose(ours["centers"], theirs["centers"],
                                   rtol=FIT_RTOL, atol=0)
        assert ours["inertia"] == pytest.approx(theirs["inertia"],
                                                rel=FIT_RTOL, abs=0)
        for key in ("generation", "n_hosts", "shrinks"):
            assert ours[key] == theirs[key]

    def test_injected_death_matches_jax(self, src, jax_src):
        spec = "host_fail:window=5,host=1,times=1"
        faults.arm(spec)
        ours = elastic.elastic_fit_local(src, 4, n_hosts=3, seed=7,
                                         epochs=2, window=4)
        jax_faults.arm(spec)
        theirs = jax_elastic.elastic_fit_local(jax_src, 4, n_hosts=3,
                                               seed=7, epochs=2, window=4)
        assert (ours["generation"], ours["n_hosts"], ours["shrinks"]) == (
            theirs["generation"], theirs["n_hosts"], theirs["shrinks"]) \
            == (1, 2, 1)
        np.testing.assert_array_equal(ours["counts"], theirs["counts"])
        np.testing.assert_allclose(ours["centers"], theirs["centers"],
                                   rtol=FIT_RTOL, atol=0)

    def test_fingerprints_equal_jax(self, src, jax_src):
        base = elastic.base_fingerprint(src, 4, 7, 2, 4)
        assert base == jax_elastic.base_fingerprint(jax_src, 4, 7, 2, 4)
        assert elastic.commit_fingerprint(base, 3) == \
            jax_elastic.commit_fingerprint(base, 3)
        for epoch, w_lo in ((0, 0), (0, 8), (1, 12)):
            assert elastic._window_index(epoch, w_lo, 15, 4) == \
                jax_elastic._window_index(epoch, w_lo, 15, 4)

    def test_partial_bytes_read_by_jax(self):
        prt = (np.arange(3.0), np.ones((3, 2)), 1.25)
        raw = elastic._pack_partial(*prt)
        for got in (elastic._unpack_partial(raw),
                    jax_elastic._unpack_partial(raw)):
            np.testing.assert_array_equal(got[0], prt[0])
            np.testing.assert_array_equal(got[1], prt[1])
            assert got[2] == prt[2]


class TestLocalSimParity:
    def test_topology_invariance(self, src):
        runs = [elastic.elastic_fit_local(src, 4, n_hosts=n, seed=7,
                                          epochs=2, window=4)
                for n in (1, 2, 3, 4)]
        ref = runs[0]
        assert (ref["folds"] == 2).all()
        for r in runs[1:]:
            np.testing.assert_array_equal(ref["centers"], r["centers"])
            np.testing.assert_array_equal(ref["counts"], r["counts"])
            assert ref["inertia"] == r["inertia"]

    def test_injected_death_is_bit_invisible(self, src):
        ref = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7,
                                        epochs=2, window=4)
        faults.arm("host_fail:window=3,host=1,times=1")
        r = elastic.elastic_fit_local(src, 4, n_hosts=3, seed=7,
                                      epochs=2, window=4)
        assert r["shrinks"] == 1 and r["generation"] == 1
        assert r["n_hosts"] == 2
        np.testing.assert_array_equal(ref["centers"], r["centers"])
        np.testing.assert_array_equal(ref["counts"], r["counts"])
        assert (r["folds"] == 2).all()

    def test_stall_is_recorded_not_fatal(self, src, recorder):
        ref = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7,
                                        epochs=1, window=4)
        faults.arm("host_stall:window=1,host=0,times=1,s=0.0")
        r = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7,
                                      epochs=1, window=4)
        assert r["shrinks"] == 0
        np.testing.assert_array_equal(ref["centers"], r["centers"])
        assert any(e["event"] == "host_stall"
                   for e in recorder.elastic_records)

    def test_budget_exhaustion_raises(self, src):
        faults.arm("host_fail:window=0,host=0,times=1;"
                   "host_fail:window=1,host=1,times=1")
        with pytest.raises(HostFailure, match="budget exhausted"):
            elastic.elastic_fit_local(src, 4, n_hosts=3, seed=7,
                                      epochs=1, window=4, max_shrinks=1)

    def test_last_host_death_raises(self, src):
        faults.arm("host_fail:window=0,host=0,times=1")
        with pytest.raises(HostFailure):
            elastic.elastic_fit_local(src, 4, n_hosts=1, seed=7,
                                      epochs=1, window=4, max_shrinks=5)

    def test_ckpt_resume_across_generations(self, src, tmp_path):
        ref = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7,
                                        epochs=2, window=4)
        ck = str(tmp_path / "ck.npz")
        faults.arm("host_fail:window=2,host=2,times=1")
        r = elastic.elastic_fit_local(src, 4, n_hosts=3, seed=7,
                                      epochs=2, window=4, ckpt_path=ck)
        assert r["generation"] == 1
        np.testing.assert_array_equal(ref["centers"], r["centers"])
        # a fresh process of the surviving world resumes the COMMITTED
        # checkpoint and finishes identically (at once: cursor == total)
        rr = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7,
                                       epochs=2, window=4, ckpt_path=ck,
                                       generation=1)
        np.testing.assert_array_equal(ref["centers"], rr["centers"])
        np.testing.assert_array_equal(ref["counts"], rr["counts"])

    def test_window_from_the_knob(self, src, monkeypatch):
        monkeypatch.setenv("SQ_ELASTIC_WINDOW", "4")
        a = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7, epochs=1)
        b = elastic.elastic_fit_local(src, 4, n_hosts=2, seed=7, epochs=1,
                                      window=4)
        np.testing.assert_array_equal(a["centers"], b["centers"])

    def test_emits_timeline(self, src, recorder):
        faults.arm("host_fail:window=1,host=0,times=1")
        elastic.elastic_fit_local(src, 3, n_hosts=3, seed=1, epochs=1,
                                  window=4)
        events = [e["event"] for e in recorder.elastic_records]
        for needed in ("world_up", "resume", "host_fail", "shrink",
                       "done"):
            assert needed in events, (needed, events)
        gens = {e["generation"] for e in recorder.elastic_records}
        assert gens == {0, 1}
        snap = obs.snapshot()
        assert snap["elastic_records"] == len(recorder.elastic_records)
        assert snap["elastic_host_failures"] == 1
        assert snap["elastic_generation"] == 1


class TestFaultGrammar:
    def test_unarmed_is_none(self):
        assert faults.get_plan() is None
        assert faults._active is None  # the single-attribute hot read

    def test_host_filter_spends_no_countdown_on_other_hosts(self):
        plan = faults.arm("host_fail:window=0,host=2,times=1")
        for _ in range(5):
            assert plan.host_event(0, 0) is None
            assert plan.host_event(0, 1) is None
        assert plan.host_event(0, 2) == ("fail", 0.0)
        assert plan.host_event(0, 2) is None  # times=1 spent

    def test_stall_carries_duration(self):
        plan = faults.arm("host_stall:window=2,host=1,times=1,s=0.125")
        assert plan.host_event(2, 1) == ("stall", 0.125)
        assert plan.events[-1]["kind"] == "host_stall"
        assert plan.events[-1]["host"] == 1
        assert plan.events[-1]["stall_s"] == 0.125

    def test_untargeted_clause_hits_any_host(self):
        plan = faults.arm("host_fail:window=1,times=1")
        assert plan.host_event(1, 4) == ("fail", 0.0)
        assert plan.host_event(1, 0) is None  # countdown spent globally

    def test_same_events_as_jax(self):
        spec = ("host_stall:window=0,host=0,times=2,s=0.0;"
                "host_fail:window=2,host=1,times=1")
        ours, theirs = faults.arm(spec), jax_faults.arm(spec)
        for w in range(4):
            for h in range(3):
                assert ours.host_event(w, h) == theirs.host_event(w, h)
        assert [dict(e) for e in ours.events] == [
            dict(e) for e in theirs.events]

    def test_bad_param_refused(self):
        with pytest.raises(FaultSpecError):
            faults.arm("host_fail:bogus=1")


class TestGenerations:
    def test_commit_fingerprint_is_generation_scoped(self, src):
        base = elastic.base_fingerprint(src, 4, 7, 2, 4)
        assert "n_hosts" not in base  # topology-free by design
        f0 = elastic.commit_fingerprint(base, 0)
        f1 = elastic.commit_fingerprint(base, 1)
        assert f0 != f1 and f0.startswith(base) and f1.startswith(base)

    def test_load_state_walks_generations_down(self, src, tmp_path):
        from sq_learn_tpu_torch.utils.checkpoint import save_stream_state

        base = elastic.base_fingerprint(src, 3, 1, 1, 4)
        tmpl = elastic.new_state(3, X.shape[1], src.n_shards,
                                 np.zeros((3, X.shape[1])))
        st = elastic.new_state(3, X.shape[1], src.n_shards,
                               elastic.init_centers(src, 3, 1))
        ck = str(tmp_path / "ck.npz")
        save_stream_state(ck, st, 5, elastic.commit_fingerprint(base, 1))
        # a generation-3 survivor accepts an ancestor's (g1) commit
        loaded = elastic.load_state(ck, tmpl, base, 3)
        assert loaded is not None and loaded[1] == 5
        np.testing.assert_array_equal(loaded[0]["centers"],
                                      st["centers"])
        # a generation-0 (stale) worker never resumes past its world
        assert elastic.load_state(ck, tmpl, base, 0) is None
        assert elastic.load_state(None, tmpl, base, 3) is None

    def test_stale_commit_refused(self, tmp_path, recorder):
        run_dir = str(tmp_path)
        with open(os.path.join(run_dir, "manifest.g2.json"), "w") as fh:
            json.dump({"generation": 2, "port": 1, "members": [0, 1]}, fh)
        elastic.check_commit_generation(run_dir, 2)  # live gen: fine
        with pytest.raises(StaleGenerationError, match="generation 2"):
            elastic.check_commit_generation(run_dir, 1)
        refused = [e for e in recorder.elastic_records
                   if e["event"] == "commit_refused"]
        assert refused and refused[0]["manifest_generation"] == 2
        assert refused[0]["generation"] == 1

    def test_newest_manifest_wins(self, tmp_path):
        for g in (0, 1, 3):
            elastic._write_json_atomic(
                tmp_path / f"manifest.g{g}.json",
                {"generation": g, "port": 1, "members": [0]})
        (tmp_path / "manifest.gx.json").write_text("{}")
        assert elastic._read_manifest(str(tmp_path))["generation"] == 3
        assert elastic._await_manifest(str(tmp_path), 2)["generation"] == 3
        with pytest.raises(elastic.ElasticError, match="no generation"):
            elastic._await_manifest(str(tmp_path), 4, timeout_s=0.1)

    def test_reinit_requires_shutdown(self, monkeypatch):
        from sq_learn_tpu_torch.parallel import distributed as dist

        monkeypatch.setitem(dist._WORLD, "generation", 0)
        dist.initialize()  # no generation: a no-op
        dist.initialize(generation=0)  # same generation: a no-op
        with pytest.raises(RuntimeError, match="call shutdown"):
            dist.initialize(generation=1)

    def test_elastic_init_needs_full_coordinates(self):
        from sq_learn_tpu_torch.parallel import distributed as dist

        with pytest.raises(ValueError, match="elastic initialize"):
            dist.initialize("127.0.0.1:1", 1, 0, elastic=True)

    def test_failure_file_first_writer_wins(self, tmp_path):
        elastic._write_failure_file(str(tmp_path), 0, 2, 0, 1.5)
        elastic._write_failure_file(str(tmp_path), 0, 2, 1, 9.0)
        got = json.loads((tmp_path / "failed.g0.w2.json").read_text())
        assert got == {"generation": 0, "failed": 2, "by": 0,
                       "detect_s": 1.5}


_V9 = {"v": 9, "schema_version": 9, "ts": 0.0}
_V10 = {"v": 10, "schema_version": 10, "ts": 0.0}
_FLEET = {"run_id": "elastic-ab12", "host": "w0", "pid": 123, "gen": 0}

#: records the two validators must agree on (accept or reject)
SCHEMA_CASES = {
    "host_fail": dict(_V9, type="elastic", event="host_fail", generation=0,
                      n_hosts=3, host=0, failed_host=2, detect_s=3.1,
                      window=4),
    "bad_event": dict(_V9, type="elastic", event="exploded", generation=0,
                      n_hosts=3),
    "bad_generation": dict(_V9, type="elastic", event="shrink",
                           generation=-1, n_hosts=2),
    "bad_detect": dict(_V9, type="elastic", event="host_fail",
                       generation=0, n_hosts=3, detect_s=-0.5),
    "bool_host": dict(_V9, type="elastic", event="window", generation=0,
                      n_hosts=3, host=True),
    "fault_host": dict(_V9, type="fault", kind="host_fail", tile=3, host=1),
    "fault_host_str": dict(_V9, type="fault", kind="host_fail", tile=3,
                           host="w1"),
    "fault_stall_neg": dict(_V9, type="fault", kind="host_stall", tile=3,
                            stall_s=-1.0),
    "legacy_v8": {"v": 8, "schema_version": 8, "ts": 0.0, "type": "control",
                  "tenant": "t", "action": "hold", "seq": 3, "inputs": {},
                  "decision": {}},
    "unknown_version": {"v": 99, "schema_version": 99, "ts": 0.0,
                        "type": "meta", "pid": 1, "schema": 99},
    "window": dict(_V10, type="elastic", event="window", generation=0,
                   n_hosts=3, host=1, window=2, cursor=12),
    "commit": dict(_V10, type="elastic", event="commit", generation=0,
                   n_hosts=3, host=0, window=2, cursor=12),
    "clock": dict(_V10, type="clock", peer="w1", sent_ts=100.0,
                  recv_ts=100.1, generation=0, via="hb"),
    "clock_int_peer": dict(_V10, type="clock", peer=1, sent_ts=1.0,
                           recv_ts=1.0),
    "clock_str_ts": dict(_V10, type="clock", peer="w1", sent_ts="now",
                         recv_ts=1.0),
    "clock_neg_gen": dict(_V10, type="clock", peer="w1", sent_ts=1.0,
                          recv_ts=1.0, generation=-1),
    "fleet": dict(_V10, type="elastic", event="world_up", generation=0,
                  n_hosts=2, fleet=_FLEET),
    "fleet_null_gen": dict(_V10, type="elastic", event="world_up",
                           generation=0, n_hosts=2,
                           fleet=dict(_FLEET, gen=None)),
    "fleet_int_run_id": dict(_V10, type="elastic", event="world_up",
                             generation=0, n_hosts=2,
                             fleet=dict(_FLEET, run_id=7)),
    "fleet_str_pid": dict(_V10, type="elastic", event="world_up",
                          generation=0, n_hosts=2,
                          fleet=dict(_FLEET, pid="123")),
    "fleet_not_object": dict(_V10, type="gauge", name="g", value=1,
                             fleet="w0"),
    "fleet_on_span": dict(_V10, type="span", name="s", seq=1, dur_s=0.0,
                          depth=0, parent=None, synced=False, fleet=_FLEET),
}


class TestSchemaV9V10:
    @pytest.mark.parametrize("name", sorted(SCHEMA_CASES))
    def test_both_validators_agree(self, name):
        rec = SCHEMA_CASES[name]
        ours, theirs = (schema.validate_record(rec),
                        jax_schema.validate_record(rec))
        assert bool(ours) == bool(theirs), (ours, theirs)

    def test_messages_name_the_field(self):
        for name, field in (("bad_event", "elastic.event"),
                            ("bad_generation", "elastic.generation"),
                            ("bad_detect", "elastic.detect_s"),
                            ("fault_host_str", "fault.host"),
                            ("fault_stall_neg", "fault.stall_s"),
                            ("clock_int_peer", "clock.peer"),
                            ("clock_str_ts", "clock.sent_ts"),
                            ("clock_neg_gen", "clock.generation"),
                            ("fleet_int_run_id", "fleet.run_id"),
                            ("fleet_str_pid", "fleet.pid")):
            assert any(field in e for e in schema.validate_record(
                SCHEMA_CASES[name])), name

    def test_sim_emits_window_commit_with_generation(self, src, recorder):
        faults.arm("host_fail:window=1,host=0,times=1")
        elastic.elastic_fit_local(src, 3, n_hosts=3, seed=1, epochs=1,
                                  window=4)
        events = [e["event"] for e in recorder.elastic_records]
        assert "window" in events and "commit" in events
        # the simulator runs every host in one process: one commit per
        # committed window ordinal, across both generations
        ordinals = sorted(e["window"] for e in recorder.elastic_records
                          if e["event"] == "commit")
        assert ordinals == list(range(len(ordinals)))
        obs.disable()
        for validate in (schema.validate_jsonl, jax_schema.validate_jsonl):
            assert validate(recorder.path)["errors"] == []


class TestLeases:
    """The lease protocol on a real TCPStore in this process."""

    @pytest.fixture()
    def store(self):
        from sq_learn_tpu_torch.parallel import distributed as dist

        server = dist.start_coordinator_service("127.0.0.1:0")
        yield server
        del server

    def _client(self, store):
        from sq_learn_tpu_torch.parallel import distributed as dist

        return dist._connect(f"127.0.0.1:{store.port}", 10.0)

    def test_live_peer_and_dead_peer(self, store, recorder):
        a = elastic.LeaseSupervisor(self._client(store), 0, 0,
                                    heartbeat_s=0.02, peers=[0, 1],
                                    publisher=self._client(store)).start()
        b = elastic.LeaseSupervisor(self._client(store), 0, 1,
                                    heartbeat_s=0.02, peers=[0, 1]).start()
        try:
            assert a.peer_alive(1, lease_s=2.0)
            assert b.peer_alive(0, lease_s=2.0)
            b.stop()  # peer 1 stops publishing: its lease runs out
            b._thread.join(timeout=5)
            assert not b._thread.is_alive()
            assert not a.peer_alive(1, lease_s=0.3)
            assert not a.peer_alive(2, lease_s=0.1)  # never published
        finally:
            a.stop()
            b.stop()
            a._thread.join(timeout=5)
        # the heartbeats each publisher read became clock samples
        recorder.flush()
        with open(recorder.path) as fh:
            clocks = [r for r in map(json.loads, fh)
                      if r["type"] == "clock"]
        assert {r["peer"] for r in clocks} == {"w0", "w1"}
        assert all(r["via"] == "hb" and r["generation"] == 0
                   for r in clocks)

    def test_partial_bytes_and_timeout(self, store):
        client = self._client(store)
        payload = elastic._pack_partial(np.ones(2), np.eye(2), 0.5)
        elastic._kv_put_bytes(client, "elastic/g0/x/3", payload)
        assert elastic._kv_get_bytes(client, "elastic/g0/x/3", 100) \
            == payload
        with pytest.raises(TimeoutError, match="elastic/g0/x/4"):
            elastic._kv_get_bytes(client, "elastic/g0/x/4", 50)

    def test_dead_peer_aborts_the_generation(self, store, tmp_path,
                                             recorder):
        client = self._client(store)
        lease = elastic.LeaseSupervisor(client, 0, 0, heartbeat_s=0.02)
        with pytest.raises(elastic.GenerationAbort, match="host 1"):
            elastic._await_partial(client, lease, "elastic/g0/x/0", 1, 0.1,
                                   run_dir=str(tmp_path), gen=0, n_hosts=2,
                                   worker=0)
        failed = json.loads((tmp_path / "failed.g0.w1.json").read_text())
        assert failed["failed"] == 1 and failed["by"] == 0
        fails = [e for e in recorder.elastic_records
                 if e["event"] == "host_fail"]
        assert fails and fails[0]["detect_s"] > 0
        from sq_learn_tpu_torch.resilience.supervisor import breaker

        breaker.reset("test")
