"""The port's elastic world with real processes: gloo over TCPStores on
localhost, every worker on the CPU.

- Generations (``tests/_torch_elastic_worker.py``, in the shape of
  ``tests/_elastic_worker.py``): two processes join generation 0 of a
  world whose store this process hosts, tear it down and form generation
  1 in the same processes (with the fleet run id adopted through the
  store); two workers carrying generations 0 and 1 to one store: one
  joins, the other gets ``GenerationMismatchError``.
- The fit (:class:`~sq_learn_tpu_torch.parallel.elastic.
  ElasticCoordinator` over a shard store): 2 workers, uninterrupted, bit
  equal to ``elastic_fit_local``; 3 workers with worker 1 SIGKILLed after
  the first commit (held there by a 5 s ``host_stall``): the survivors
  detect it through their leases, shrink to a generation-1 world of 2 and
  end bit-equal to the 2-worker run, with every shard folded ``epochs``
  times; ``python -m sq_learn_tpu_torch.obs fleet`` reconciles the run;
  the same shrink with ``SQ_ELASTIC_PORT`` set.

Leases are 10 s (``SQ_ELASTIC_LEASE_S=10``), so a loaded test machine
cannot declare a live peer dead; the checks are bits and the fold ledger,
never times.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.obs import fleet, schema
from sq_learn_tpu_torch.oocore import open_store, store_from_array
from sq_learn_tpu_torch.parallel import distributed as dist
from sq_learn_tpu_torch.parallel import elastic

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_elastic_worker.py"
LEASE_S = 10.0
K, SEED, EPOCHS, WINDOW = 4, 7, 2, 4


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(autouse=True)
def _lease(monkeypatch):
    """Leases of 10 s for every world the tests start: the coordinator
    writes its knobs into the run's config, and workers inherit them."""
    monkeypatch.setenv("SQ_ELASTIC_LEASE_S", str(LEASE_S))


def _run_workers(mode, ports, n=2, timeout=180):
    from sq_learn_tpu_torch import _knobs

    env = _knobs.environ(PYTHONPATH=str(REPO), PYTHONSTARTUP=None,
                         SQ_OBS=None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(pid)]
        + [str(p) for p in ports] + [str(REPO)],
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("elastic workers timed out:\n" + "\n".join(outs))
    return procs, outs


def test_shutdown_and_reinit_next_generation():
    stores = [dist.start_coordinator_service("127.0.0.1:0")
              for _ in range(2)]
    procs, outs = _run_workers("reinit", [s.port for s in stores])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} REINIT OK" in out
    # both members agreed on generation 0, then on 1, through the stores
    assert [s.get("elastic/generation") for s in stores] == [b"0", b"1"]
    assert stores[0].get("fleet/run_id") == b"fleet-mp-test"


def test_mixed_generation_join_refused():
    store = dist.start_coordinator_service("127.0.0.1:0")
    procs, outs = _run_workers("mismatch", [store.port])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    verdicts = sorted(line.split()[-1] for out in outs
                      for line in out.splitlines()
                      if line.startswith("worker "))
    assert verdicts == ["JOINED", "MISMATCH"], (verdicts, outs)


@pytest.fixture(scope="module")
def shard_store(tmp_path_factory):
    """230 × 7 float32 rows in 15 shards of 16 rows (the last ragged)."""
    X = np.random.default_rng(19).normal(size=(230, 7)).astype(np.float32)
    path = tmp_path_factory.mktemp("elastic") / "store"
    return store_from_array(str(path), X, shard_bytes=16 * 7 * 4).path


@pytest.fixture(scope="module")
def reference(shard_store):
    with config_context(device="cpu"):
        return elastic.elastic_fit_local(open_store(shard_store), K,
                                         n_hosts=2, seed=SEED,
                                         epochs=EPOCHS, window=WINDOW)


def _fit(tmp_path, shard_store, n_workers, kill=None):
    coord = elastic.ElasticCoordinator(
        tmp_path / "run", shard_store, n_workers=n_workers, n_clusters=K,
        seed=SEED, epochs=EPOCHS, window=WINDOW, device="cpu", kill=kill)
    assert coord.lease_s == LEASE_S
    return coord, coord.run(timeout_s=240)


@pytest.fixture
def hold_victim(monkeypatch):
    """Worker 1 sleeps 5 s at window 1, right after the first commit: the
    fit cannot pass that window without it, so the coordinator's SIGKILL
    (at the first commit, seen within its 50 ms poll) lands mid-fit
    however fast the windows run. Workers inherit ``SQ_FAULTS``; this
    process armed its plan at import and is not affected."""
    monkeypatch.setenv("SQ_FAULTS", "host_stall:window=1,host=1,times=1,s=5")


def _same_state(got, want):
    for key in ("centers", "counts", "folds"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["inertia"] == want["inertia"]


def test_two_worker_fit_equals_the_simulator(tmp_path, shard_store,
                                             reference):
    coord, got = _fit(tmp_path, shard_store, 2)
    _same_state(got, reference)
    assert (got["generation"], got["n_hosts"], got["shrinks"]) == (0, 2, 0)
    assert got["exit_codes"] == {0: 0, 1: 0}
    assert (got["folds"] == EPOCHS).all()
    events = {(r["_worker"], r["event"])
              for r in elastic.collect_elastic_records(coord.run_dir)}
    for w in ("0", "1"):
        assert {(w, "world_up"), (w, "resume"), (w, "window"),
                (w, "done")} <= events
    assert ("0", "commit") in events and ("1", "commit") not in events
    _one_clock(coord.run_dir)


def test_keywords_win_over_the_knobs_and_reach_the_workers(
        tmp_path, shard_store, reference, monkeypatch):
    """One 2-worker fit with ``heartbeat_s``/``lease_s`` given as keywords
    while their knobs say otherwise, ``obs=False`` and a ``worker_env``
    that sends the workers' records to a file of its own: the workers run
    on the keywords (the run's config, which they read), the run
    directory holds no obs shard, and the file holds both workers'
    records."""
    monkeypatch.setenv("SQ_ELASTIC_HEARTBEAT_S", "7")
    monkeypatch.setenv("SQ_ELASTIC_LEASE_S", "99")
    sink = tmp_path / "worker_env.jsonl"
    coord = elastic.ElasticCoordinator(
        tmp_path / "run", shard_store, n_workers=2, n_clusters=K, seed=SEED,
        epochs=EPOCHS, window=WINDOW, device="cpu", heartbeat_s=0.3,
        lease_s=LEASE_S, obs=False,
        worker_env={"SQ_OBS": "1", "SQ_OBS_PATH": str(sink)})
    got = coord.run(timeout_s=240)
    _same_state(got, reference)
    assert got["exit_codes"] == {0: 0, 1: 0}
    with open(os.path.join(coord.run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    assert (cfg["heartbeat_s"], cfg["lease_s"]) == (0.3, LEASE_S)
    assert not [f for f in os.listdir(coord.run_dir)
                if f.startswith("obs.")]
    with open(sink) as fh:
        records = [json.loads(line) for line in fh]
    assert {r["host"] for r in records if r.get("type") == "elastic"
            and r.get("event") == "world_up"} == {0, 1}


class _Process:
    """A stand-in worker process: alive, or dead with exit code 1."""

    def __init__(self, alive):
        self.returncode = None if alive else 1
        self.pid = -1

    def poll(self):
        return self.returncode

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


@pytest.mark.parametrize("max_shrinks,knob", [(0, "5"), (1, "0")])
def test_max_shrinks_wins_over_its_knob(tmp_path, monkeypatch, max_shrinks,
                                        knob):
    """Worker 1 is dead from the start: with ``max_shrinks=0`` the
    coordinator gives up at once, with 1 it shrinks to generation 1 and
    waits for the survivor (here until its timeout). The knob says the
    opposite each time. ``obs=False`` writes no coordinator shard."""
    monkeypatch.setenv("SQ_ELASTIC_MAX_SHRINKS", knob)
    coord = elastic.ElasticCoordinator(
        tmp_path / "run", tmp_path / "store", n_workers=2, device="cpu",
        max_shrinks=max_shrinks, obs=False)
    assert coord.max_shrinks == max_shrinks
    monkeypatch.setattr(coord, "_spawn", lambda i: _Process(alive=i == 0))
    if max_shrinks == 0:
        with pytest.raises(elastic.HostFailure, match="1/0"):
            coord.run(timeout_s=30)
    else:
        with pytest.raises(elastic.ElasticError, match="did not finish"):
            coord.run(timeout_s=1.0)
        with open(os.path.join(coord.run_dir, "manifest.g1.json")) as fh:
            assert json.load(fh)["members"] == [0]
    assert not os.path.exists(os.path.join(coord.run_dir, "obs.coord.jsonl"))


def _one_clock(run_dir):
    """Every process of the run shares this host's clock, so the fleet's
    offsets must come out near 0: a manifest written before its reader
    looked (before the worker started) is no clock sample — as one, it
    put the workers seconds ahead (ROADMAP.md §3)."""
    offsets = fleet.summarize(run_dir)["clock_offsets_s"]
    assert max(abs(o) for o in offsets.values()) < 1.0, offsets


def test_sigkill_shrinks_and_resumes_bit_equal(tmp_path, shard_store,
                                               reference, hold_victim):
    coord, got = _fit(tmp_path, shard_store, 3, kill=(1, WINDOW))
    _same_state(got, reference)
    assert (got["generation"], got["n_hosts"], got["shrinks"]) == (1, 2, 1)
    assert got["killed"] == [1] and got["exit_codes"][1] == -9
    assert got["exit_codes"][0] == got["exit_codes"][2] == 0
    assert (got["folds"] == EPOCHS).all()
    run = coord.run_dir
    with open(os.path.join(run, "manifest.g1.json")) as fh:
        assert json.load(fh)["members"] == [0, 2]
    records = elastic.collect_elastic_records(run)
    fails = [r for r in records if r["event"] == "host_fail"]
    assert fails and all(r["failed_host"] == 1 and r["detect_s"] > 0
                         for r in fails)
    assert {r["_worker"] for r in records
            if r["event"] == "world_up" and r["generation"] == 1} \
        == {"0", "2"}
    # the killed worker's shard holds its progress up to its last flush
    assert any(r["_worker"] == "1" and r["event"] == "window"
               for r in records)
    # the merged timeline: one run id, every commit window once
    summary = fleet.summarize(run)
    assert len(summary["run_ids"]) == 1
    assert summary["hosts"] == ["coord", "w0", "w1", "w2"]
    assert summary["generations"] == [0, 1]
    rc = summary["reconciliation"]
    assert rc["ok"] and rc["windows"] == EPOCHS * -(-15 // WINDOW)
    _one_clock(run)
    path = [p for p in summary["critical_path"] if p["generation"] == 1]
    assert path and path[0]["detect_s"] > 0
    assert all(path[0][k] is not None
               for k in ("shrink_s", "reinit_s", "resume_s"))
    for name in os.listdir(run):
        if name.startswith("obs.") and name.endswith(".jsonl"):
            assert schema.validate_jsonl(os.path.join(run, name))[
                "errors"] == [], name
    from sq_learn_tpu_torch import _knobs

    out = subprocess.run(
        [sys.executable, "-m", "sq_learn_tpu_torch.obs", "fleet", run,
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=_knobs.environ(PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["reconciliation"]["ok"]


def _free_port_pair():
    """A port p with p + 1 free too, on localhost."""
    import socket

    for _ in range(100):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    pytest.fail("no pair of free ports on localhost")


def test_sigkill_shrink_with_a_fixed_store_port(tmp_path, shard_store,
                                               reference, hold_victim,
                                               monkeypatch):
    """``SQ_ELASTIC_PORT`` set: generation 0's store binds it and stays
    bound, so generation G binds the knob + G, and the shrink goes through
    bit-equal."""
    port = _free_port_pair()
    monkeypatch.setenv("SQ_ELASTIC_PORT", str(port))
    coord, got = _fit(tmp_path, shard_store, 3, kill=(1, WINDOW))
    _same_state(got, reference)
    assert (got["generation"], got["n_hosts"], got["shrinks"]) == (1, 2, 1)
    assert (got["folds"] == EPOCHS).all()
    ports = []
    for gen in (0, 1):
        with open(os.path.join(coord.run_dir, f"manifest.g{gen}.json")) as fh:
            ports.append(json.load(fh)["port"])
    assert ports == [port, port + 1]
