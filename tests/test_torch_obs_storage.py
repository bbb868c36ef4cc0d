"""The port's storage ledger (``sq_learn_tpu_torch.obs.storage``) and sink
rotation, against the JAX package's.

Held as in the JAX package's ``tests/test_obs_storage.py``: cumulative
per-(surface, store, shard) ``io`` records read last-wins, never one line
per read; a read, retry, quarantine or cold-tier stall on a prefetch
worker lands on the shard that owns it; with obs off the read paths read
no ledger clock and allocate no ledger; the heat's decay and the
advisor's projections, computed by hand; ``SQ_OBS_ROTATE_BYTES``
rotation read back across segments; the ``io`` schema; the CLI's exit
codes. And against the JAX package: the same records rendered, collected
and advised on identically by both readers, whichever package wrote
them (equal dicts and equal text, no tolerance).
"""

import gzip
import json
import subprocess
import sys

import numpy as np
import pytest

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import oocore as joo
from sq_learn_tpu.obs import storage as jstorage
from sq_learn_tpu_torch import obs
from sq_learn_tpu_torch.obs import storage
from sq_learn_tpu_torch.obs._files import load_jsonl
from sq_learn_tpu_torch.obs.recorder import SCHEMA_VERSION
from sq_learn_tpu_torch.obs.schema import validate_jsonl, validate_record
from sq_learn_tpu_torch.oocore import store_from_array
from sq_learn_tpu_torch.oocore.prefetch import ShardPrefetcher
from sq_learn_tpu_torch.resilience import faults, supervisor

REPO = __file__.rsplit("/tests/", 1)[0]


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


def _tiny_store(tmp_path, rows=48, cols=8, shard_bytes=512, name="store",
                package=None):
    """48 × 8 float32 rows in 512-byte shards: 3 shards of 16 rows."""
    X = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    build = store_from_array if package is None else package.store_from_array
    return build(str(tmp_path / name), X, shard_bytes=shard_bytes), X


class _FakeRec:
    """A recorder stand-in for the ledger's arithmetic."""

    def __init__(self):
        self.io_records = []

    def record(self, rec, kind=None):
        self.io_records.append(dict(rec))


def test_shard_reads_aggregate_cumulatively(tmp_path):
    rec = obs.enable(str(tmp_path / "run.jsonl"))
    store, X = _tiny_store(tmp_path)
    row_bytes = X.shape[1] * X.dtype.itemsize
    for i in range(store.n_shards):
        store.read_shard(i)
        store.read_shard(i)
    assert storage.flush("pass_end") == store.n_shards
    shards = storage.collect(rec.io_records)["surfaces"]["oocore"][
        store.fingerprint]
    assert sorted(shards) == list(range(store.n_shards))
    for i, r in shards.items():
        assert r["reads"] == 2
        assert r["bytes_raw"] == 2 * store.shard_sizes[i] * row_bytes
        assert r["bytes_stored"] == 2 * store.shard_stored_sizes[i]
        assert r["serial"] == 2 and r["hits"] == 0 and r["stalls"] == 0
        assert r["reason"] == "pass_end"
    assert storage.flush("pass_end") == 0  # nothing dirty
    store.read_shard(0)
    assert storage.flush("pass_end") == 1
    view = storage.collect(rec.io_records)
    assert view["surfaces"]["oocore"][store.fingerprint][0]["reads"] == 3
    per_key = {}
    for r in rec.io_records:
        k = (r["surface"], r["store"], r["shard"])
        per_key[k] = per_key.get(k, 0) + 1
    assert max(per_key.values()) <= rec._storage._flushes


def test_recorder_close_drains_dirty_aggregates(tmp_path):
    path = str(tmp_path / "run.jsonl")
    obs.enable(path)
    store, _ = _tiny_store(tmp_path)
    store.read_shard(0)  # dirty, never flushed
    rec = obs.disable()
    assert [r for r in rec.io_records if r["reason"] == "close"]
    summary = validate_jsonl(path)
    assert summary["errors"] == [] and summary["by_type"]["io"] >= 1


def test_fault_matrix_attributes_to_owning_shard(tmp_path):
    rec = obs.enable(str(tmp_path / "run.jsonl"))
    store, X = _tiny_store(tmp_path)
    plan = faults.arm("read_fail:tiles=1,times=1;"
                      "corrupt_shard:tiles=2,times=1;"
                      "cold_tier:s=0.01,per_mb=0")
    pf = ShardPrefetcher(store, range(store.n_shards), depth=3, threads=2)
    got = [pf.get(p) for p in range(store.n_shards)]
    pf.close()
    faults.disarm()
    assert np.array_equal(np.concatenate(got), X)
    kinds = {ev["kind"] for ev in plan.events}
    assert {"read_fail", "corrupt_shard", "cold_tier"} <= kinds
    shards = storage.collect(rec.io_records)["surfaces"]["oocore"][
        store.fingerprint]
    assert shards[2]["quarantined"] >= 1 and shards[2]["retries"] >= 1
    assert shards[2]["reads"] == 1
    for i, r in shards.items():
        assert r["cold_s"] >= 0.01 - 1e-4, (i, r)
        assert r["hits"] + r["stalls"] == 1 and r["serial"] == 0


def test_disabled_path_touches_no_clock_and_no_ledger(tmp_path,
                                                      monkeypatch):
    assert not obs.enabled()
    calls = []
    real_now = storage._now
    monkeypatch.setattr(storage, "_now",
                        lambda: calls.append(1) or real_now())
    store, _ = _tiny_store(tmp_path)
    for i in range(store.n_shards):
        store.read_shard(i)
    pf = ShardPrefetcher(store, range(store.n_shards), depth=2, threads=1)
    for p in range(store.n_shards):
        pf.get(p)
    pf.close()
    assert calls == []
    assert storage.active() is None and storage.flush() == 0


def test_ledger_attaches_lazily_on_first_access(tmp_path):
    rec = obs.enable(None)
    assert rec._storage is None
    store, _ = _tiny_store(tmp_path)
    store.read_shard(0)
    assert isinstance(rec._storage, storage.StorageLedger)


def test_heat_ewma_hand_computed(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(storage, "_now", lambda: clock["t"])
    led = storage.StorageLedger(_FakeRec())
    led.record_read("oocore", "s", 0, stored_bytes=1, raw_bytes=1)
    clock["t"] = 60.0  # one half-life later: 1·0.5 + 1
    led.record_read("oocore", "s", 0, stored_bytes=1, raw_bytes=1)
    clock["t"] = 120.0  # the flush decays to its instant: 1.5·0.5
    led.flush("pass_end")
    (rec,) = led._rec.io_records
    assert rec["heat"] == pytest.approx(0.75, abs=1e-6)
    assert rec["reads"] == 2


def test_snapshot_carries_the_oocore_surface_and_breaker(tmp_path):
    rec = obs.enable(str(tmp_path / "run.jsonl"))
    store, _ = _tiny_store(tmp_path)
    store.read_shard(0)
    storage.flush()
    snap = obs.snapshot()
    assert snap["io_records"] == len(rec.io_records) == 1
    assert snap["storage_surfaces"]["oocore"]["reads"] == 1
    assert "ram_budget_bytes" in snap["storage_surfaces"]["oocore"]
    assert set(snap["storage_surfaces"]) == {"oocore"}
    assert snap["breaker_state"] == "closed" and snap["faults_injected"] == 0
    # the serving surfaces' events, which the JAX package records, read
    led = storage.active()
    led.record_cache_event("serve_cache", "featcache", "spill",
                           stored_bytes=100, raw_bytes=200)
    led.record_cache_event("compile_cache", "xla", "miss", dur_s=0.02)
    storage.flush()
    for r in rec.io_records:
        assert validate_record(r) == []
    roll = storage.surface_rollup(storage.collect(rec.io_records))
    assert set(roll) == {"oocore", "serve_cache", "compile_cache"}


def test_rotation_segments_validate_and_merge_last_wins(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("SQ_OBS_ROTATE_BYTES", "2048")
    path = str(tmp_path / "rot.jsonl")
    rec = obs.enable(path)
    store, _ = _tiny_store(tmp_path)
    store.read_shard(0)
    storage.flush("pass_end")
    for _ in range(60):
        obs.counter_add("rot.pad", 1)
    store.read_shard(0)
    store.read_shard(0)
    storage.flush("pass_end")
    for _ in range(60):
        obs.counter_add("rot.pad", 1)
    obs.disable()
    segments = storage._with_segments([path])
    assert len(segments) > 1
    assert segments[0].endswith(".1.gz") and segments[-1] == path
    records = []
    for seg in segments:
        seg_records = load_jsonl(seg)
        assert seg_records, seg
        for r in seg_records:
            assert validate_record(r) == [], (seg, r)
        records.extend(seg_records)
        opener = gzip.open(seg, "rt") if seg.endswith(".gz") else open(seg)
        with opener as fh:
            assert json.loads(fh.readline())["type"] == "meta"
    assert any(r.get("segment") for r in records if r["type"] == "meta")
    view = storage.collect(records)
    assert view["surfaces"]["oocore"][store.fingerprint][0]["reads"] == 3
    assert rec.counters["rot.pad"] == 120
    # the JAX package's reader reads the port's rotated segments alike
    jrecords = []
    for seg in jstorage._with_segments([path]):
        jrecords.extend(load_jsonl(seg))
    assert jstorage.collect(jrecords) == view


def test_rotation_failure_degrades_to_unrotated_sink(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("SQ_OBS_ROTATE_BYTES", "512")
    path = str(tmp_path / "rot.jsonl")
    rec = obs.enable(path)
    import shutil

    def broken(*a, **k):
        raise OSError("no space")

    monkeypatch.setattr(shutil, "copyfileobj", broken)
    for _ in range(60):
        obs.counter_add("rot.pad", 1)
    monkeypatch.undo()
    assert rec._rotate_bytes == 0  # rotation off after the failure
    for _ in range(5):
        obs.counter_add("rot.pad", 1)
    obs.disable()
    assert validate_jsonl(path)["errors"] == []
    assert rec.counters["rot.pad"] == 65


def _io(store, shard, *, stored, raw, reads=1, read_s=0.0, decode_s=0.0,
        codec=None, heat=1.0):
    r = {"type": "io", "surface": "oocore", "store": store,
         "shard": shard, "reads": reads, "bytes_stored": stored,
         "bytes_raw": raw, "read_s": read_s, "decode_s": decode_s,
         "heat": heat}
    if codec:
        r["codec"] = codec
    return r


def test_advise_hand_computed_projection():
    """s1 (compressed) measures ratio 0.5, t_io 2e-5 s per stored byte and
    t_dec 1e-6 s per raw byte; s2's raw shard then projects −500 bytes
    and −9 ms an access (compress), × its 2 reads; s1 stays."""
    records = [
        _io("s1", 0, stored=500, raw=1000, read_s=0.01, decode_s=0.001,
            codec="lz4"),
        _io("s2", 0, stored=2000, raw=2000, reads=2, read_s=0.04,
            heat=2.0),
    ]
    adv = storage.advise(storage.collect(records))
    assert adv["ratio"] == pytest.approx(0.5)
    assert adv["t_dec_per_byte"] == pytest.approx(1e-6)
    assert adv["t_io_per_byte"]["s2"] == pytest.approx(2e-5)
    by_store = {s["store"]: s for s in adv["shards"]}
    assert by_store["s2"]["action"] == "compress"
    assert by_store["s2"]["projected_bytes_delta"] == -500
    assert by_store["s2"]["projected_wallclock_delta_s"] == \
        pytest.approx(-0.018)
    assert by_store["s1"]["action"] == "leave"
    assert adv["shards"][0]["store"] == "s2" and adv["notes"] == []
    assert adv == jstorage.advise(jstorage.collect(records))


def test_advise_refuses_to_invent_a_ratio():
    adv = storage.advise(storage.collect(
        [_io("s", 0, stored=1000, raw=1000, read_s=0.1)]))
    assert adv["ratio"] is None and adv["notes"]
    assert all(s["action"] == "leave" for s in adv["shards"])


def test_advise_decompress_when_decode_dominates():
    records = [_io("s", 0, stored=900, raw=1000, read_s=0.0009,
                   decode_s=0.01, codec="lz4")]
    (rec,) = storage.advise(storage.collect(records))["shards"]
    assert rec["action"] == "decompress"
    assert rec["projected_bytes_delta"] == 100
    assert rec["projected_wallclock_delta_s"] < 0


def test_io_record_schema_and_legacy_versions():
    from sq_learn_tpu.obs.schema import validate_record as jax_validate

    good = dict(_io("s", 0, stored=10, raw=20, read_s=0.1),
                v=SCHEMA_VERSION, schema_version=SCHEMA_VERSION, ts=0.0)
    assert validate_record(good) == [] == jax_validate(good)
    assert validate_record(dict(good, shard=None)) == []
    errs = validate_record(dict(good, reads=-1, bytes_raw="x"))
    assert any("io.reads" in e for e in errs)
    assert any("io.bytes_raw" in e for e in errs)
    assert any("io.shard" in e for e in validate_record(dict(good,
                                                             shard=True)))
    legacy = {"v": 10, "schema_version": 10, "ts": 0.0, "type": "counter",
              "name": "c", "value": 1, "delta": 1}
    assert validate_record(legacy) == []
    meta = {"v": 11, "schema_version": 11, "ts": 0.0, "type": "meta",
            "pid": 1, "schema": 11, "segment": 2}
    assert validate_record(meta) == []
    assert validate_record(dict(meta, segment=0))


def _ledger_artifact(tmp_path, package=None):
    path = str(tmp_path / ("jax.jsonl" if package else "port.jsonl"))
    rec_mod = jobs if package else obs
    rec_mod.enable(path)
    store, _ = _tiny_store(tmp_path, package=package,
                           name="jstore" if package else "store")
    for i in range(store.n_shards):
        store.read_shard(i)
    (jstorage if package else storage).flush("pass_end")
    rec_mod.disable()
    return path, store


def test_cli_exit_codes_and_json(tmp_path, capsys):
    empty = str(tmp_path / "empty.jsonl")
    with open(empty, "w") as fh:
        fh.write(json.dumps({"v": SCHEMA_VERSION,
                             "schema_version": SCHEMA_VERSION, "ts": 0.0,
                             "type": "meta", "pid": 1,
                             "schema": SCHEMA_VERSION}) + "\n")
    assert storage.main([empty]) == 2
    capsys.readouterr()
    path, store = _ledger_artifact(tmp_path)
    assert storage.main([path, "--json", "--advise"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["records"] == store.n_shards
    assert store.fingerprint in doc["surfaces"]["oocore"]
    assert len(doc["advice"]["shards"]) == store.n_shards
    assert storage.main([path, "--top", "2"]) == 0
    assert "hottest shards (top 2 of 3)" in capsys.readouterr().out
    assert storage.main([path, "--top"]) == 2
    assert storage.main([]) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_readers_render_an_artifact_alike(tmp_path, capsys, writer):
    """An artifact written by either package collects, rolls up, advises
    and renders the same in both readers; the port's CLI prints what the
    JAX package's prints."""
    path, store = _ledger_artifact(tmp_path,
                                   package=joo if writer == "jax" else None)
    records = load_jsonl(path)
    ours, theirs = storage.collect(records), jstorage.collect(records)
    assert ours == theirs
    assert storage.surface_rollup(ours) == jstorage.surface_rollup(theirs)
    assert storage.advise(ours) == jstorage.advise(theirs)
    assert storage.render(ours, advice=storage.advise(ours)) == \
        jstorage.render(theirs, advice=jstorage.advise(theirs))
    assert storage.main([path, "--advise"]) == 0
    port_out = capsys.readouterr().out
    assert jstorage.main([path, "--advise"]) == 0
    assert capsys.readouterr().out == port_out
    assert store.fingerprint in ours["surfaces"]["oocore"]


def test_storage_cli_runs_without_torch(tmp_path):
    path, _ = _ledger_artifact(tmp_path)
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from sq_learn_tpu_torch.obs.__main__ import main\n"
            "sys.exit(main(['storage', sys.argv[1]]))\n")
    out = subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                         env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "storage-plane ledger" in out.stdout
