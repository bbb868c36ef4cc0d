"""The port's serving result cache (``sq_learn_tpu_torch.serving.cache``)
against the JAX package's, on the CPU: equal keys for the same payloads,
the same LRU hits, misses and evictions, and spill files that either
package reads from the other.
"""

import os

import numpy as np
import pytest

from sq_learn_tpu.serving import cache as jcache
from sq_learn_tpu_torch import obs
from sq_learn_tpu_torch.serving import cache

from _torch_serving_helpers import reset_serving


@pytest.fixture(autouse=True)
def _hygiene():
    reset_serving()
    yield
    reset_serving()


def _payloads():
    rng = np.random.default_rng(3)
    return [rng.normal(size=(n, 12)).astype(dt)
            for n, dt in ((1, np.float32), (5, np.float32), (64, np.float32),
                          (65, np.float32), (300, np.float32),
                          (7, np.float64), (3, np.int32))]


@pytest.mark.parametrize("index", range(7))
def test_key_for_equals_jax(index):
    X = _payloads()[index]
    for fp, op in (("abc123", "transform"), ("abc123:q=bf16", "predict")):
        assert cache.key_for(fp, op, X) == jcache.key_for(fp, op, X)
    assert cache._key_json(cache.key_for("f", "transform", X)) == \
        jcache._key_json(jcache.key_for("f", "transform", X))


def test_kill_switch_matches_jax(monkeypatch):
    monkeypatch.setenv("SQ_SERVE_CACHE", "0")
    X = _payloads()[0]
    assert cache.key_for("f", "transform", X) is None
    assert jcache.key_for("f", "transform", X) is None
    assert cache.lookup(None) is None
    cache.store(None, X)  # a no-op


def test_lru_behaves_like_jax(monkeypatch):
    monkeypatch.setenv("SQ_SERVE_CACHE_ENTRIES", "3")
    payloads = _payloads()
    ops = [("store", 0), ("store", 1), ("lookup", 0), ("store", 2),
           ("store", 3), ("lookup", 1), ("lookup", 0), ("lookup", 3),
           ("store", 4), ("lookup", 2), ("lookup", 4), ("lookup", 5)]
    trace = {}
    for pkg in (cache, jcache):
        out = []
        before = pkg.stats()  # cumulative over the process
        for kind, i in ops:
            key = pkg.key_for("f", "transform", payloads[i])
            if kind == "store":
                pkg.store(key, payloads[i] * 2)
            else:
                hit = pkg.lookup(key)
                out.append(None if hit is None else hit.tobytes())
        trace[pkg] = (out, {k: v - before[k]
                            for k, v in pkg.stats().items()})
    assert trace[cache] == trace[jcache]
    # a hit is a copy: mutating it leaves the cached entry intact
    key = cache.key_for("f", "transform", payloads[4])
    cache.lookup(key)[:] = 0
    assert cache.lookup(key).tobytes() == (payloads[4] * 2).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spill_files_read_across_packages(tmp_path, monkeypatch, writer):
    monkeypatch.setenv("SQ_SERVE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SQ_SERVE_CACHE_ENTRIES", "1")
    out_pkg, in_pkg = ((jcache, cache) if writer == "jax"
                       else (cache, jcache))
    rng = np.random.default_rng(9)
    results = [rng.normal(size=(n, 4)).astype(np.float32) for n in (3, 40)]
    results.append(np.arange(16, dtype=np.int32))  # a predict-shaped result
    keys = [out_pkg.key_for("fp", "transform", r) for r in results]
    for k, r in zip(keys, results):
        out_pkg.store(k, r)
    assert out_pkg.spill_all() == 1
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".sqc")]) == 3
    for k, r in zip(keys, results):
        got = in_pkg.lookup(in_pkg.key_for("fp", "transform", r))
        assert got is not None and got.dtype == r.dtype
        assert got.tobytes() == r.tobytes()
    assert in_pkg.stats()["disk_hits"] >= 2
    # a header whose key disagrees is a miss, never wrong rows
    path = os.path.join(tmp_path, [f for f in os.listdir(tmp_path)
                                   if f.endswith(".sqc")][0])
    with open(path, "rb") as fh:
        header, payload = fh.readline(), fh.read()
    with open(path, "wb") as fh:
        fh.write(header.replace(b'"fp"', b'"xx"') + payload)
    in_pkg.clear()
    misses = sum(in_pkg.lookup(in_pkg.key_for("fp", "transform", r)) is None
                 for r in results)
    assert misses == 1


def test_spill_lands_on_the_storage_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("SQ_SERVE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SQ_SERVE_CACHE_ENTRIES", "1")
    rec = obs.enable(str(tmp_path / "run.jsonl"))
    a, b = (np.full((4, 4), v, np.float32) for v in (1.0, 2.0))
    ka, kb = (cache.key_for("fp", "transform", x) for x in (a, b))
    cache.store(ka, a)
    cache.store(kb, b)          # evicts a: one spill
    assert cache.lookup(ka).tobytes() == a.tobytes()   # disk hit, promoted
    cache.flush_counters()
    obs.disable()
    (io,) = [r for r in rec.io_records if r["surface"] == "serve_cache"]
    assert io["spills"] >= 1 and io["disk_hits"] == 1 and io["promotes"] == 1
    assert rec.counters["serving.cache_spills"] >= 1
    assert rec.counters["serving.cache_disk_hits"] == 1
    assert obs.schema.validate_jsonl(str(tmp_path / "run.jsonl"))[
        "errors"] == []
