"""The port's serving plane (``sq_learn_tpu_torch.serving``) against the JAX
package's, on the CPU.

Tenants are fitted by the JAX package on a small blob set and written as
JAX checkpoints; both registries register the same directories (the port
loads them through ``convert.py``) and serve the same request stream in
the deterministic mode (``background=False``: batching by submission
order only).

- Labels equal the JAX package's served labels and the estimator's own
  ``predict`` wherever the float64 gap between the two nearest squared
  center distances exceeds 3× the measured float32 squared-distance error.
- Transforms are within the float64 bounds of
  ``tests/_torch_serving_helpers.py`` (1e-5·(‖x‖² + ‖c‖²) on squared
  distances, 1e-5·‖x − μ‖ on projections).
- Buckets, group keys, fingerprints, megabatch counts and the ``slo``
  records' key sets and counts equal the JAX package's.
- An OPEN breaker and exhausted retries fail the batch's futures and run
  no kernel; ``close()`` leaves no thread.
"""

import threading

import numpy as np
import pytest
import torch

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import serving as jserving
from sq_learn_tpu_torch import obs, serving
from sq_learn_tpu_torch.resilience import BreakerOpenError, faults
from sq_learn_tpu_torch.resilience.supervisor import breaker
from sq_learn_tpu_torch.serving import quantize

from _torch_serving_helpers import (blobs, check_center_distances,
                                    check_labels, check_projection,
                                    jax_tenants, request_stream,
                                    reset_serving, sq_distances64)


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return jax_tenants(tmp_path_factory.mktemp("tenants"))


@pytest.fixture(autouse=True)
def _hygiene():
    reset_serving()
    yield
    reset_serving()


def _registries(tenants, **aliases):
    """Both packages' registries over the same JAX checkpoints: tenant
    ``name`` → checkpoint of fitted model ``aliases[name]``."""
    mapping = aliases or {"km": "km", "svd": "svd", "pca": "pca"}
    jreg, reg = jserving.ModelRegistry(), serving.ModelRegistry(device="cpu")
    for tenant, model in mapping.items():
        jreg.register(tenant, tenants[model][1], quantize=None)
        reg.register(tenant, tenants[model][1], quantize=None)
    return jreg, reg


def _serve(dispatcher, calls):
    """Serve ``calls`` in one flush from empty result caches."""
    serving.cache.clear()
    jserving.cache.clear()
    futs = [dispatcher.submit(t, op, X) for t, op, X in calls]
    dispatcher.flush()
    out = [f.result(timeout=30) for f in futs]
    dispatcher.close()
    return out


_CALLS = {"km-predict": ("km", "predict"), "km-transform": ("km", "transform"),
          "svd-transform": ("svd", "transform"),
          "pca-transform": ("pca", "transform")}


@pytest.mark.parametrize("case", sorted(_CALLS))
def test_stream_matches_jax_within_bounds(tenants, case):
    tenant, op = _CALLS[case]
    jreg, reg = _registries(tenants)
    calls = [(tenant, op, X) for X in request_stream()]
    ours = _serve(serving.MicroBatchDispatcher(reg, background=False,
                                               autotune=False), calls)
    theirs = _serve(jserving.MicroBatchDispatcher(jreg, background=False,
                                                  autotune=False), calls)
    est = tenants[tenant][0]
    if tenant == "km":
        centers = np.asarray(est.cluster_centers_)
        ctr = torch.from_numpy(centers)
        for (_, _, X), o, t in zip(calls, ours, theirs):
            assert o.shape == t.shape and o.dtype == t.dtype
            if op == "predict":
                x32 = torch.from_numpy(np.asarray(X, np.float32))
                d2 = quantize.transform_centers(x32, ctr).numpy() ** 2
                err = float(np.abs(d2 - sq_distances64(X, centers)).max())
                held = check_labels(o, X, centers, err, t)
                assert held == check_labels(o, X, centers, err,
                                            est.predict(X.astype(np.float32)))
            else:
                check_center_distances(o, X, centers)
                check_center_distances(t, X, centers)
    else:
        mean = getattr(est, "mean_", None)
        comps = np.asarray(est.components_)
        mean = np.zeros(comps.shape[1]) if mean is None else np.asarray(mean)
        for (_, _, X), o, t in zip(calls, ours, theirs):
            assert o.shape == t.shape and o.dtype == t.dtype
            check_projection(o, X, mean, comps)
            check_projection(t, X, mean, comps)


def test_plumbing_equals_jax(tenants):
    jreg, reg = _registries(tenants)
    assert serving.aot.bucket_ladder() == jserving.aot.bucket_ladder()
    assert (serving.aot.bucket_ladder(8, 64)
            == jserving.aot.bucket_ladder(8, 64))
    for tenant in ("km", "svd", "pca"):
        ours, theirs = reg.resolve(tenant), jreg.resolve(tenant)
        assert ours.fingerprint == theirs.fingerprint
        assert ours.n_features == theirs.n_features
        for op in ours.ops:
            assert ours.param_signature(op) == theirs.param_signature(op)
            for dt in (np.float32, np.float64):
                canon = np.dtype(dt) if dt == np.float32 else np.float32
                assert (ours.group_key(op, np.dtype(canon))
                        == theirs.group_key(op, np.dtype(canon)))
    # in-memory tenants: the CRC recipe over the same params' host bytes
    from sq_learn_tpu_torch.utils.checkpoint import load_estimator

    for name in ("km", "svd", "pca"):
        est, ckpt = tenants[name]
        ours = serving.ServingModel(load_estimator(ckpt, device="cpu"),
                                    device="cpu")
        assert ours.fingerprint == jserving.ServingModel(est).fingerprint


@pytest.mark.parametrize("native", [True, False])
def test_native_and_per_request_paths_give_equal_bytes(tenants, native):
    _, reg = _registries(tenants)
    calls = [(t, op, X) for X in request_stream(n=48)
             for t, op in (("km", "predict"), ("km", "transform"),
                           ("pca", "transform"))]
    ours = _serve(serving.MicroBatchDispatcher(
        reg, background=False, autotune=False, native=native), calls)
    other = _serve(serving.MicroBatchDispatcher(
        reg, background=False, autotune=False, native=not native), calls)
    for a, b in zip(ours, other):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert a.flags.c_contiguous and a.flags.writeable


def test_coalesce_on_and_off_give_equal_bytes(tenants):
    """With the bucket floor at the cap every batch runs at one shape, so
    one request per batch (``coalesce=False``) and coalesced batches give
    byte-equal responses; coalescing really merged requests."""
    _, reg = _registries(tenants)
    calls = [("km", "transform", X) for X in request_stream(n=40)]
    kw = dict(background=False, autotune=False, max_batch_rows=64,
              min_bucket_rows=64)
    d_on = serving.MicroBatchDispatcher(reg, coalesce=True, **kw)
    on = _serve(d_on, calls)
    d_off = serving.MicroBatchDispatcher(reg, coalesce=False, **kw)
    off = _serve(d_off, calls)
    assert d_off.slo.summary()["batches"] == len(calls)
    assert d_on.slo.summary()["batches"] < len(calls) // 4
    for a, b in zip(on, off):
        assert a.tobytes() == b.tobytes()


def test_megabatch_reconciles_per_tenant_and_matches_jax(tenants):
    jreg, reg = _registries(tenants, a="km", b="km", c="km")
    calls = [("abc"[i % 3], "predict", X)
             for i, X in enumerate(request_stream(n=60))]
    counts = {}
    for name, pkg, registry in (("ours", obs, reg), ("theirs", jobs, jreg)):
        rec = pkg.enable()
        cls = (serving if pkg is obs else jserving).MicroBatchDispatcher
        d = cls(registry, background=False, autotune=False)
        _serve(d, calls)
        pkg.disable()
        per_tenant = [r for r in rec.slo_records if "tenant" in r]
        aggregate = [r for r in rec.slo_records if "tenant" not in r]
        assert len(aggregate) == 1
        assert sum(r["requests"] for r in per_tenant) == \
            aggregate[0]["requests"] == len(calls)
        assert {r["tenant"] for r in per_tenant} == {"a", "b", "c"}
        counts[name] = (d.megabatches(), aggregate[0]["batches"],
                        [(r["tenant"], r["requests"], r["transfer_bytes"])
                         for r in per_tenant])
    assert counts["ours"][0] >= 1
    assert counts["ours"] == counts["theirs"]


def test_slo_records_have_jax_keys_and_counts(tenants, monkeypatch):
    monkeypatch.setenv("SQ_SERVE_SLO_FLUSH_BATCHES", "3")
    jreg, reg = _registries(tenants)
    calls = [(t, op, X) for X in request_stream(n=40)
             for t, op in (("km", "predict"), ("svd", "transform"))]
    records = {}
    for pkg, registry, mod in ((obs, reg, serving), (jobs, jreg, jserving)):
        rec = pkg.enable()
        _serve(mod.MicroBatchDispatcher(registry, background=False,
                                        autotune=False, slo_p99_ms=1e4,
                                        max_batch_rows=32), calls)
        pkg.disable()
        records[pkg] = rec.slo_records
    ours, theirs = records[obs], records[jobs]
    assert len(ours) == len(theirs) > 3
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in ("site", "requests", "batches", "degraded",
                    "transfer_bytes", "batch_occupancy", "violated",
                    "targets", "tenant", "attrs"):
            assert a.get(key) == b.get(key), key
        assert set(a.get("stages", {})) == set(b.get("stages", {}))


def _count_kernel_calls(monkeypatch):
    calls = []
    for name, fn in list(quantize.KERNELS.items()):
        def counted(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, args[0].device.type))
            return _fn(*args, **kw)
        monkeypatch.setitem(quantize.KERNELS, name, counted)
    return calls


def test_open_breaker_fails_the_batch_and_runs_nothing(tenants, monkeypatch):
    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", "3600")
    _, reg = _registries(tenants)
    calls = _count_kernel_calls(monkeypatch)
    rec = obs.enable()
    for _ in range(3):  # SQ_BREAKER_K consecutive failures trip it
        breaker.record_failure("test")
    assert breaker.state() == "open"
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False)
    futs = [d.submit("km", "predict", X) for X in request_stream(n=10)]
    d.flush()
    for f in futs:
        assert isinstance(f.exception(timeout=5), BreakerOpenError)
    assert calls == [] and d.failed_batches() >= 1
    assert rec.counters["serving.failed_batches"] == d.failed_batches()
    # after the cooldown the half-open trial probes the device afresh
    # (the CPU here: outcome "cpu"), closes the breaker, and serving
    # resumes
    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", "0")
    X = request_stream(n=1)[0]
    assert d.serve("km", "predict", X).shape == (X.shape[0],)
    assert breaker.state() == "closed"
    assert [p["outcome"] for p in rec.probe_events] == ["cpu"]
    assert {dev for _, dev in calls} == {"cpu"}
    d.close()
    obs.disable()


def test_exhausted_retries_fail_the_batch_and_the_queue_moves_on(
        tenants, monkeypatch):
    monkeypatch.setenv("SQ_RETRY_MAX", "2")
    monkeypatch.setenv("SQ_RETRY_BACKOFF_S", "0")
    monkeypatch.setenv("SQ_BREAKER_K", "100")
    _, reg = _registries(tenants)
    calls = _count_kernel_calls(monkeypatch)
    faults.arm("put_fail:tiles=0,times=10")
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False,
                                     max_batch_rows=16)
    reqs = request_stream(n=12)
    futs = [d.submit("km", "transform", X) for X in reqs]
    d.flush()
    failed = [f for f in futs if f.exception(timeout=5) is not None]
    assert failed and all(
        isinstance(f.exception(), faults.InjectedTransferError)
        for f in failed)
    assert len(failed) < len(futs)  # batch 0 failed; the rest served
    assert d.failed_batches() == 1
    assert len(calls) == d.slo.summary()["batches"]
    d.close()


def test_close_leaves_no_thread(tenants):
    _, reg = _registries(tenants)
    before = set(threading.enumerate())
    reqs = request_stream(n=30)
    outs = [None] * 3
    with serving.MicroBatchDispatcher(reg, autotune=False) as d:
        assert d.warm(aot=True)  # the registry's warm pool: 3 tenants

        def client(i):
            outs[i] = [d.submit("km", "predict", X).result(timeout=30)
                       for X in reqs[i::3]]

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
            assert not t.is_alive()
    left = [t.name for t in set(threading.enumerate()) - before]
    assert left == []
    assert sum(len(o) for o in outs) == len(reqs)


def test_registry_defaults_to_cuda():
    if torch.cuda.is_available():
        reg = serving.ModelRegistry()
        assert reg.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving.ModelRegistry()
    with pytest.raises(TypeError):
        serving.ServingModel(object(), device="cpu")
    assert blobs().shape == (400, 12)


def test_strict_budget_gate_raises_from_flush_like_jax(tenants, monkeypatch):
    """Under ``SQ_OBS_BUDGET_STRICT=1`` a burning tenant's windowed budget
    flush raises from the deterministic ``flush`` in both packages, after
    the batch's futures resolved; the batch is not counted as failed."""
    from sq_learn_tpu.obs.budget import BudgetBurnError as JaxBurn
    from sq_learn_tpu_torch.obs.budget import BudgetBurnError

    monkeypatch.setenv("SQ_OBS_BUDGET_STRICT", "1")
    monkeypatch.setenv("SQ_SERVE_SLO_FLUSH_BATCHES", "1")
    X = request_stream(n=1)[0]
    for pkg, obs_pkg, err in ((serving, obs, BudgetBurnError),
                              (jserving, jobs, JaxBurn)):
        reg = (serving.ModelRegistry(device="cpu") if pkg is serving
               else pkg.ModelRegistry())
        reg.register("hot", tenants["km"][1], quantize=None,
                     slo_p99_ms=1e-6)
        obs_pkg.enable()
        d = pkg.MicroBatchDispatcher(reg, background=False, autotune=False)
        fut = d.submit("hot", "predict", X)
        with pytest.raises(err, match="hot"):
            d.flush()
        assert fut.result(timeout=5).shape == (X.shape[0],)
        if pkg is serving:
            assert d.failed_batches() == 0
        monkeypatch.setenv("SQ_OBS_BUDGET_STRICT", "0")
        d.close()
        monkeypatch.setenv("SQ_OBS_BUDGET_STRICT", "1")
        obs_pkg.disable()
