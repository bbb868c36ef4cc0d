"""The port's ladder warm-up (``sq_learn_tpu_torch.serving.aot``) against
the JAX package's AOT compiles, on the CPU: the same ladder, the same
signatures warmed per model, zero misses after warm-up, and with the
budgets pinned an unwarmed dispatch raises under ``SQ_OBS_STRICT=1``.
"""

import numpy as np
import pytest

from sq_learn_tpu import serving as jserving
from sq_learn_tpu_torch import obs, serving
from sq_learn_tpu_torch.serving import aot, dispatcher

from _torch_serving_helpers import jax_tenants, request_stream, reset_serving


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return jax_tenants(tmp_path_factory.mktemp("tenants"))


@pytest.fixture(autouse=True)
def _hygiene():
    reset_serving()
    yield
    reset_serving()


@pytest.mark.parametrize("lo,hi", [(None, None), (8, 64), (1, 1), (3, 100),
                                   (16, 512)])
def test_bucket_ladder_equals_jax(lo, hi):
    assert aot.bucket_ladder(lo, hi) == jserving.aot.bucket_ladder(lo, hi)


@pytest.mark.parametrize("mode", [None, "bf16", "int8"])
def test_warm_signatures_equal_jax(tenants, mode):
    """The port warms exactly the signatures the JAX package compiles:
    kernel set × ladder × serve dtypes, keyed the JAX way."""
    jreg, reg = jserving.ModelRegistry(), serving.ModelRegistry(device="cpu")
    for name in ("km", "pca"):
        jreg.register(name, tenants[name][1], quantize=mode)
        reg.register(name, tenants[name][1], quantize=mode)
    ladder = aot.bucket_ladder(8, 64)
    ours = reg.warm(buckets=ladder)
    theirs = jreg.warm(buckets=ladder)
    assert ours == theirs == {"km": "loaded", "pca": "loaded"}
    assert aot.cache_size() == jserving.aot.cache_size() == 3 * len(ladder)
    warmed = {key[1:] for key in aot._warmed}
    assert warmed == set(jserving.aot._executables)
    for name in ("km", "pca"):
        m, jm = reg.resolve(name), jreg.resolve(name)
        assert aot.serve_dtypes(m) == [str(d)
                                       for d in jserving.aot.serve_dtypes(jm)]
    sizes = dispatcher.kernel_cache_sizes()
    assert set(sizes) == set(jserving.dispatcher._KERNELS)
    assert sum(sizes.values()) == aot.cache_size()
    # idempotent per signature, as the JAX warm is
    again = aot.warm([reg.resolve("km")], buckets=ladder)
    assert again == {"compiled": 0, "cached": 2 * len(ladder)}


def test_warmed_stream_has_zero_misses_and_counts(tenants, tmp_path):
    reg = serving.ModelRegistry(device="cpu")
    reg.register("km", tenants["km"][1], quantize=None)
    reg.register("pca", tenants["pca"][1], quantize=None)
    rec = obs.enable(str(tmp_path / "run.jsonl"))
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False,
                                     max_batch_rows=64)
    d.warm()
    dispatcher.pin_compile_budgets(0)
    for X in request_stream(n=60):
        d.submit("km", "predict", X)
        d.submit("pca", "transform", X)
    d.flush()
    stats = d.aot_stats()
    d.close()
    obs.disable()
    assert stats["misses"] == 0 and stats["hits"] > 0
    assert rec.counters["serving.aot_compiles"] == 3 * len(
        aot.bucket_ladder(8, 64))
    assert rec.counters["serving.aot_cache_hits"] == stats["hits"]
    assert "serving.aot_cache_misses" not in rec.counters


def test_pinned_budget_miss_raises_under_strict(tenants, monkeypatch):
    reg = serving.ModelRegistry(device="cpu")
    reg.register("km", tenants["km"][1], quantize=None)
    reg.warm(buckets=aot.bucket_ladder(8, 64))
    dispatcher.pin_compile_budgets(0)
    monkeypatch.setenv("SQ_OBS_STRICT", "1")
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False,
                                     max_batch_rows=64)
    ok = d.submit("km", "predict", np.zeros((5, 12), np.float32))
    # 100 rows pad past the warmed ladder to a bucket of 128: unwarmed
    bad = d.submit("km", "predict", np.zeros((100, 12), np.float32))
    d.flush()
    assert ok.result(timeout=5).shape == (5,)
    assert isinstance(bad.exception(timeout=5), dispatcher.AotCacheMissError)
    assert d.aot_stats() == {"hits": 1, "misses": 1}
    # without strict mode the miss is counted and served
    monkeypatch.setenv("SQ_OBS_STRICT", "0")
    assert d.serve("km", "predict",
                   np.zeros((100, 12), np.float32)).shape == (100,)
    # and unpinned, strict mode lets an unwarmed dispatch through
    dispatcher.pin_compile_budgets(None)
    monkeypatch.setenv("SQ_OBS_STRICT", "1")
    assert d.serve("km", "predict",
                   np.zeros((100, 12), np.float32)).shape == (100,)
    d.close()


def test_dispatcher_warm_uses_its_own_ladder(tenants):
    reg = serving.ModelRegistry(device="cpu")
    reg.register("km", tenants["km"][1], quantize=None)
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False,
                                     min_bucket_rows=4, max_batch_rows=32)
    d.warm()
    assert aot.cache_size() == 2 * len(aot.bucket_ladder(4, 32))
    assert aot.bucket_ladder(4, 32) == [4, 8, 16, 32]
    d.close()
