"""The port's out-of-core plane (``sq_learn_tpu_torch.oocore``) against the
JAX package's, on the CPU.

What is held, and how closely:

- **interchange, bit for bit**: a store written by either package opens
  in the other with the same manifest, fingerprint and rows, for both
  codecs; ``create_synthetic_store`` writes byte-identical manifests in
  both; the codec's payloads are the JAX package's bytes; ``EpochPlan``
  yields the same batches.
- **the fit against JAX's ``minibatch_epoch_fit``**: at δ=0 without
  reassignment, from the same explicit init, the port's centers hold the
  JAX host engine's at rtol 1e-5 / atol 1e-6 (float32 steps against its
  float64 count arithmetic), ``n_steps``/``n_epochs`` are equal,
  ``assign_labels`` gives equal labels and an inertia within rtol 1e-5.
  At δ>0 the draws differ: both sides reach ARI > 0.95 on the store's
  truth labels.
- **the port against itself, bit for bit**: disk against its in-RAM twin,
  prefetch depth 0 against 3, the read-fault matrix against the clean
  run, compressed against uncompressed, an interrupted or SIGKILL'd fit
  resumed against an uninterrupted one, the store qPCA fit against the
  streamed fit of the same array.
- **qPCA against JAX's store route**: the spectrum and components within
  the streamed-qPCA tolerance of ``tests/test_torch_qpca.py`` (rtol 1e-4,
  absolute floor 1e-4 × the largest entry).

Run as a script (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_oocore.py``, ~1 min, ~2 GB of disk under the system's
temporary directory) it prints the JAX package's float32 spectrum error on
its store route at 100 000, 200 000 and 400 000 × 784; the largest
(at 400 000 rows) is what ``chip_smoke.OOC_SPECTRUM_RTOL`` triples.
"""

import json
import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

from sq_learn_tpu import oocore as joo
from sq_learn_tpu import streaming as jstreaming
from sq_learn_tpu_torch import config_context, obs, oocore, streaming
from sq_learn_tpu_torch.metrics import adjusted_rand_score
from sq_learn_tpu_torch.oocore import (ArraySource, EpochPlan, RamBudgetError,
                                       ShardCorruptionError, _codec)
from sq_learn_tpu_torch.resilience import faults, supervisor
from sq_learn_tpu_torch.resilience.faults import (InjectedInterrupt,
                                                  InjectedReadError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(7)
#: 2003 rows in 16 KiB shards: 8 shards with a ragged tail (the JAX
#: package's test store)
X_TALL = (RNG.normal(size=(2003, 16)) + 1.0).astype(np.float32)
SHARD_BYTES = 16 * 1024
#: the scenario store and fit (the JAX package's ``oocore/smoke.py``)
STORE = dict(n_samples=6000, n_features=32, n_classes=6, seed=11)
FIT = dict(n_clusters=6, batch_rows=256, max_epochs=4, seed=5)
#: the fit parity tolerances against the JAX host engine (see above)
CENTERS_RTOL, CENTERS_ATOL, INERTIA_RTOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    supervisor.breaker.reset("test setup")
    with config_context(device="cpu"):
        yield
    faults.disarm()
    supervisor.breaker.reset("test teardown")
    if obs.enabled():
        obs.disable()


@pytest.fixture()
def store(tmp_path):
    return oocore.store_from_array(str(tmp_path / "store"), X_TALL,
                                   shard_bytes=SHARD_BYTES)


@pytest.fixture()
def cstore(tmp_path):
    return oocore.store_from_array(str(tmp_path / "cstore"), X_TALL,
                                   shard_bytes=SHARD_BYTES, codec="lz4")


@pytest.fixture()
def recorder(tmp_path):
    rec = obs.enable(str(tmp_path / "obs.jsonl"))
    yield rec
    obs.disable()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """The scenario store (6 000 × 32, 6 classes, 12 shards) and its truth
    labels: shard i's first draw, ``default_rng((seed, i))``."""
    path = str(tmp_path_factory.mktemp("scenario") / "store")
    st = oocore.create_synthetic_store(path, shard_bytes=64 * 1024, **STORE)
    y = np.concatenate([
        np.random.default_rng((STORE["seed"], i)).integers(
            0, STORE["n_classes"], size=rows)
        for i, rows in enumerate(st.shard_sizes)])
    return st, y


def _manifest(path):
    with open(os.path.join(path, "manifest.json"), "rb") as fh:
        return fh.read()


def _flip_tail(path):
    with open(path, "r+b") as fh:
        fh.seek(-16, os.SEEK_END)
        fh.write(b"\xff" * 16)


# -- interchange with the JAX package ----------------------------------------


@pytest.mark.parametrize("codec", ["none", "lz4"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_store_opens_in_the_other_package(tmp_path, codec, writer):
    build = (oocore if writer == "port" else joo).store_from_array
    read = (joo if writer == "port" else oocore).open_store
    built = build(str(tmp_path / "s"), X_TALL, shard_bytes=SHARD_BYTES,
                  codec=codec)
    other = read(str(tmp_path / "s"))
    assert other.fingerprint == built.fingerprint
    assert other.manifest == built.manifest
    assert other.codec == codec and other.shape == (2003, 16)
    np.testing.assert_array_equal(other.read_rows(0, 2003), X_TALL)
    np.testing.assert_array_equal(built.read_rows(0, 2003), X_TALL)
    # and both packages write the same bytes for the same array
    twin = (joo if writer == "port" else oocore).store_from_array(
        str(tmp_path / "twin"), X_TALL, shard_bytes=SHARD_BYTES, codec=codec)
    assert _manifest(twin.path) == _manifest(built.path)


@pytest.mark.parametrize("kind,codec", [("gaussian", "none"),
                                        ("gaussian", "lz4"),
                                        ("pixels", "none"),
                                        ("pixels", "lz4")])
def test_synthetic_manifests_are_byte_identical(tmp_path, kind, codec):
    kw = dict(n_classes=4, seed=3, shard_bytes=8 * 1024, codec=codec,
              kind=kind)
    ours = oocore.create_synthetic_store(str(tmp_path / "p"), 400, 49, **kw)
    theirs = joo.create_synthetic_store(str(tmp_path / "j"), 400, 49, **kw)
    assert _manifest(ours.path) == _manifest(theirs.path)
    assert ours.fingerprint == theirs.fingerprint
    np.testing.assert_array_equal(ours.read_rows(0, 400),
                                  theirs.read_rows(0, 400))


def test_float64_input_is_written_at_32_bits_and_either_width_reads(
        tmp_path):
    X64 = X_TALL.astype(np.float64)
    st = oocore.store_from_array(str(tmp_path / "a"), X64,
                                 shard_bytes=SHARD_BYTES)
    assert st.dtype == np.float32
    assert st.manifest == joo.store_from_array(
        str(tmp_path / "j"), X64, shard_bytes=SHARD_BYTES).manifest
    with config_context(default_dtype="float64"):
        wide = oocore.store_from_array(str(tmp_path / "w"), X64,
                                       shard_bytes=SHARD_BYTES)
    assert wide.dtype == np.float64
    back = oocore.open_store(wide.path)
    np.testing.assert_array_equal(back.read_rows(0, 2003), X64)
    # the streaming engine stages a float64 store's tiles at float32
    _, G64, _ = streaming.streamed_centered_gram(back, max_bytes=32 * 1024)
    _, G32, _ = streaming.streamed_centered_gram(st, max_bytes=32 * 1024)
    assert G64.dtype == G32.dtype
    np.testing.assert_allclose(G64.numpy(), G32.numpy(), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("epoch,start", [(0, 0), (1, 0), (2, 3)])
def test_epoch_plan_matches_jax(store, epoch, start):
    ours, theirs = EpochPlan(seed=5, batch_rows=300), \
        joo.EpochPlan(seed=5, batch_rows=300)
    np.testing.assert_array_equal(ours.shard_order(store, epoch),
                                  theirs.shard_order(store, epoch))
    assert ours.host_partition(store, epoch, 3, 1) == \
        theirs.host_partition(store, epoch, 3, 1)
    a = list(ours.iter_batches(store, epoch, start))
    b = list(theirs.iter_batches(store, epoch, start))
    assert [i for i, _ in a] == [i for i, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_package_surface_matches_jax():
    assert sorted(oocore.__all__) == sorted(joo.__all__)


# -- the codec ----------------------------------------------------------------


def _codec_arrays():
    rng = np.random.default_rng(6)
    pixels = (rng.integers(0, 255, (300, 28)) / 255.0).astype(np.float32)
    pixels[rng.random(pixels.shape) < 0.7] = 0.0
    return {
        "pixels": pixels,
        "gauss": rng.normal(size=(200, 33)).astype(np.float32),
        "noise_u8": rng.integers(0, 256, (64, 127), dtype=np.uint8),
        "zeros": np.zeros((100, 7), np.float32),
        "empty": np.empty((0, 5), np.float32),
        "f64": rng.normal(size=(100,)).astype(np.float64),
        "int32": rng.integers(0, 2**31, (50, 3)).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(_codec_arrays()))
def test_codec_payloads_are_the_jax_packages_bytes(name):
    from sq_learn_tpu import native

    arr = _codec_arrays()[name]
    payload = _codec.compress_array(arr)
    assert payload == native.compress_array(arr)
    assert payload[0] in (0, 1, 2)  # plain / shuffled / raw
    back = _codec.decompress_array(payload, arr.dtype, arr.shape)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    assert _codec.crc32(arr) == native.crc32(arr)


def test_codec_compresses_pixels_and_caps_noise():
    arrays = _codec_arrays()
    pixels, noise = arrays["pixels"], arrays["noise_u8"]
    assert len(_codec.compress_array(pixels)) < 0.7 * pixels.nbytes
    assert len(_codec.compress_array(noise)) <= noise.nbytes + 1


def test_lz4_block_round_trip_and_malformed_input():
    from sq_learn_tpu import native

    data = (b"abcabcabcabcabcabcabc" * 40) + bytes(range(256))
    comp = _codec.lz4_compress(data)
    assert comp == native.lz4_compress(data)
    assert len(comp) <= _codec.lz4_bound(len(data))
    assert _codec.lz4_decompress(comp, len(data)).tobytes() == data
    with pytest.raises(ValueError):
        _codec.lz4_decompress(comp, len(data) + 1)
    with pytest.raises(ValueError):
        _codec.lz4_decompress(b"\x01", 0)
    # flipped bytes raise or decode to other bytes, never overrun
    for i in range(min(len(comp), 8)):
        bad = bytearray(comp)
        bad[i] ^= 0xFF
        try:
            _codec.lz4_decompress(bytes(bad), len(data))
        except ValueError:
            pass


def test_byte_shuffle_inverse_and_size_mismatch():
    arr = np.random.default_rng(7).normal(size=(41, 7)).astype(np.float32)
    planes = _codec.byte_shuffle(arr)
    assert planes.size == arr.nbytes
    back = _codec.byte_unshuffle(planes, arr.dtype.itemsize)
    np.testing.assert_array_equal(back.view(arr.dtype).reshape(arr.shape),
                                  arr)
    with pytest.raises(ValueError):
        _codec.byte_unshuffle(np.zeros(7, np.uint8), 4)
    payload = _codec.compress_array(np.arange(64, dtype=np.float32))
    with pytest.raises(ValueError):
        _codec.decompress_array(payload, np.float32, (65,))
    with pytest.raises(ValueError):
        _codec.decompress_array(b"", np.float32, (64,))
    with pytest.raises(ValueError):
        _codec.decompress_array(bytes([9]) + payload[1:], np.float32, (64,))


# -- the store ----------------------------------------------------------------


class TestShardStore:
    def test_create_open_roundtrip(self, tmp_path):
        st = oocore.create_synthetic_store(
            str(tmp_path / "syn"), 1500, 12, n_classes=3, seed=9,
            shard_bytes=8 * 1024)
        st2 = oocore.open_store(str(tmp_path / "syn"))
        assert st2.fingerprint == st.fingerprint
        assert st2.shape == (1500, 12) and st2.dtype == np.float32
        np.testing.assert_array_equal(st2.read_rows(0, 1500),
                                      st.read_rows(0, 1500))

    def test_synthetic_rebuild_is_bit_identical(self, tmp_path):
        a = oocore.create_synthetic_store(
            str(tmp_path / "a"), 800, 8, seed=4, shard_bytes=4 * 1024)
        b = oocore.create_synthetic_store(
            str(tmp_path / "b"), 800, 8, seed=4, shard_bytes=4 * 1024)
        assert a.fingerprint == b.fingerprint
        assert _manifest(a.path) == _manifest(b.path)

    @pytest.mark.parametrize("lo,hi", [(0, 2003), (250, 600), (700, 701),
                                       (1900, 2003)])
    def test_read_rows_across_shards(self, store, lo, hi):
        np.testing.assert_array_equal(store.read_rows(lo, hi), X_TALL[lo:hi])
        np.testing.assert_array_equal(store[lo:hi], X_TALL[lo:hi])

    def test_take_gather(self, store):
        idx = np.array([0, 255, 256, 1024, 2002])
        np.testing.assert_array_equal(store.take(idx), X_TALL[idx])

    def test_fingerprint_is_content_complete(self, tmp_path):
        Xm = X_TALL.copy()
        sampled = np.unique(np.linspace(0, 2002, num=64, dtype=np.int64))
        row = next(r for r in range(2003) if r not in sampled)
        Xm[row, 3] += 1.0
        assert streaming._data_digest(Xm) == streaming._data_digest(X_TALL)
        a = oocore.store_from_array(str(tmp_path / "a"), X_TALL,
                                    shard_bytes=SHARD_BYTES)
        b = oocore.store_from_array(str(tmp_path / "b"), Xm,
                                    shard_bytes=SHARD_BYTES)
        assert a.fingerprint != b.fingerprint

    def test_on_disk_corruption_quarantines_and_raises(self, store):
        _flip_tail(store._shard_path(2))
        with pytest.raises(ShardCorruptionError, match="shard 2"):
            store.read_shard(2)
        assert 2 in store.quarantined

    def test_verify_off_trusts_bytes(self, store, monkeypatch):
        _flip_tail(store._shard_path(1))
        monkeypatch.setenv("SQ_OOC_VERIFY", "off")
        store.read_shard(1)  # no CRC pass, no raise: the documented opt-out
        monkeypatch.setenv("SQ_OOC_VERIFY", "sometimes")
        with pytest.raises(ValueError, match="SQ_OOC_VERIFY"):
            store.read_shard(1)

    def test_ram_budget_guard(self, store, monkeypatch):
        monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES",
                           str(store.nbytes // 4))
        with pytest.raises(RamBudgetError):
            store.read_rows(0, store.shape[0])
        with pytest.raises(RamBudgetError):
            store.take(np.arange(2003))
        np.testing.assert_array_equal(store.read_shard(0),
                                      X_TALL[:store.shard_sizes[0]])

    def test_store_slicing_rejects_gather_keys(self, store):
        with pytest.raises(TypeError):
            store[np.array([1, 2, 3])]
        with pytest.raises(TypeError):
            store[::2]

    def test_var_mean_and_source_protocol(self, store):
        assert store.var_mean() == pytest.approx(
            float(np.mean(np.var(X_TALL.astype(np.float64), axis=0))),
            rel=1e-9)
        assert oocore.is_source(store) and streaming.is_row_source(store)
        assert not oocore.is_source(X_TALL)
        twin = ArraySource(X_TALL, shard_rows=store.shard_sizes[0])
        assert twin.shard_sizes == store.shard_sizes
        assert twin.var_mean() == pytest.approx(store.var_mean(), rel=1e-9)


# -- read faults --------------------------------------------------------------


class TestReadFaults:
    def test_transient_read_failure_recovers_with_parity(self, store,
                                                         recorder):
        faults.arm("read_fail:tiles=1,times=1")
        arr = store.read_shard(1)
        plan = faults.disarm()
        assert any(ev["kind"] == "read_fail" for ev in plan.events)
        np.testing.assert_array_equal(
            arr, X_TALL[store.shard_sizes[0]:2 * store.shard_sizes[0]])
        assert recorder.counters.get("resilience.retries", 0) >= 1

    def test_read_failures_exhaust_to_terminal(self, store, monkeypatch):
        monkeypatch.setenv("SQ_RETRY_MAX", "1")
        monkeypatch.setenv("SQ_RETRY_BACKOFF_S", "0.001")
        faults.arm("read_fail:tiles=0,times=10")
        with pytest.raises(InjectedReadError):
            store.read_shard(0)

    def test_read_failures_trip_the_breaker(self, scenario, monkeypatch):
        """K consecutive read failures open the breaker: a store fit then
        raises BreakerOpenError, and nothing runs in the device's
        place."""
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        monkeypatch.setenv("SQ_RETRY_BACKOFF_S", "0.001")
        st, _ = scenario
        faults.arm("read_fail:p=1,times=10")
        with pytest.raises(supervisor.BreakerOpenError, match="open"):
            MiniBatchQKMeans(n_clusters=6, batch_size=256, max_iter=1,
                             delta=0.5, random_state=0).fit(
                oocore.open_store(st.path))
        assert supervisor.breaker.state() == supervisor.OPEN

    def test_corrupt_shard_quarantine_then_reread_recovers(self, store,
                                                           recorder):
        faults.arm("corrupt_shard:tiles=3,times=1")
        arr = store.read_shard(3)
        plan = faults.disarm()
        assert any(ev["kind"] == "corrupt_shard" for ev in plan.events)
        lo = 3 * store.shard_sizes[0]
        np.testing.assert_array_equal(arr,
                                      X_TALL[lo:lo + store.shard_sizes[3]])
        assert 3 not in store.quarantined
        assert recorder.counters.get("oocore.crc_failures", 0) >= 1
        assert recorder.counters.get("oocore.rereads", 0) >= 1

    def test_persistent_corruption_exhausts_rereads(self, store,
                                                    monkeypatch):
        monkeypatch.setenv("SQ_OOC_REREAD_MAX", "1")
        faults.arm("corrupt_shard:tiles=0,times=10")
        with pytest.raises(ShardCorruptionError, match="shard 0"):
            store.read_shard(0)
        assert 0 in store.quarantined

    def test_read_stall_past_deadline_feeds_breaker(self, store,
                                                    monkeypatch):
        monkeypatch.setenv("SQ_TILE_DEADLINE_S", "0.01")
        faults.arm("read_stall:tiles=0,times=1,s=0.05")
        store.read_shard(0)  # the data arrives, but counts as a timeout
        assert supervisor.breaker.consecutive_failures >= 1

    def test_stream_fold_over_store_absorbs_read_faults(self, store):
        _, G_ref, _ = streaming.streamed_centered_gram(X_TALL,
                                                       max_bytes=32 * 1024)
        faults.arm("read_fail:tiles=2,times=1;corrupt_shard:tiles=4,times=1")
        _, G, _ = streaming.streamed_centered_gram(store, max_bytes=32 * 1024)
        np.testing.assert_array_equal(G.numpy(), G_ref.numpy())


# -- the streaming engine over stores -----------------------------------------


class TestStreamingOverStores:
    def test_stream_tiles_read_a_store_like_its_array(self, store):
        a = list(streaming.stream_tiles(store, 20 * 1024))
        b = list(streaming.stream_tiles(X_TALL, 20 * 1024))
        assert len(a) == len(b) > 1
        for (ta, va, sa), (tb, vb, sb) in zip(a, b):
            assert (va, sa) == (vb, sb)
            np.testing.assert_array_equal(ta.numpy(), tb.numpy())

    def test_resumed_tiles_never_read_earlier_shards(self, store,
                                                     monkeypatch):
        reads = []
        real = oocore.ShardStore.read_shard

        def spy(self, i):
            reads.append(int(i))
            return real(self, i)

        monkeypatch.setattr(oocore.ShardStore, "read_shard", spy)
        monkeypatch.setenv("SQ_OOC_PREFETCH_DEPTH", "2")
        tiles = list(streaming.stream_tiles(store, 32 * 1024, start_tile=2))
        assert tiles[0][2] == 2 * 512  # 512 rows a tile
        assert min(reads) == 1024 // store.shard_sizes[0]

    def test_store_fold_resumes_bit_equal(self, store, tmp_path):
        ck = str(tmp_path / "gram.npz")
        step = streaming._gram_colsum_step
        init = lambda: (streaming.torch.zeros((16, 16)),  # noqa: E731
                        streaming.torch.zeros(16))
        ref = streaming.stream_fold(store, step, init(), max_bytes=8 * 1024,
                                    site="t.gram")
        faults.arm("abort:tile=5,times=1")
        with pytest.raises(InjectedInterrupt):
            streaming.stream_fold(store, step, init(), max_bytes=8 * 1024,
                                  site="t.gram",
                                  checkpoint=streaming.StreamCheckpoint(ck, 2))
        faults.disarm()
        # the snapshot is keyed on the store's fingerprint
        with np.load(ck) as npz:
            assert f"store:{store.fingerprint}" in str(npz["__fingerprint__"])
        out = streaming.stream_fold(store, step, init(), max_bytes=8 * 1024,
                                    site="t.gram",
                                    checkpoint=streaming.StreamCheckpoint(ck,
                                                                          2))
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not os.path.exists(ck)

    def test_centered_svd_topk_of_a_store(self, store):
        a = streaming.streamed_centered_svd_topk(store, 3,
                                                 max_bytes=32 * 1024)
        b = streaming.streamed_centered_svd_topk(X_TALL, 3,
                                                 max_bytes=32 * 1024)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())

    def test_store_gram_holds_the_jax_store_gram(self, store):
        _, G, _ = streaming.streamed_centered_gram(store, max_bytes=32 * 1024)
        _, Gj, _ = jstreaming.streamed_centered_gram(
            joo.open_store(store.path), max_bytes=32 * 1024)
        Gj = np.asarray(Gj)
        np.testing.assert_allclose(G.numpy(), Gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(Gj).max()))


# -- the epoch engine ---------------------------------------------------------


class TestEpochEngine:
    def test_epoch_covers_every_row_exactly_once(self, store):
        plan = EpochPlan(seed=3, batch_rows=300)
        for epoch in (0, 1):
            seen = np.concatenate(
                [b[:, 0] for _, b in plan.iter_batches(store, epoch)])
            assert seen.shape[0] == 2003
            np.testing.assert_array_equal(np.sort(seen),
                                          np.sort(X_TALL[:, 0]))

    def test_epochs_shuffle_differently(self, store):
        plan = EpochPlan(seed=3, batch_rows=300)
        b0 = next(iter(plan.iter_batches(store, 0)))[1]
        b1 = next(iter(plan.iter_batches(store, 1)))[1]
        assert not np.array_equal(b0, b1)
        with pytest.raises(ValueError):
            EpochPlan(batch_rows=0)

    def test_resume_replays_identical_batches(self, store):
        plan = EpochPlan(seed=5, batch_rows=256)
        full = [b for _, b in plan.iter_batches(store, 2)]
        tail = [b for _, b in plan.iter_batches(store, 2, start_batch=4)]
        assert len(tail) == len(full) - 4
        for a, b in zip(full[4:], tail):
            np.testing.assert_array_equal(a, b)

    def test_disk_vs_ram_source_fit_bit_parity(self, store):
        kw = dict(n_clusters=5, batch_rows=256, max_epochs=3, seed=11)
        disk = oocore.minibatch_epoch_fit(store, **kw)
        ram = oocore.minibatch_epoch_fit(
            ArraySource(X_TALL, shard_rows=store.shard_sizes[0]), **kw)
        np.testing.assert_array_equal(disk["centers"], ram["centers"])
        np.testing.assert_array_equal(disk["counts"], ram["counts"])
        assert disk["n_steps"] == ram["n_steps"] == 3 * 8

    @pytest.mark.parametrize("window", [0.0, 0.5])
    def test_interrupt_then_resume_bitwise_parity(self, store, tmp_path,
                                                  monkeypatch, window):
        monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "2")
        ck = str(tmp_path / "mb.npz")
        kw = dict(n_clusters=4, batch_rows=256, max_epochs=3, seed=1,
                  window=window)
        ref = oocore.minibatch_epoch_fit(store, **kw)
        faults.arm("abort:tile=9,times=1")  # mid-epoch 2
        with pytest.raises(InjectedInterrupt):
            oocore.minibatch_epoch_fit(store, checkpoint=ck, **kw)
        faults.disarm()
        assert os.path.exists(ck)
        out = oocore.minibatch_epoch_fit(store, checkpoint=ck, **kw)
        assert out["resumed_from"] >= 1
        np.testing.assert_array_equal(out["centers"], ref["centers"])
        np.testing.assert_array_equal(out["counts"], ref["counts"])
        assert (out["n_steps"], out["ewa"]) == (ref["n_steps"], ref["ewa"])
        assert not os.path.exists(ck) and not os.path.exists(ck + ".prev")

    def test_mutated_store_invalidates_checkpoint(self, store, tmp_path,
                                                  monkeypatch):
        monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "2")
        ck = str(tmp_path / "mb.npz")
        kw = dict(n_clusters=4, batch_rows=256, max_epochs=2, seed=1)
        faults.arm("abort:tile=5,times=1")
        with pytest.raises(InjectedInterrupt):
            oocore.minibatch_epoch_fit(store, checkpoint=ck, **kw)
        faults.disarm()
        store2 = oocore.store_from_array(str(tmp_path / "resharded"), X_TALL,
                                         shard_bytes=2 * SHARD_BYTES)
        out = oocore.minibatch_epoch_fit(store2, checkpoint=ck, **kw)
        assert out["resumed_from"] == 0

    def test_a_jax_snapshot_never_resumes_a_port_fit(self, store, tmp_path,
                                                     monkeypatch):
        monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "2")
        ck = str(tmp_path / "mb.npz")
        kw = dict(n_clusters=4, batch_rows=256, max_epochs=2, seed=1)
        from sq_learn_tpu.resilience import faults as jfaults

        jfaults.arm("abort:tile=5,times=1")
        try:
            with pytest.raises(jfaults.InjectedInterrupt):
                joo.minibatch_epoch_fit(joo.open_store(store.path),
                                        checkpoint=ck, **kw)
        finally:
            jfaults.disarm()
        assert os.path.exists(ck)
        assert oocore.minibatch_epoch_fit(store, checkpoint=ck,
                                          **kw)["resumed_from"] == 0

    @pytest.mark.parametrize("max_no_improvement", [None, 10])
    def test_delta_0_fit_matches_jax_epoch_fit(self, scenario,
                                               max_no_improvement):
        st, _ = scenario
        X = st.read_rows(0, st.shape[0])
        init = X[np.random.default_rng(0).choice(X.shape[0], 6,
                                                 replace=False)]
        kw = dict(FIT, window=0.0, reassignment_ratio=0.0, init=init,
                  max_no_improvement=max_no_improvement)
        ours = oocore.minibatch_epoch_fit(st, **kw)
        theirs = joo.minibatch_epoch_fit(joo.open_store(st.path), **kw)
        np.testing.assert_allclose(ours["centers"], theirs["centers"],
                                   rtol=CENTERS_RTOL, atol=CENTERS_ATOL)
        np.testing.assert_array_equal(ours["counts"], theirs["counts"])
        assert (ours["n_steps"], ours["n_epochs"]) == \
            (theirs["n_steps"], theirs["n_epochs"])
        assert ours["ewa"] == pytest.approx(theirs["ewa"], rel=INERTIA_RTOL)
        lab, inertia = oocore.assign_labels(st, ours["centers"],
                                            batch_rows=1024)
        jlab, jinertia = joo.assign_labels(joo.open_store(st.path),
                                           theirs["centers"],
                                           batch_rows=1024)
        np.testing.assert_array_equal(lab, jlab)
        assert inertia == pytest.approx(jinertia, rel=INERTIA_RTOL)

    def test_delta_fit_recovers_the_classes_on_both_sides(self, scenario):
        st, y = scenario
        kw = dict(FIT, window=0.5)
        ours = oocore.minibatch_epoch_fit(st, **kw)
        theirs = joo.minibatch_epoch_fit(joo.open_store(st.path), **kw)
        lab, _ = oocore.assign_labels(st, ours["centers"])
        jlab, _ = joo.assign_labels(joo.open_store(st.path),
                                    theirs["centers"])
        assert adjusted_rand_score(y, lab) > 0.95
        assert adjusted_rand_score(y, jlab) > 0.95

    def test_assign_labels_launches_one_lloyd_step_per_tile(self, scenario,
                                                            monkeypatch):
        """One ``lloyd_step`` call at (batch_rows, m), k, R=1 per tile,
        the tail padded to its bucket at weight 0; the labels are the
        plain nearest-center labels."""
        from sq_learn_tpu_torch.ops import kernels

        st, _ = scenario
        centers = st.read_rows(0, 6)
        shapes = []
        real = kernels.lloyd_step

        def spy(X, w, xsq, C, **kw):
            shapes.append((tuple(X.shape), tuple(C.shape),
                           float(w.sum()), kw.get("window", 0.0)))
            return real(X, w, xsq, C, **kw)

        monkeypatch.setattr(kernels, "lloyd_step", spy)
        lab, inertia = oocore.assign_labels(st, centers, batch_rows=1024)
        assert len(shapes) == -(-6000 // 1024)
        assert {s[0] for s in shapes} == {(1024, 32)}
        assert {s[1] for s in shapes} == {(1, 6, 32)}
        assert sum(s[2] for s in shapes) == 6000
        assert {s[3] for s in shapes} == {0.0}
        X = st.read_rows(0, 6000).astype(np.float64)
        d2 = ((X[:, None, :] - centers[None].astype(np.float64)) ** 2).sum(-1)
        np.testing.assert_array_equal(lab, d2.argmin(1))
        assert inertia == pytest.approx(float(d2.min(1).sum()), rel=1e-5)


# -- the estimators -----------------------------------------------------------


class TestEstimatorSurfaces:
    def test_minibatch_store_fit_matches_source_twin(self, store):
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        kw = dict(n_clusters=5, batch_size=256, max_iter=3, random_state=3)
        with pytest.warns(UserWarning, match="classic"):
            disk = MiniBatchQKMeans(**kw).fit(store)
        with pytest.warns(UserWarning, match="classic"):
            mem = MiniBatchQKMeans(**kw).fit(
                ArraySource(X_TALL, shard_rows=store.shard_sizes[0]))
        np.testing.assert_array_equal(disk.cluster_centers_,
                                      mem.cluster_centers_)
        assert disk.n_steps_ == mem.n_steps_ > 0
        assert disk.labels_.shape == (2003,)
        assert disk.counts_.dtype == np.float32
        with pytest.warns(UserWarning, match="classic"):
            ram = MiniBatchQKMeans(**kw).fit(X_TALL)
        assert disk.inertia_ <= 1.5 * ram.inertia_

    def test_minibatch_store_delta_means_against_jax(self, scenario):
        from sq_learn_tpu.models import MiniBatchQKMeans as JaxMiniBatch
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        st, y = scenario
        kw = dict(n_clusters=6, batch_size=256, max_iter=3, delta=0.5,
                  random_state=0)
        ours = MiniBatchQKMeans(**kw).fit(st)
        theirs = JaxMiniBatch(**kw).fit(joo.open_store(st.path))
        assert ours.cluster_centers_.shape == (6, 32)
        assert ours.n_steps_ == theirs.n_steps_ == 3 * 24
        assert adjusted_rand_score(y, ours.labels_) > 0.95
        assert adjusted_rand_score(y, theirs.labels_) > 0.95
        assert ours.inertia_ == pytest.approx(theirs.inertia_, rel=0.1)

    def test_minibatch_store_rejects_unsupported(self, store):
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        with pytest.raises(ValueError, match="sample_weight"):
            MiniBatchQKMeans(n_clusters=3).fit(store,
                                               sample_weight=np.ones(2003))
        with pytest.raises(ValueError, match="sample_weight"):
            MiniBatchQKMeans(n_clusters=3).partial_fit(
                store, sample_weight=np.ones(2003))
        with pytest.raises(ValueError, match="IPE"):
            MiniBatchQKMeans(n_clusters=3, delta=0.2,
                             true_distance_estimate=True).fit(store)
        with pytest.raises(ValueError, match="k-means"):
            MiniBatchQKMeans(n_clusters=3, init="random",
                             delta=0.2).fit(store)
        fitted = MiniBatchQKMeans(n_clusters=3, delta=0.2, max_iter=1,
                                  random_state=0).fit(store)
        with pytest.raises(ValueError, match="assign_labels"):
            fitted.predict(store)

    def test_minibatch_partial_fit_epochs_over_store(self, store):
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        est = MiniBatchQKMeans(n_clusters=4, batch_size=256, delta=0.3,
                               random_state=0)
        est.partial_fit(store)
        steps1 = est.n_steps_
        c1 = est.cluster_centers_.copy()
        est.partial_fit(store)
        assert est.n_steps_ == 2 * steps1 == 16
        assert not np.array_equal(c1, est.cluster_centers_)
        assert est.predict(X_TALL[:7]).shape == (7,)
        assert est.labels_.shape == (2003,)
        with pytest.raises(ValueError, match="features"):
            est.partial_fit(oocore.store_from_array(
                os.path.join(store.path, "..", "narrow"), X_TALL[:, :8]))

    def test_store_seed_of_a_non_integral_random_state(self):
        import torch

        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        gen = torch.Generator().manual_seed(1234)
        assert MiniBatchQKMeans(random_state=gen)._store_seed() == 1234
        assert MiniBatchQKMeans(random_state=7)._store_seed() == 7
        rs = np.random.RandomState(0)
        assert MiniBatchQKMeans(random_state=rs)._store_seed() == \
            np.random.RandomState(0).randint(0, 2**31 - 1)

    def test_qpca_store_fit_bit_matches_streamed_array(self, store):
        from sq_learn_tpu_torch.models import QPCA

        disk = QPCA(n_components=3, random_state=0).fit(store)
        assert disk.ingest_ == "streamed" and disk._fit_svd_solver == "full"
        ram = QPCA(n_components=3, random_state=0, svd_solver="full",
                   ingest="streamed").fit(X_TALL)
        np.testing.assert_array_equal(disk.components_, ram.components_)
        np.testing.assert_array_equal(disk.singular_values_,
                                      ram.singular_values_)
        np.testing.assert_array_equal(disk.left_sv, ram.left_sv)
        assert disk.transform(X_TALL[:5]).shape == (5, 3)

    def test_qpca_store_fit_holds_the_jax_store_fit(self, store):
        from sq_learn_tpu.models import QPCA as JaxQPCA
        from sq_learn_tpu_torch.models import QPCA

        ours = QPCA(n_components=3, random_state=0).fit(store)
        theirs = JaxQPCA(n_components=3, random_state=0).fit(
            joo.open_store(store.path))
        assert theirs.ingest_ == "streamed"
        for name in ("singular_values_", "explained_variance_", "mean_",
                     "components_"):
            b = np.asarray(getattr(theirs, name))
            np.testing.assert_allclose(getattr(ours, name), b, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()),
                                       err_msg=name)

    def test_qpca_store_rejects_structural_misfits(self, store):
        from sq_learn_tpu_torch.models import QPCA

        with pytest.raises(ValueError, match="partial-U Gram route"):
            QPCA(n_components=3, random_state=0).fit(
                store, theta_estimate=True, eps=0.1)
        with pytest.raises(ValueError, match="monolithic"):
            QPCA(n_components=3, ingest="monolithic",
                 random_state=0).fit(store)
        short = oocore.store_from_array(
            os.path.join(store.path, "..", "short"), X_TALL[:100])
        with pytest.raises(ValueError, match="partial-U Gram route"):
            QPCA(n_components=3, random_state=0).fit(short)  # n < 8·m
        # a store with a mesh: the JAX package's ValueError (item 6a)
        from sq_learn_tpu_torch.parallel import make_mesh

        with pytest.raises(ValueError, match="single-device"):
            QPCA(n_components=3, mesh=make_mesh(["cpu"] * 2)).fit(store)


# -- a real SIGKILL -----------------------------------------------------------

_CHILD = """
import sys
import numpy as np
import sq_learn_tpu_torch as sqt
from sq_learn_tpu_torch import oocore
sqt.set_config(device="cpu")
out = oocore.minibatch_epoch_fit(oocore.open_store(sys.argv[1]),
                                 **eval(sys.argv[3]))
np.savez(sys.argv[2], centers=out["centers"], counts=out["counts"],
         n_steps=out["n_steps"], resumed_from=out["resumed_from"])
"""


def test_sigkill_mid_epoch_then_resume_bit_parity(tmp_path):
    """A real SIGKILL of a child process mid-epoch, then a clean rerun that
    resumes from the mid-epoch snapshot and finishes with the bits of an
    uninterrupted fit (on the compressed store, prefetch on, as the JAX
    package's smoke does it)."""
    kw = dict(FIT, window=0.5)
    cpath = str(tmp_path / "cstore")
    cstore = oocore.create_synthetic_store(cpath, shard_bytes=64 * 1024,
                                           codec="lz4", **STORE)
    reference = oocore.minibatch_epoch_fit(cstore, **kw)
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    out_path = str(tmp_path / "resumed.npz")
    env = dict(os.environ, PYTHONPATH=REPO, SQ_STREAM_CKPT_DIR=ckpt_dir,
               SQ_STREAM_CKPT_EVERY="2", SQ_OOC_PREFETCH_DEPTH="2",
               SQ_FAULTS="read_stall:p=1,s=0.1,times=999")
    cmd = [sys.executable, "-c", _CHILD, cpath, out_path, repr(kw)]
    with open(tmp_path / "child.log", "w") as log:
        child = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and child.poll() is None:
            if any(f.endswith(".npz") and not f.endswith(".tmp.npz")
                   for f in os.listdir(ckpt_dir)):
                break
            time.sleep(0.01)
        alive = child.poll() is None
        child.send_signal(signal.SIGKILL)
        child.wait()
    assert alive, (tmp_path / "child.log").read_text()
    assert child.returncode == -signal.SIGKILL
    assert any(f.endswith(".npz") for f in os.listdir(ckpt_dir))
    assert not os.path.exists(out_path)
    env.pop("SQ_FAULTS")
    done = subprocess.run(cmd, env=env, timeout=600, capture_output=True,
                          text=True)
    assert done.returncode == 0, done.stderr
    with np.load(out_path) as npz:
        assert int(npz["resumed_from"]) >= 2
        np.testing.assert_array_equal(npz["centers"], reference["centers"])
        np.testing.assert_array_equal(npz["counts"], reference["counts"])
        assert int(npz["n_steps"]) == reference["n_steps"]
    assert not os.listdir(ckpt_dir)


# -- prefetch -----------------------------------------------------------------


class TestPrefetch:
    def _depth(self, monkeypatch, d):
        monkeypatch.setenv("SQ_OOC_PREFETCH_DEPTH", str(d))

    def test_engine_depth_parity(self, store, monkeypatch):
        kw = dict(n_clusters=5, batch_rows=256, max_epochs=3, seed=11,
                  window=0.3)
        self._depth(monkeypatch, 0)
        serial = oocore.minibatch_epoch_fit(store, **kw)
        self._depth(monkeypatch, 3)
        deep = oocore.minibatch_epoch_fit(store, **kw)
        np.testing.assert_array_equal(serial["centers"], deep["centers"])
        np.testing.assert_array_equal(serial["counts"], deep["counts"])

    def test_stream_fold_depth_parity(self, store, monkeypatch):
        self._depth(monkeypatch, 0)
        _, G0, _ = streaming.streamed_centered_gram(store,
                                                    max_bytes=32 * 1024)
        self._depth(monkeypatch, 2)
        _, G2, _ = streaming.streamed_centered_gram(store,
                                                    max_bytes=32 * 1024)
        np.testing.assert_array_equal(G0.numpy(), G2.numpy())

    def test_estimator_depth_parity(self, store, monkeypatch):
        from sq_learn_tpu_torch.models import QPCA, MiniBatchQKMeans

        kw = dict(n_clusters=5, batch_size=256, max_iter=3, random_state=3,
                  delta=0.3)
        self._depth(monkeypatch, 0)
        mb0 = MiniBatchQKMeans(**kw).fit(store)
        q0 = QPCA(n_components=3, random_state=0).fit(store)
        self._depth(monkeypatch, 3)
        mb3 = MiniBatchQKMeans(**kw).fit(store)
        q3 = QPCA(n_components=3, random_state=0).fit(store)
        np.testing.assert_array_equal(mb0.cluster_centers_,
                                      mb3.cluster_centers_)
        np.testing.assert_array_equal(mb0.labels_, mb3.labels_)
        np.testing.assert_array_equal(q0.components_, q3.components_)
        np.testing.assert_array_equal(q0.singular_values_,
                                      q3.singular_values_)

    @pytest.mark.parametrize("spec", [
        "read_fail:tiles=1,times=1",
        "read_stall:tiles=2,times=1,s=0.02",
        "corrupt_shard:tiles=3,times=1",
        "cold_tier:s=0.005,per_mb=0.1",
    ])
    def test_fault_matrix_under_prefetch(self, store, recorder, monkeypatch,
                                         spec):
        """Each read injector at depth 3 is absorbed bit for bit."""
        kw = dict(n_clusters=4, batch_rows=256, max_epochs=2, seed=1,
                  window=0.5)
        self._depth(monkeypatch, 0)
        ref = oocore.minibatch_epoch_fit(store, **kw)
        self._depth(monkeypatch, 3)
        plan = faults.arm(spec)
        out = oocore.minibatch_epoch_fit(oocore.open_store(store.path), **kw)
        faults.disarm()
        assert spec.split(":")[0] in {ev["kind"] for ev in plan.events}
        np.testing.assert_array_equal(out["centers"], ref["centers"])
        np.testing.assert_array_equal(out["counts"], ref["counts"])
        assert recorder.counters.get("oocore.prefetch_hits", 0) \
            + recorder.counters.get("oocore.prefetch_stalls", 0) >= 1

    def test_worker_read_stall_feeds_breaker_thread_safely(self, store,
                                                           monkeypatch):
        """Stalled reads on the workers count as timeouts like reads on
        the consumer: the breaker trips from the worker threads, and then
        (no CPU escape in the port) the next read raises BreakerOpenError
        at the shard it belongs to; the shards read before it serve."""
        from sq_learn_tpu_torch.oocore.prefetch import iter_shards

        monkeypatch.setenv("SQ_TILE_DEADLINE_S", "0.01")
        trips0 = supervisor.breaker.trips
        faults.arm("read_stall:p=1,s=0.05,times=1")
        arrs = []
        with pytest.raises(supervisor.BreakerOpenError,
                           match="oocore.read_shard"):
            for arr in iter_shards(store, range(store.n_shards), depth=3,
                                   threads=2):
                arrs.append(arr)
        assert supervisor.breaker.trips > trips0
        assert len(arrs) >= supervisor.breaker._k() - 1
        for i, arr in enumerate(arrs):
            lo = int(store._offsets[i])
            np.testing.assert_array_equal(
                arr, X_TALL[lo:lo + store.shard_sizes[i]])

    def test_worker_error_surfaces_at_owner_shard(self, store, monkeypatch):
        from sq_learn_tpu_torch.oocore.prefetch import iter_shards

        monkeypatch.setenv("SQ_OOC_REREAD_MAX", "1")
        faults.arm("corrupt_shard:tiles=3,times=10")
        got = []
        with pytest.raises(ShardCorruptionError, match="shard 3"):
            for arr in iter_shards(store, range(store.n_shards), depth=3,
                                   threads=2):
                got.append(arr)
        assert len(got) == 3
        for i, arr in enumerate(got):
            lo = int(store._offsets[i])
            np.testing.assert_array_equal(
                arr, X_TALL[lo:lo + store.shard_sizes[i]])

    def test_skipped_shards_never_read(self, store, monkeypatch):
        self._depth(monkeypatch, 3)
        plan = EpochPlan(seed=5, batch_rows=256)
        full = [b for _, b in plan.iter_batches(store, 2)]
        reads = []
        real = oocore.ShardStore.read_shard

        def spy_read(self, i):
            reads.append(int(i))
            return real(self, i)

        monkeypatch.setattr(oocore.ShardStore, "read_shard", spy_read)
        tail = [b for _, b in plan.iter_batches(store, 2, start_batch=4)]
        assert len(tail) == len(full) - 4
        for a, b in zip(full[4:], tail):
            np.testing.assert_array_equal(a, b)
        skipped, skip = [], 4 * 256
        for s in plan.shard_order(store, 2):
            if skip >= store.shard_sizes[int(s)]:
                skipped.append(int(s))
                skip -= store.shard_sizes[int(s)]
            else:
                break
        assert skipped and reads
        assert not set(reads) & set(skipped)

    def test_host_partition_never_reads_foreign_shards(self, store,
                                                       monkeypatch):
        from sq_learn_tpu_torch.oocore.prefetch import iter_shards

        self._depth(monkeypatch, 3)
        plan = EpochPlan(seed=5)
        mine = plan.host_partition(store, 1, 3, 2)
        reads = []
        real = oocore.ShardStore.read_shard

        def spy_read(self, i):
            reads.append(int(i))
            return real(self, i)

        monkeypatch.setattr(oocore.ShardStore, "read_shard", spy_read)
        arrs = list(iter_shards(store, [s for _, s in mine]))
        for (_, s), arr in zip(mine, arrs):
            lo = int(store._offsets[s])
            np.testing.assert_array_equal(
                arr, X_TALL[lo:lo + store.shard_sizes[s]])
        assert set(reads) == {s for _, s in mine}
        with pytest.raises(ValueError):
            plan.host_partition(store, 1, 0, 0)
        with pytest.raises(ValueError):
            plan.host_partition(store, 1, 2, 2)

    def test_ram_budget_bounds_readahead(self, store, monkeypatch):
        from sq_learn_tpu_torch.oocore.prefetch import ShardPrefetcher

        shard_b = store.shard_sizes[0] * 16 * 4
        monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES", str(3 * shard_b))
        pf = ShardPrefetcher(store, range(store.n_shards), depth=4,
                             threads=2)
        try:
            assert pf._avail is not None and pf._avail <= shard_b
            for pos in range(store.n_shards):
                arr = pf.get(pos)
                lo = int(store._offsets[pos])
                np.testing.assert_array_equal(
                    arr, X_TALL[lo:lo + store.shard_sizes[pos]])
        finally:
            pf.close()

    def test_ram_budget_holds_for_the_store_fits(self, store, monkeypatch):
        """Under a budget of four shards the epoch fit, the labelling pass
        and the streamed qPCA at shard-sized tiles all run; a tile cap
        above the budget raises."""
        from sq_learn_tpu_torch.models import QPCA, MiniBatchQKMeans

        shard_b = store.shard_sizes[0] * 16 * 4
        monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES", str(4 * shard_b))
        self._depth(monkeypatch, 2)
        est = MiniBatchQKMeans(n_clusters=4, batch_size=256, max_iter=2,
                               delta=0.5, random_state=0).fit(store)
        assert est.labels_.shape == (2003,)
        monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(shard_b))
        QPCA(n_components=3).fit(store)
        monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(8 * shard_b))
        with pytest.raises(RamBudgetError):
            QPCA(n_components=3).fit(store)

    def test_sequential_contract_and_close(self, store):
        from sq_learn_tpu_torch.oocore.prefetch import ShardPrefetcher

        pf = ShardPrefetcher(store, [0, 1, 2], depth=2, threads=2)
        try:
            pf.get(0)
            with pytest.raises(RuntimeError, match="sequential"):
                pf.get(2)
        finally:
            pf.close()
        pf.close()  # idempotent

    def test_prefetched_view_serves_row_walks(self, store, monkeypatch):
        self._depth(monkeypatch, 2)
        view = store.prefetched()
        assert view is not store
        try:
            np.testing.assert_array_equal(view.read_rows(300, 900),
                                          X_TALL[300:900])
            np.testing.assert_array_equal(view.read_rows(900, 2003),
                                          X_TALL[900:2003])
            np.testing.assert_array_equal(view.read_rows(0, 10),
                                          X_TALL[:10])  # out of sequence
            assert view.fingerprint == store.fingerprint
            assert streaming.is_row_source(view) and len(view) == 2003
        finally:
            view.close()
        self._depth(monkeypatch, 0)
        assert store.prefetched() is store

    def test_prefetch_counters_and_span(self, store, recorder, monkeypatch):
        self._depth(monkeypatch, 2)
        oocore.minibatch_epoch_fit(store, n_clusters=4, batch_rows=256,
                                   max_epochs=1, seed=0)
        gets = (recorder.counters.get("oocore.prefetch_hits", 0)
                + recorder.counters.get("oocore.prefetch_stalls", 0))
        assert gets == store.n_shards
        assert any(s["name"] == "oocore.prefetch" for s in recorder.spans)


# -- checkpoints, builds, the codec store -------------------------------------


def test_interrupt_resume_parity_serial_ckpt_mode(store, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("SQ_OOC_ASYNC_CKPT", "0")
    monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "2")
    ck = str(tmp_path / "mb.npz")
    kw = dict(n_clusters=4, batch_rows=256, max_epochs=3, seed=1)
    ref = oocore.minibatch_epoch_fit(store, **kw)
    faults.arm("abort:tile=9,times=1")
    with pytest.raises(InjectedInterrupt):
        oocore.minibatch_epoch_fit(store, checkpoint=ck, **kw)
    faults.disarm()
    out = oocore.minibatch_epoch_fit(store, checkpoint=ck, **kw)
    assert out["resumed_from"] >= 1
    np.testing.assert_array_equal(out["centers"], ref["centers"])
    assert not os.path.exists(ck) and not os.path.exists(ck + ".prev")


@pytest.mark.parametrize("codec", ["none", "lz4"])
def test_parallel_build_matches_serial_manifest(tmp_path, monkeypatch,
                                                codec):
    kw = dict(n_samples=900, n_features=8, n_classes=3, seed=4,
              shard_bytes=4 * 1024, codec=codec)
    monkeypatch.setenv("SQ_OOC_PREFETCH_THREADS", "3")
    par = oocore.create_synthetic_store(str(tmp_path / "par"), **kw)
    parr = oocore.store_from_array(str(tmp_path / "para"), X_TALL,
                                   shard_bytes=SHARD_BYTES, codec=codec)
    monkeypatch.setenv("SQ_OOC_PREFETCH_THREADS", "1")
    ser = oocore.create_synthetic_store(str(tmp_path / "ser"), **kw)
    monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES", str(3 * SHARD_BYTES))
    sera = oocore.store_from_array(str(tmp_path / "sera"), X_TALL,
                                   shard_bytes=SHARD_BYTES, codec=codec)
    assert _manifest(par.path) == _manifest(ser.path)
    assert _manifest(parr.path) == _manifest(sera.path)


class TestCodecStore:
    def test_roundtrip_and_manifest(self, cstore):
        assert cstore.codec == "lz4" and cstore.manifest["codec"] == "lz4"
        assert cstore.stored_nbytes < cstore.nbytes
        assert all("stored_bytes" in s for s in cstore.manifest["shards"])
        np.testing.assert_array_equal(cstore.read_rows(0, 2003), X_TALL)
        idx = np.array([0, 255, 256, 1024, 2002])
        np.testing.assert_array_equal(cstore.take(idx), X_TALL[idx])
        re = oocore.open_store(cstore.path)
        assert re.codec == "lz4"
        np.testing.assert_array_equal(re.read_rows(0, 2003), X_TALL)

    def test_env_default_codec(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SQ_OOC_CODEC", "lz4")
        st = oocore.store_from_array(str(tmp_path / "env"), X_TALL,
                                     shard_bytes=SHARD_BYTES)
        assert st.codec == "lz4" and st.stored_nbytes < st.nbytes
        monkeypatch.setenv("SQ_OOC_CODEC", "zstd")
        with pytest.raises(ValueError, match="SQ_OOC_CODEC"):
            oocore.store_from_array(str(tmp_path / "bad"), X_TALL)

    def test_uncompressed_manifest_has_no_codec_field(self, store):
        assert store.codec == "none" and "codec" not in store.manifest
        assert all("stored_bytes" not in s for s in store.manifest["shards"])
        assert store.stored_nbytes == store.nbytes

    def test_unknown_codec_and_format_refused(self, cstore):
        path = os.path.join(cstore.path, "manifest.json")
        man = json.load(open(path))
        man["codec"] = "zstd"
        json.dump(man, open(path, "w"))
        with pytest.raises(ValueError, match="unknown codec"):
            oocore.open_store(cstore.path)
        man["format"] = "something-else"
        json.dump(man, open(path, "w"))
        with pytest.raises(ValueError, match="not an oocore shard store"):
            oocore.open_store(cstore.path)

    def test_engine_and_estimator_parity_vs_uncompressed(self, store,
                                                         cstore):
        from sq_learn_tpu_torch.models import MiniBatchQKMeans

        kw = dict(n_clusters=5, batch_rows=256, max_epochs=2, seed=3,
                  window=0.4)
        a = oocore.minibatch_epoch_fit(store, **kw)
        b = oocore.minibatch_epoch_fit(cstore, **kw)
        np.testing.assert_array_equal(a["centers"], b["centers"])
        np.testing.assert_array_equal(a["counts"], b["counts"])
        ekw = dict(n_clusters=4, batch_size=512, max_iter=2, tol=0.0,
                   n_init=1, max_no_improvement=None, compute_labels=False,
                   delta=0.5, random_state=0)
        ea = MiniBatchQKMeans(**ekw).fit(store)
        eb = MiniBatchQKMeans(**ekw).fit(cstore)
        np.testing.assert_array_equal(ea.cluster_centers_,
                                      eb.cluster_centers_)

    def test_prefetched_fault_matrix_parity(self, store, cstore,
                                            monkeypatch):
        monkeypatch.setenv("SQ_RETRY_BACKOFF_S", "0.001")
        monkeypatch.setenv("SQ_OOC_PREFETCH_DEPTH", "0")
        kw = dict(n_clusters=4, batch_rows=256, max_epochs=2, seed=1)
        ref = oocore.minibatch_epoch_fit(store, **kw)
        monkeypatch.setenv("SQ_OOC_PREFETCH_DEPTH", "3")
        plan = faults.arm("read_fail:tiles=2,times=1;"
                          "corrupt_shard:tiles=4,times=1")
        got = oocore.minibatch_epoch_fit(oocore.open_store(cstore.path), **kw)
        faults.disarm()
        np.testing.assert_array_equal(ref["centers"], got["centers"])
        assert {"read_fail", "corrupt_shard"} <= {e["kind"]
                                                  for e in plan.events}

    def test_qpca_gram_route_parity(self, store, cstore):
        _, G_ref, _ = streaming.streamed_centered_gram(store,
                                                       max_bytes=32 * 1024)
        _, G, _ = streaming.streamed_centered_gram(cstore,
                                                   max_bytes=32 * 1024)
        np.testing.assert_array_equal(G.numpy(), G_ref.numpy())

    def test_budget_accounts_compressed_plus_raw(self, cstore, monkeypatch):
        from sq_learn_tpu_torch.oocore.prefetch import ShardPrefetcher

        raw = max(int(s) * 16 * 4 for s in cstore.shard_sizes)
        stored = max(cstore.shard_stored_sizes)
        budget = 2 * raw + (raw + stored) + stored // 2
        monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES", str(budget))
        pf = ShardPrefetcher(cstore, list(range(cstore.n_shards)), depth=4,
                             threads=2)
        try:
            assert pf._extra[0] > 0
            out = [pf.get(i) for i in range(cstore.n_shards)]
        finally:
            pf.close()
        np.testing.assert_array_equal(np.concatenate(out), X_TALL)

    def test_single_materialization_budget_counts_payload(self, cstore,
                                                          monkeypatch):
        raw_shard = cstore.shard_sizes[0] * 16 * 4
        monkeypatch.setenv("SQ_OOC_RAM_BUDGET_BYTES", str(raw_shard + 16))
        with pytest.raises(RamBudgetError):
            cstore.read_shard(0)

    def test_verify_off_decode_error_has_provenance(self, cstore,
                                                    monkeypatch):
        _flip_tail(cstore._shard_path(1))
        with pytest.raises(ShardCorruptionError, match="shard 1"):
            cstore.read_shard(1)  # the CRC catches it before the decoder
        monkeypatch.setenv("SQ_OOC_VERIFY", "off")
        with pytest.raises(ShardCorruptionError, match="decode"):
            cstore.read_shard(1)

    def test_cold_tier_first_touch_and_bandwidth_model(self, cstore,
                                                       recorder):
        plan = faults.arm("cold_tier:s=0.03,per_mb=0.5")
        t0 = time.perf_counter()
        cstore.read_shard(0)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        cstore.read_shard(0)
        warm = time.perf_counter() - t0
        faults.disarm()
        events = [e for e in plan.events if e["kind"] == "cold_tier"]
        assert len(events) == 1
        want = 0.03 + 0.5 * (cstore.shard_stored_sizes[0] / 2**20)
        assert events[0]["stall_s"] == pytest.approx(want, rel=1e-4)
        assert cold >= want and warm < want
        assert any(e["kind"] == "cold_tier" for e in recorder.fault_events)

    def test_codec_counters(self, cstore, recorder):
        cstore.read_shard(0)
        assert recorder.counters["oocore.codec_bytes_in"] == \
            cstore.shard_stored_sizes[0]
        assert recorder.counters["oocore.codec_bytes_out"] == \
            cstore.shard_sizes[0] * 16 * 4
        snap = obs.snapshot()
        assert snap["codec_bytes_in"] == cstore.shard_stored_sizes[0]
        assert snap["storage_surfaces"]["oocore"]["reads"] == 1


# -- obs ----------------------------------------------------------------------


def _names(rec):
    return ({s["name"] for s in rec.spans}, set(rec.counters))


def test_obs_names_are_the_jax_packages(scenario, tmp_path, monkeypatch):
    """The store routes of both packages under obs: the port writes span
    and counter names the JAX package also writes (its own
    ``streaming.*``/``resilience.*`` names aside), the JSONL validates
    under both schemas, and the ``io`` records cover every shard."""
    from sq_learn_tpu import obs as jobs
    from sq_learn_tpu.models import MiniBatchQKMeans as JaxMiniBatch
    from sq_learn_tpu.obs import recorder as jrecorder
    from sq_learn_tpu.obs import schema as jschema
    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    monkeypatch.setenv("SQ_STREAM_CKPT_DIR", str(tmp_path / "ck"))
    monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "10")
    monkeypatch.setenv("SQ_OOC_PREFETCH_DEPTH", "2")
    st, _ = scenario
    kw = dict(n_clusters=6, batch_size=256, max_iter=2, delta=0.5,
              random_state=0)
    path = str(tmp_path / "port.jsonl")
    rec = obs.enable(path)
    cst = oocore.store_from_array(str(tmp_path / "c"),
                                  st.read_rows(0, 600), codec="lz4",
                                  shard_bytes=16 * 1024)
    est = MiniBatchQKMeans(**kw).fit(st)
    est.partial_fit(cst)
    obs.disable()
    # the JAX package's labelling pass leaves its ``oocore.assign_labels``
    # spans open on this thread's span stack: restore the stack, so a
    # later test on this thread nests its spans from where it was
    jstack = list(getattr(jrecorder._tls, "span_stack", None) or ())
    jrec = jobs.enable(str(tmp_path / "jax.jsonl"))
    try:
        jcst = joo.store_from_array(str(tmp_path / "jc"),
                                    st.read_rows(0, 600), codec="lz4",
                                    shard_bytes=16 * 1024)
        jest = JaxMiniBatch(**kw).fit(joo.open_store(st.path))
        jest.partial_fit(jcst)
    finally:
        jobs.disable()
        jrecorder._tls.span_stack = jstack
    spans, counters = _names(rec)
    jspans, jcounters = _names(jrec)
    oo_spans = {s for s in spans if s.startswith(("oocore.", "minibatch."))}
    assert oo_spans <= jspans, oo_spans - jspans
    assert {"oocore.minibatch_fit", "oocore.epoch", "oocore.assign_labels",
            "oocore.prefetch", "oocore.create_store",
            "minibatch.fit_store", "minibatch.partial_fit_store"} <= oo_spans
    oo_counters = {c for c in counters if c.startswith("oocore.")}
    assert oo_counters <= jcounters, oo_counters - jcounters
    assert {"oocore.shard_reads", "oocore.shard_read_bytes",
            "oocore.codec_bytes_in", "oocore.codec_bytes_out",
            "oocore.prefetch_hits", "oocore.async_ckpt_writes"} <= \
        oo_counters
    for check in (obs.schema.validate_jsonl, jschema.validate_jsonl):
        assert check(path)["errors"] == []
    io = obs.storage.collect(rec.io_records)["surfaces"]["oocore"]
    assert sorted(io[st.fingerprint]) == list(range(st.n_shards))


def test_smoke_name_sets_are_the_jax_packages():
    """``chip_smoke.OOC_SPANS``/``OOC_COUNTERS``, which the smoke holds its
    obs run's names to, are names the JAX package writes: each is a
    string literal of its ``oocore/`` or ``models/minibatch.py``, and the
    port writes each of them too."""
    import glob

    sys.path.insert(0, REPO)
    import chip_smoke

    sources = glob.glob(os.path.join(REPO, "sq_learn_tpu", "oocore", "*.py"))
    sources.append(os.path.join(REPO, "sq_learn_tpu", "models",
                                "minibatch.py"))
    jax_text = "".join(open(p).read() for p in sources)
    port = glob.glob(os.path.join(REPO, "sq_learn_tpu_torch", "oocore",
                                  "*.py"))
    port.append(os.path.join(REPO, "sq_learn_tpu_torch", "models",
                             "minibatch.py"))
    port_text = "".join(open(p).read() for p in port)
    for name in chip_smoke.OOC_SPANS | chip_smoke.OOC_COUNTERS:
        assert f'"{name}"' in jax_text, name
        assert f'"{name}"' in port_text, name


# -- the JAX package's store-route spectrum error (script mode) --------------


def jax_store_spectrum_error(n, m, k, seed=784, shard_bytes=None):
    """Largest relative error of the JAX package's float32 singular values
    on its store route (``QPCA(k, svd_solver='full').fit(store)``) over
    ``create_synthetic_store(n, m, n_classes=10, seed)``, against the
    float64 Gram of the same store's rows."""
    import tempfile

    from sq_learn_tpu.models import QPCA as JaxQPCA

    with tempfile.TemporaryDirectory() as tmp:
        st = joo.create_synthetic_store(os.path.join(tmp, "s"), n, m,
                                        n_classes=10, seed=seed,
                                        shard_bytes=shard_bytes)
        S = JaxQPCA(n_components=k, svd_solver="full").fit(
            st).singular_values_
        G, colsum = np.zeros((m, m)), np.zeros(m)
        for i in range(st.n_shards):
            a = st.read_shard(i).astype(np.float64)
            G += a.T @ a
            colsum += a.sum(0)
        mean = colsum / n
        ev = np.linalg.eigvalsh(G - n * np.outer(mean, mean))[::-1][:k]
        S64 = np.sqrt(ev)
        return float(np.max(np.abs(np.asarray(S, np.float64) - S64) / S64))


if __name__ == "__main__":
    warnings.simplefilter("ignore")
    for n in (100_000, 200_000, 400_000):
        print(n, "x 784, k=61:", jax_store_spectrum_error(n, 784, 61))
