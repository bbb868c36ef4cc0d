"""The port's fused k-nearest search against the JAX package's Pallas kernel.

``argkmin`` on CPU tensors (its plain torch version, the yardstick of the
CUDA kernel on the card) is held against ``argkmin_pallas(...,
interpret=True)`` on the same numpy inputs, at the shapes of
``tests/test_pallas.py``'s ``TestArgkminKernel`` and with planted duplicate
training rows. Tolerances are the JAX test's own: indices equal, d2 at
rtol 1e-4 and atol 1e-4 (float32 products summed in another order).
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.ops.pallas_kernels import argkmin_pallas
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.ops import _build, kernels
from sq_learn_tpu_torch.ops.kernels import (argkmin, argkmin_plan,
                                            argkmin_reference, argkmin_work)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _problem(nt, nq, m, duplicates=False):
    rng = np.random.RandomState(3)
    Xt = rng.randn(nt, m).astype(np.float32)
    Xq = rng.randn(nq, m).astype(np.float32)
    if duplicates:
        # two exact ties across the train range; the first two queries are
        # the duplicated rows themselves, so each tie sits at the top
        Xt[nt // 2] = Xt[0]
        Xt[-1] = Xt[1]
        Xq[0], Xq[1] = Xt[0], Xt[1]
    return Xt, (Xt * Xt).sum(1), Xq


@pytest.mark.parametrize("nt,nq,m,k,duplicates", [
    (1000, 300, 17, 5, False),   # deliberately unaligned everything
    (513, 90, 8, 1, False),      # k=1, odd train count
    (300, 50, 4, 13, False),     # k above a lane-tile fraction, tiny width
    (1000, 300, 17, 5, True),    # planted duplicate rows: lowest index first
])
def test_matches_pallas(nt, nq, m, k, duplicates):
    Xt, xsq, Xq = _problem(nt, nq, m, duplicates)
    pi, pd = argkmin_pallas(jnp.asarray(Xt), jnp.asarray(xsq),
                            jnp.asarray(Xq), k, tile_q=64, tile_t=128,
                            interpret=True)
    before = argkmin.launches
    before_shape = argkmin.by_shape[(m, k)]
    ti, td = argkmin(torch.from_numpy(Xt), torch.from_numpy(xsq),
                     torch.from_numpy(Xq), k)
    assert argkmin.launches == before  # the CPU runs the plain version
    assert argkmin.by_shape[(m, k)] == before_shape
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert ti.shape == td.shape == (nq, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(td.numpy(), np.asarray(pd), rtol=1e-4,
                               atol=1e-4)
    assert (np.diff(td.numpy(), axis=1) >= 0).all()
    if duplicates:
        assert ti[0, :2].tolist() == [0, nt // 2]
        assert ti[1, :2].tolist() == [1, nt - 1]
        assert td[0, 0] == td[0, 1] and td[1, 0] == td[1, 1]


def test_reference_blocks_over_queries(monkeypatch):
    """A block of a few queries gives what one block of all of them
    gives."""
    Xt, xsq, Xq = _problem(400, 70, 9)
    args = (torch.from_numpy(Xt), torch.from_numpy(xsq),
            torch.from_numpy(Xq), 6)
    whole = argkmin_reference(*args)
    monkeypatch.setattr(kernels, "_REFERENCE_BLOCK", 400 * 8)
    blocked = argkmin_reference(*args)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["train_dtype", "query_dtype", "norms_dtype",
                                 "width", "norms_shape", "ndim", "device",
                                 "k_zero", "k_above", "k_float",
                                 "not_contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    T, xsq, Q = torch.zeros(10, 4), torch.zeros(10), torch.zeros(3, 4)
    k = 2
    match = None
    if bad == "train_dtype":
        T = T.double()
    elif bad == "query_dtype":
        Q = Q.half()
    elif bad == "norms_dtype":
        xsq = xsq.double()
    elif bad == "width":
        Q = torch.zeros(3, 5)
    elif bad == "norms_shape":
        xsq = torch.zeros(9)
    elif bad == "ndim":
        Q = torch.zeros(4)
    elif bad == "device":
        T, xsq, Q = (t.to("meta") for t in (T, xsq, Q))
    elif bad == "k_zero":
        k, match = 0, "outside"
    elif bad == "k_above":
        k, match = 11, "outside"
    elif bad == "k_float":
        k, match = 2.0, "outside"
    else:
        T = torch.zeros(4, 10).T
    with pytest.raises(ValueError, match=match):
        argkmin(T, xsq, Q, k)


def test_wrapper_rejects_mixed_devices():
    T, xsq, Q = torch.zeros(10, 4), torch.zeros(10), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="one device"):
        argkmin(T, xsq, Q.to("meta"), 2)


#: (queries a block owns, train rows per tile, blocks resident on an SM),
#: as the library states them: the long-list kernel's tiles with the eight
#: blocks per SM its plan first targeted, and the short-list kernel's
TILES = [(32, 128, 8), (128, 128, 1)]


@pytest.fixture(params=TILES, ids=["long", "short"])
def tiles(request):
    return request.param


@pytest.mark.parametrize("nq,nt,k,sms", [
    (10_000, 60_000, 7, 132),     # the main-path predict
    (7_000, 63_000, 7, 132),      # a 10-fold CV fold
    (16, 60_000, 7, 132),         # a small predict: many splits
    (256, 60_000, 4096, 132),     # long lists: splits of at least k rows
    (8, 4097, 4096, 132),         # nt = k + 1: the last split holds one row
    (16, 129, 128, 132),          # the same at a tile's length
    (5, 300, 300, 132),           # k = nt
    (100_000, 10, 3, 8),          # one split
])
def test_plan_covers_every_train_row_once(nq, nt, k, sms, tiles):
    splits, rows = argkmin_plan(nq, nt, k, sms, tiles)
    assert splits >= 1 and rows % tiles[1] == 0
    assert (splits - 1) * rows < nt <= splits * rows
    assert rows >= k  # every split but the last holds at least k rows
    assert splits * nq * k * 8 <= max(kernels._PARTIAL_BYTES, nq * k * 8)


def test_plan_fills_the_card(tiles):
    tile_q, tile_t, resident = tiles
    slots = 132 * resident
    if tiles == TILES[0]:
        splits, _ = argkmin_plan(10_000, 60_000, 7, 132, tiles)
        assert splits * 313 >= 8 * 132  # 313 query tiles
        splits, rows = argkmin_plan(16, 60_000, 7, 132, tiles)
        assert rows == 128 and splits == 469
    # a predict and a 10-fold CV fold: every resident block has work, and
    # the blocks' tiles fill at least 95 % of the waves they run in
    for nq, nt in ((10_000, 60_000), (7_000, 63_000)):
        splits, rows = argkmin_plan(nq, nt, 7, 132, tiles)
        blocks = math.ceil(nq / tile_q) * splits
        waves = math.ceil(blocks / slots)
        assert blocks >= slots
        assert (math.ceil(nq / tile_q) * math.ceil(nt / tile_t)
                >= 0.95 * waves * slots * (rows // tile_t))
    splits, rows = argkmin_plan(16, 60_000, 7, 132, tiles)
    assert splits >= slots or rows == tile_t


@pytest.mark.parametrize("nt,k,tiles,want", [
    (4097, 4096, (32, 128, 8), (2, 4096)),
    (129, 128, (32, 128, 8), (2, 128)),
    (200, 130, (16, 64, 8), (2, 192)),  # rows rounded up to k, not halved
    (129, 16, (128, 128, 1), (2, 128)),  # the short-list kernel's largest k
])
def test_plan_last_split_may_be_shorter_than_k(nt, k, tiles, want):
    """A split shorter than k is the last one: its list is padded, and the
    merge ranks the padding after every real row."""
    splits, rows = argkmin_plan(8, nt, k, 132, tiles)
    assert (splits, rows) == want
    assert 0 < nt - (splits - 1) * rows < k


def test_plan_follows_the_tiles_it_is_given():
    for tiles in ((32, 128, 8), (16, 64, 8), (64, 256, 8)):
        splits, rows = argkmin_plan(16, 60_000, 7, 132, tiles)
        assert rows == tiles[1] and splits == math.ceil(60_000 / tiles[1])
    # and the residency: twice the resident blocks, twice the splits
    one = argkmin_plan(10_000, 60_000, 7, 132, (128, 128, 1))
    two = argkmin_plan(10_000, 60_000, 7, 132, (128, 128, 2))
    assert one == (5, 12032) and two == (10, 6016)


def test_work_counts():
    nbytes, ops = argkmin_work(10_000, 60_000, 784, 7)
    assert ops == 940_800_000_000
    # train 188.2 MB and queries 31.4 MB make up nearly all of the bytes
    assert 219e6 < nbytes < 221e6
    assert max(nbytes / 3.35e12, ops / 67e12) * 1e3 == pytest.approx(
        14.04, abs=0.005)


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(_build.KernelBuildError, match="argkmin.cu"):
        _build.build("argkmin")
    with pytest.raises(_build.KernelBuildError):
        _build.build_all()
    assert not list(tmp_path.glob("*.so"))


def test_build_all_builds_every_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    assert _build.sources() == ["argkmin", "lloyd"]
    built = []

    def fake_build(name):
        built.append(name)
        return _build.library_path(name)

    monkeypatch.setattr(_build, "build", fake_build)
    paths = _build.build_all()
    assert sorted(built) == ["argkmin", "lloyd"] and set(paths) == set(built)


def test_launch_counter_is_a_plain_int():
    assert isinstance(kernels.argkmin.launches, int)


def test_launches_are_also_counted_by_width_and_k():
    assert isinstance(kernels.argkmin.by_shape, collections.Counter)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nq,m,k,route", [
    (5000, 300, 130, 7, "short"),      # m % 4 != 0, several splits
    (5000, 16, 64, 7, "short"),        # few queries: one tile per split
    (5000, 70, 61, 1, "short"),        # k=1 at the post-PCA width
    (5000, 40, 32, 600, "global"),     # lists too long for shared memory
    (300, 33, 16, 300, "global"),      # k = nt
    (129, 16, 8, 128, "shared"),       # nt = k + 1: a last split of one row
    (4097, 8, 16, 4096, "global"),     # the same with lists in global memory
    # the short-list kernel's edges
    (3000, 129, 64, 7, "short"),       # one query past a 128-query tile
    (1000, 300, 32, 7, "short"),       # nt not a multiple of 128
    (5000, 200, 61, 7, "short"),       # width 61: rows not 16-byte aligned
    (3000, 200, 40, 16, "short"),      # the largest k it takes
    (3000, 200, 40, 17, "shared"),     # one past it: the long-list kernel
    (129, 16, 8, 16, "short"),         # a last split of one row, k > 1
])
def test_cuda_kernel_matches_reference(cuda_device, nt, nq, m, k, route):
    """Small integer-valued data: every product and sum is exact in
    float32, so scores tie often and exactly; the kernel must then give
    the reference's lists bit for bit, ties to the lowest index."""
    from sq_learn_tpu_torch.ops.kernels import argkmin_route

    assert argkmin_route(k, cuda_device) == route
    rng = np.random.default_rng(0)
    T = torch.from_numpy(rng.integers(-3, 4, (nt, m)).astype(np.float32))
    Q = torch.from_numpy(rng.integers(-3, 4, (nq, m)).astype(np.float32))
    T, Q = T.to(cuda_device), Q.to(cuda_device)
    xsq = torch.sum(T * T, dim=1)
    before = argkmin.launches
    before_shape = argkmin.by_shape[(m, k)]
    idx, d2 = argkmin(T, xsq, Q, k)
    torch.cuda.synchronize()
    assert argkmin.launches == before + 1
    assert argkmin.by_shape[(m, k)] == before_shape + 1
    ref_i, ref_d = argkmin_reference(T, xsq, Q, k)
    assert torch.equal(idx, ref_i)
    assert torch.equal(d2, ref_d)
    again = argkmin(T, xsq, Q, k)
    assert torch.equal(again[0], idx) and torch.equal(again[1], d2)
