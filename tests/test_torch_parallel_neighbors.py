"""The port's train-sharded k-NN search
(``sq_learn_tpu_torch.parallel.neighbors``) and the classifier's mesh
route, against the port's single-device search (the kernel's plain
version here) and the JAX package's ``mesh8`` search, on the CPU
(``tests/test_parallel_neighbors.py``'s cases)."""

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.parallel import knn_indices_sharded as j_knn_sharded
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.models import KNeighborsClassifier
from sq_learn_tpu_torch.models.neighbors import knn_indices
from sq_learn_tpu_torch.ops import kernels
from sq_learn_tpu_torch.parallel import (knn_indices_sharded, make_mesh,
                                         shard_train_rows)
from sq_learn_tpu_torch.parallel import neighbors as pnbr


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


@pytest.mark.parametrize("n,nq,k", [
    (256, 40, 5),    # even shards
    (101, 7, 10),    # uneven shards (padding rows in play)
    (20, 4, 10),     # k exceeds the per-shard row count
    (64, 5, 64),     # k == n_train (every row is a neighbor)
])
def test_matches_single_device_and_jax(mesh, mesh8, n, nq, k):
    rng = np.random.default_rng(3)
    Xt = rng.normal(size=(n, 11)).astype(np.float32)
    Xq = rng.normal(size=(nq, 11)).astype(np.float32)
    si, sd = knn_indices_sharded(mesh, torch.from_numpy(Xt),
                                 torch.from_numpy(Xq), k)
    ri, rd = knn_indices(torch.from_numpy(Xt), torch.from_numpy(Xq), k)
    ji, jd = j_knn_sharded(mesh8, Xt, Xq, k)
    # continuous random data: no exact distance ties
    np.testing.assert_array_equal(si.numpy(), ri.numpy())
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    assert si.dtype == torch.int32
    np.testing.assert_allclose(sd.numpy(), rd.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n_dev", [1, 3, 5])
def test_any_shard_count(n_dev):
    rng = np.random.default_rng(n_dev)
    Xt = torch.from_numpy(rng.normal(size=(97, 6)).astype(np.float32))
    Xq = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    si, _ = knn_indices_sharded(make_mesh(["cpu"] * n_dev), Xt, Xq, 12)
    ri, _ = knn_indices(Xt, Xq, 12)
    assert torch.equal(si, ri)


def test_padding_rows_never_selected(mesh):
    # 9 rows over 8 shards pad to 16: 7 padding rows, and k=9 demands
    # every REAL row back
    rng = np.random.default_rng(4)
    Xt = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    Xq = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    idx, d2 = knn_indices_sharded(mesh, Xt, Xq, 9)
    assert int(idx.max()) < 9
    assert bool((d2 < 1e29).all())  # no padding penalty leaked
    Xs, xsq, per, n = shard_train_rows(mesh, Xt)
    assert (per, n) == (2, 9)
    assert bool((torch.cat(xsq.shards)[9:] == np.float32(pnbr._PAD_PENALTY))
                .all())


def test_float64_rows_search_off_the_kernel(mesh):
    rng = np.random.default_rng(5)
    Xt = torch.from_numpy(rng.normal(size=(45, 7)))
    Xq = torch.from_numpy(rng.normal(size=(6, 7)))
    si, sd = knn_indices_sharded(mesh, Xt, Xq, 5)
    ri, rd = knn_indices(Xt, Xq, 5)
    assert torch.equal(si, ri) and sd.dtype == torch.float64
    np.testing.assert_allclose(sd.numpy(), rd.numpy(), rtol=1e-12)


def test_classifier_mesh_dispatch(mesh, mesh8):
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(size=(60, 8)) + 4.0,
                        rng.normal(size=(60, 8)) - 4.0]).astype(np.float32)
    y = np.repeat([0, 1], 60)
    base = KNeighborsClassifier(n_neighbors=3).fit(X, y)
    meshed = KNeighborsClassifier(n_neighbors=3, mesh=mesh).fit(X, y)
    jmeshed = JaxKNN(n_neighbors=3, mesh=mesh8).fit(X, y)
    np.testing.assert_array_equal(meshed.predict(X), base.predict(X))
    np.testing.assert_array_equal(meshed.predict(X), jmeshed.predict(X))
    np.testing.assert_allclose(meshed.predict_proba(X),
                               base.predict_proba(X), rtol=1e-5)
    d_m, i_m = meshed.kneighbors(X[:10])
    d_b, i_b = base.kneighbors(X[:10])
    np.testing.assert_array_equal(i_m, i_b)
    np.testing.assert_allclose(d_m, d_b, rtol=1e-4, atol=1e-2)
    assert meshed._search_impl(torch.from_numpy(X[:4]), 3)[1] == "mesh"


def test_classifier_mesh_warns_on_compute_dtype(mesh):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(40, 8)).astype(np.float32)
    y = (rng.random(40) > 0.5).astype(int)
    knn = KNeighborsClassifier(n_neighbors=3, mesh=mesh,
                               compute_dtype="bfloat16").fit(X, y)
    with pytest.warns(RuntimeWarning, match="mesh path runs exact"):
        knn.predict(X[:5])


def test_corpus_placed_once_at_fit(mesh, monkeypatch):
    """Repeated meshed searches reuse the fit's shard placement; a refit
    without the mesh drops it."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(50, 8)).astype(np.float32)
    y = (rng.random(50) > 0.5).astype(int)
    knn = KNeighborsClassifier(n_neighbors=3, mesh=mesh).fit(X, y)

    def boom(*a, **k):
        raise AssertionError("corpus re-sharded after fit")

    monkeypatch.setattr(pnbr, "shard_train_rows", boom)
    knn.predict(X[:5])
    knn.kneighbors(X[:5])
    monkeypatch.undo()
    knn.set_params(mesh=None).fit(X, y)
    assert not hasattr(knn, "_mesh_state")


def test_each_shard_launches_one_search_per_predict(mesh, monkeypatch):
    """One fused search per shard per predict, each at the shard's rows:
    the count the smoke reads on the card."""
    calls = []
    real = kernels.argkmin

    def spy(T, tsq, Q, k):
        calls.append((T.shape[0], Q.shape[0], k))
        return real(T, tsq, Q, k)

    monkeypatch.setattr(pnbr, "argkmin", spy)
    rng = np.random.default_rng(8)
    X = rng.normal(size=(80, 8)).astype(np.float32)
    y = (rng.random(80) > 0.5).astype(int)
    KNeighborsClassifier(n_neighbors=7, mesh=mesh).fit(X, y).predict(X[:30])
    assert calls == [(10, 30, 7)] * 8
