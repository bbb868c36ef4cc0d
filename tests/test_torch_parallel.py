"""The port's data-parallel mesh (``sq_learn_tpu_torch.parallel``: mesh,
sharded k-means++ init, sharded Lloyd loop) against the JAX package's
``mesh8`` (the 8 virtual CPU devices of ``tests/conftest.py``) and against
the port's own single-device routes, on the CPU, on the same numpy
inputs. The port's mesh is ``make_mesh(["cpu"] * 8)``.

Held: the mesh helpers' padding and mask as the JAX package's; the sharded
init's indices and centers bit-equal to the single-device init's from the
same generator; the δ=0 sharded fit equal to the JAX package's mesh fit
from an array init (labels and ``n_iter`` equal, floats at rtol 1e-4) and
to the port's single-device fit; padding rows and shards smaller than k;
the empty-cluster relocation; δ and IPE modes in distribution (ARI).
"""

import warnings

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import KMeans as JaxKMeans
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.parallel import init as jinit
from sq_learn_tpu.parallel import mesh as jmesh
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.metrics import adjusted_rand_score
from sq_learn_tpu_torch.models import KMeans, QKMeans
from sq_learn_tpu_torch.models import qkmeans as tqk
from sq_learn_tpu_torch.parallel import (Mesh, ShardedRows, make_mesh,
                                         pad_and_shard, pad_to_multiple,
                                         shard_rows)
from sq_learn_tpu_torch.parallel import init as tinit
from sq_learn_tpu_torch.parallel.lloyd import lloyd_single_sharded
from sq_learn_tpu_torch.parallel.mesh import check_mesh
from sq_learn_tpu_torch.utils import as_generator


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Attention! You are running the classic")
            yield


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


def _blobs(n, seed=3, k=4, m=12, scale=4.0):
    rng = np.random.default_rng(seed)
    C = rng.normal(scale=scale, size=(k, m))
    y = rng.integers(0, k, n)
    return (C[y] + rng.normal(size=(n, m))).astype(np.float32), y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the mesh -----------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(403, 8), (400, 8), (13, 8), (5, 1)])
def test_pad_to_multiple_matches_jax(n, multiple):
    X = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, n_got = pad_to_multiple(X, multiple)
    want, n_want = jmesh.pad_to_multiple(X, multiple)
    assert n_got == n_want == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_and_shard_mask_matches_jax(mesh, mesh8):
    X = np.random.default_rng(0).normal(size=(13, 5)).astype(np.float32)
    Xs, mask, n = pad_and_shard(mesh, X)
    Xj, mj, nj = jmesh.pad_and_shard(mesh8, X)
    assert n == nj == 13 and Xs.per == 2 and len(Xs.shards) == 8
    np.testing.assert_array_equal(
        torch.cat(mask.shards).numpy(), np.asarray(mj))
    np.testing.assert_array_equal(torch.cat(Xs.shards).numpy(),
                                  np.asarray(Xj))
    np.testing.assert_array_equal(Xs.numpy(), X)       # the true rows
    np.testing.assert_array_equal(np.asarray(Xs), X)
    assert Xs.shape == (13, 5)
    assert all(s.device == torch.device("cpu") for s in Xs.shards)


def test_shard_rows_needs_equal_shards_and_meshes_are_checked(mesh):
    with pytest.raises(ValueError, match="pad them first"):
        shard_rows(mesh, torch.zeros(13, 2))
    assert make_mesh(["cpu"] * 3).size == 3
    assert check_mesh(mesh) is mesh and check_mesh(None) is None
    with pytest.raises(TypeError, match="make_mesh"):
        check_mesh(object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_psum_and_gather_take_shard_order(mesh):
    parts = [torch.full((2,), float(10 ** i)) for i in range(8)]
    total = mesh.psum(parts)
    expect = parts[0]
    for p in parts[1:]:
        expect = expect + p
    assert torch.equal(total, expect)
    assert torch.equal(mesh.gather([p[None] for p in parts])[:, 0],
                       torch.tensor([float(10 ** i) for i in range(8)]))
    assert all(c is parts[0] or torch.equal(c, parts[0])
               for c in mesh.broadcast(parts[0]))


def test_shard_generators_follow_the_global_shard_index():
    """A shard's generator depends on the caller's draw and the shard's
    global index alone: the last two shards of a 4-shard mesh draw what
    process 1 of a 2-process world of 2 shards each draws."""
    four = Mesh(["cpu"] * 4)
    second = Mesh(["cpu"] * 2, process_index=1, process_count=2)
    a = [torch.rand(5, generator=g)
         for g in four.generators(as_generator(7, "cpu"))]
    b = [torch.rand(5, generator=g)
         for g in second.generators(as_generator(7, "cpu"))]
    assert torch.equal(a[2], b[0]) and torch.equal(a[3], b[1])
    assert not torch.equal(a[0], a[1])
    assert second.offset == 2 and second.size == 4


# -- the sharded k-means++ init ---------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_sharded_draw_equals_single_device_draw(seed):
    rng = np.random.default_rng(seed)
    pot = rng.uniform(size=(3, 64 * 7)).astype(np.float32)
    pot[:, rng.choice(pot.shape[1], 100, replace=False)] = 0.0
    u = _t(rng.uniform(size=3).astype(np.float32))
    single = tinit._draw_index(u, _t(pot), 64)
    mesh4 = make_mesh(["cpu"] * 4)
    parts = list(torch.chunk(_t(pot), 4, dim=1))
    sharded = tinit._draw_index_sharded(mesh4, u, parts, 64)
    assert torch.equal(single, sharded)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("n_restarts", [1, 3])
def test_kmeans_plusplus_sharded_bit_equal_to_single_device(n_dev,
                                                            n_restarts):
    X, _ = _blobs(403, seed=n_dev)
    w = np.ones(403, np.float32)
    w[::7] = 0.0                      # zero-weight rows are never drawn
    Xt, wt = _t(X), _t(w)
    c1, i1 = tinit.kmeans_plusplus_batched(
        as_generator(11, "cpu"), Xt, None, 6, n_restarts=n_restarts,
        weights=wt)
    cs, i_s = tinit.kmeans_plusplus_sharded(
        make_mesh(["cpu"] * n_dev), as_generator(11, "cpu"), Xt, None, 6,
        n_restarts=n_restarts, weights=wt)
    assert torch.equal(i1, i_s)
    assert torch.equal(c1, cs)
    assert (w[i_s.numpy()] > 0).all()


def test_kmeans_plusplus_sharded_mesh_must_divide_the_block_grid(mesh8):
    X = _t(_blobs(64)[0])
    with pytest.raises(ValueError, match="does not divide"):
        tinit.kmeans_plusplus_sharded(make_mesh(["cpu"] * 3),
                                      as_generator(0, "cpu"), X, None, 4)
    import jax
    from jax.sharding import Mesh as JaxMesh

    with pytest.raises(ValueError, match="does not divide"):
        jinit.kmeans_plusplus_sharded(
            JaxMesh(np.asarray(jax.devices("cpu")[:3]), ("data",)),
            jax.random.PRNGKey(0), X.numpy(), n_clusters=4)


# -- the sharded Lloyd loop -------------------------------------------------


@pytest.mark.parametrize("n", [600, 403])
def test_mesh_fit_matches_jax_mesh8_at_delta_0(mesh, mesh8, n):
    X, _ = _blobs(n)
    init = X[:4].copy()
    port = KMeans(n_clusters=4, init=init, n_init=1, mesh=mesh).fit(X)
    jax_fit = JaxKMeans(n_clusters=4, init=init, n_init=1, random_state=0,
                        mesh=mesh8).fit(X)
    np.testing.assert_array_equal(port.labels_, np.asarray(jax_fit.labels_))
    assert port.n_iter_ == int(jax_fit.n_iter_)
    np.testing.assert_allclose(port.inertia_, float(jax_fit.inertia_),
                               rtol=1e-4)
    np.testing.assert_allclose(port.cluster_centers_,
                               np.asarray(jax_fit.cluster_centers_),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["classic", "delta"])
def test_sharded_lloyd_equals_single_device(mesh, mode):
    X, _ = _blobs(403, seed=5)
    Xt = _t(X)
    w = torch.ones(403)
    xsq = torch.sum(Xt * Xt, dim=1)
    init = Xt[:4]
    kw = dict(max_iter=50, tol=0.0, mode=mode,
              delta=0.0 if mode == "classic" else 1e-6)
    labels, inertia, centers, n_iter, hist = lloyd_single_sharded(
        mesh, as_generator(0, "cpu"), Xt, w, init, xsq, **kw)
    l1, in1, c1, n1, h1 = tqk.lloyd_single(
        as_generator(0, "cpu"), Xt, w, init[None], xsq, **kw)
    assert isinstance(labels, ShardedRows) and labels.shape == (403,)
    np.testing.assert_array_equal(labels.numpy(), l1[0].numpy())
    assert int(n_iter) == int(n1[0])
    np.testing.assert_allclose(float(inertia), float(in1[0]), rtol=1e-5)
    np.testing.assert_allclose(centers.numpy(), c1[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    n_it = int(n_iter)
    np.testing.assert_allclose(hist["inertia"][:n_it].numpy(),
                               h1["inertia"][0, :n_it].numpy(), rtol=1e-5)
    assert torch.isnan(hist["inertia"][n_it:]).all()


def test_mesh_with_padding(mesh):
    X, y = _blobs(403, seed=3, k=3)
    km = KMeans(n_clusters=3, n_init=1, random_state=0, mesh=mesh).fit(X)
    assert km.labels_.shape == (403,)
    assert adjusted_rand_score(km.labels_, y) > 0.9


def test_mesh_shards_smaller_than_k(mesh, mesh8):
    """17 rows over 8 shards (3 rows a shard, one padding) with k=4: the
    relocation candidates clamp to the shard's rows, and the fit matches
    the JAX package's mesh fit from the same array init."""
    rng = np.random.RandomState(0)
    X = np.vstack([rng.randn(6, 3) + c for c in
                   ((0, 0, 0), (8, 0, 0), (0, 8, 0))])[:17].astype(np.float32)
    init = X[[0, 1, 6, 12]].copy()
    km = KMeans(n_clusters=4, init=init, n_init=1, mesh=mesh).fit(X)
    jk = JaxKMeans(n_clusters=4, init=init, n_init=1, mesh=mesh8).fit(X)
    assert km.labels_.shape == (17,) and np.isfinite(km.inertia_)
    np.testing.assert_array_equal(km.labels_, np.asarray(jk.labels_))
    np.testing.assert_allclose(km.inertia_, float(jk.inertia_), rtol=1e-4)
    km = KMeans(n_clusters=4, n_init=2, random_state=0, mesh=mesh).fit(X)
    assert np.isfinite(km.inertia_)


def test_sharded_relocation_picks_what_the_single_device_one_picks(mesh):
    rng = np.random.default_rng(2)
    X = _t(rng.normal(size=(50, 4)).astype(np.float32))
    w = torch.ones(50)
    w[[3, 17]] = 0.0                       # never a relocation target
    labels = _t(rng.integers(0, 3, size=(2, 50)))
    min_d2 = _t(rng.uniform(size=(2, 50)).astype(np.float32))
    min_d2[:, 5] = min_d2[:, 40] = 2.0     # a tie across two shards
    min_d2[:, 3] = 9.0
    k = 6                                  # clusters 3..5 empty
    sums, counts = tqk._cluster_partials(X, w, labels, k)
    single = tqk.relocate_empty_clusters(X, w, labels, min_d2, sums, counts)
    Xs, ws = shard_rows(mesh, *(pad_to_multiple(a, 8)[0] for a in (X, w)),
                        n=50)
    lab_s, md2_s = (ShardedRows(list(torch.chunk(
        pad_to_multiple(a.T, 8)[0].T, 8, dim=1)), 50, mesh, dim=-1)
        for a in (labels, min_d2))
    sharded = tqk.relocate_empty_clusters(Xs, ws, lab_s, md2_s, sums,
                                          counts, mesh=mesh)
    assert torch.equal(single[0], sharded[0])
    assert torch.equal(single[1], sharded[1])
    assert (single[1][:, 3:] == 1.0).all()


@pytest.mark.parametrize("mode", ["classic", "delta"])
def test_mesh_relocates_an_empty_cluster(mesh, mode):
    """One start center far outside the data, the members of a tight
    cluster all on shard 0: after the fit no center stays far away."""
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(64, 8)) + 5.0).astype(np.float32)
    X[:8] = 0.05 * rng.normal(size=(8, 8))
    centers = X[rng.choice(64, 4, replace=False)].copy()
    centers[3] = 1e3
    Xt = _t(X)
    _, inertia, out_c, _, _ = lloyd_single_sharded(
        mesh, as_generator(3, "cpu"), Xt, torch.ones(64), _t(centers),
        torch.sum(Xt * Xt, dim=1), delta=0.5 if mode == "delta" else 0.0,
        mode=mode, max_iter=2, tol=0.0)
    assert np.isfinite(float(inertia))
    assert float(out_c.abs().max()) < 100.0


def test_mesh_delta_mode_in_distribution(mesh, mesh8):
    X, y = _blobs(600)
    kw = dict(n_clusters=4, delta=0.5, true_distance_estimate=False,
              n_init=1, random_state=0)
    port = QKMeans(mesh=mesh, **kw).fit(X)
    jax_fit = JaxQKMeans(mesh=mesh8, **kw).fit(X)
    assert adjusted_rand_score(port.labels_, y) > 0.85
    assert adjusted_rand_score(port.labels_,
                               np.asarray(jax_fit.labels_)) >= 0.95
    again = QKMeans(mesh=mesh, **kw).fit(X)
    np.testing.assert_array_equal(port.labels_, again.labels_)
    assert port.inertia_ == again.inertia_


def test_mesh_ipe_mode(mesh):
    X, y = _blobs(400)
    qm = QKMeans(n_clusters=4, delta=0.5, n_init=1, random_state=0,
                 mesh=mesh).fit(X * 0.05)
    assert adjusted_rand_score(qm.labels_, y) > 0.85
    assert np.isfinite(qm.condition_number_) and qm.sketch_info_ is not None


def test_mesh_fit_equals_single_device_fit(mesh):
    """k-means++ from the same generator with no init subsample: the
    sharded init draws what the single-device init draws, so the δ=0 mesh
    fit of 3 restarts is the single-device fit."""
    X, _ = _blobs(600, seed=8, k=5)
    kw = dict(n_clusters=5, n_init=3, random_state=4, init_subsample=0,
              delta=0.0)
    single = QKMeans(**kw).fit(X)
    meshed = QKMeans(mesh=mesh, **kw).fit(X)
    np.testing.assert_array_equal(meshed.labels_, single.labels_)
    assert meshed.n_iter_ == single.n_iter_
    np.testing.assert_allclose(meshed.inertia_, single.inertia_, rtol=1e-4)
    np.testing.assert_allclose(meshed.cluster_centers_,
                               single.cluster_centers_, rtol=1e-4,
                               atol=1e-4)


def test_mesh_quantum_statistics_are_the_exact_ones(mesh):
    X, _ = _blobs(600)
    kw = dict(n_clusters=4, delta=0.5, true_distance_estimate=False,
              n_init=1, random_state=0)
    meshed = QKMeans(mesh=mesh, **kw).fit(X)
    exact = QKMeans(sketch=0, **kw).fit(X)
    assert meshed.sketch_info_["sketched"] is False
    np.testing.assert_allclose(meshed.mu_, exact.mu_, rtol=1e-5)
    np.testing.assert_allclose(meshed.condition_number_,
                               exact.condition_number_, rtol=1e-5)


def test_elkan_under_a_mesh_warns_and_runs_lloyd(mesh):
    X, _ = _blobs(200)
    with pytest.warns(RuntimeWarning, match="with a mesh"):
        km = KMeans(n_clusters=4, n_init=1, random_state=0,
                    algorithm="elkan", mesh=mesh).fit(X)
    assert np.isfinite(km.inertia_)
