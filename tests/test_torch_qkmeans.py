"""The port's q-means slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both sides.
Tolerances: labels, ``n_iter`` and the winning restart equal; float32
results at rtol 1e-4 (the same arithmetic summed in another order). The
δ-means comparisons are of distributions: the two sides draw their noise
from different generators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.datasets import make_blobs
from sq_learn_tpu.metrics import adjusted_rand_score
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.models import qkmeans as jqk
from sq_learn_tpu.ops import linalg as jlinalg
from sq_learn_tpu.ops.quantum import norms as jnorms
from sq_learn_tpu.parallel import init as jinit
from sq_learn_tpu_torch import (QKMeans, clone, config_context, get_config,
                                resolve_device, set_config)
from sq_learn_tpu_torch.cluster import KMeans, k_means, qMeans_
from sq_learn_tpu_torch.datasets import synthetic_surrogate
from sq_learn_tpu_torch.models import qkmeans as tqk
from sq_learn_tpu_torch.ops import linalg as tlinalg
from sq_learn_tpu_torch.ops.quantum import norms as tnorms
from sq_learn_tpu_torch.parallel import init as tinit
from sq_learn_tpu_torch.utils import as_generator, check_array


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _data(n=700, m=17, k=5, seed=11, std=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, m))
    X = centers[rng.integers(0, k, n)] + rng.normal(scale=std, size=(n, m))
    return X.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- ops ----------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_pairwise_sq_distances_matches_jax(compute_dtype):
    X = _data()
    C = X[:5] + 0.25
    j = np.asarray(jlinalg.pairwise_sq_distances(
        jnp.asarray(X), jnp.asarray(C), compute_dtype=compute_dtype))
    t = tlinalg.pairwise_sq_distances(
        _t(X), _t(C), compute_dtype=compute_dtype).numpy()
    rtol = 1e-4 if compute_dtype is None else 2e-2
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-3 if rtol < 1e-3
                               else 1.0)
    assert (t >= 0).all()


def test_pairwise_batched_centers_is_per_restart():
    X = _data()
    C = np.stack([X[:5], X[5:10]])
    batched = tlinalg.pairwise_sq_distances(_t(X), _t(C))
    for r in range(2):
        torch.testing.assert_close(
            batched[r], tlinalg.pairwise_sq_distances(_t(X), _t(C[r])))


@pytest.mark.parametrize("shape", [(700, 17), (12, 40)])
def test_smallest_singular_value_matches_jax(shape):
    X = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    j = float(jlinalg.smallest_singular_value(jnp.asarray(X)))
    t = float(tlinalg.smallest_singular_value(_t(X)))
    # σ_min through a float32 Gram: relative error ~ eps·κ²
    assert t == pytest.approx(j, rel=1e-3)
    ref = np.linalg.svd(X.astype(np.float64), compute_uv=False).min()
    assert t == pytest.approx(ref, rel=1e-2)


@pytest.mark.parametrize("grid", [jqk.MU_GRID, (0.0, 0.3, 1.0)])
def test_mu_grid_matches_jax(grid):
    X = _data(seed=4)
    X[3, :4] = 0.0  # zero entries take the nz branch
    j = np.asarray(jnorms._mu_grid_unblocked(jnp.asarray(X), grid))
    t = tnorms._mu_grid(_t(X), grid).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4)
    t_win, j_win = (tnorms.select_mu(grid, t, 1e9),
                    jnorms.select_mu(grid, j, 1e9))
    assert t_win[0] == j_win[0]
    assert t_win[1] == pytest.approx(j_win[1], rel=1e-4)


def test_row_norms_and_dtype_rules():
    X = _data()
    np.testing.assert_allclose(tlinalg.row_norms(_t(X)).numpy(),
                               np.asarray(jlinalg.row_norms(X)), rtol=1e-6)
    assert tlinalg.check_compute_dtype(torch.bfloat16) == "bfloat16"
    assert tlinalg.check_compute_dtype(np.float32) == "float32"
    assert tlinalg.is_reduced("bfloat16", torch.float32)
    assert not tlinalg.is_reduced("float32", torch.float32)
    with pytest.raises(ValueError):
        tlinalg.check_compute_dtype("int8")


# -- k-means++ ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_draw_index_matches_jax_on_its_own_uniform(seed):
    rng = np.random.default_rng(seed)
    pot = rng.uniform(size=64 * 11).astype(np.float32)
    pot[rng.choice(pot.size, 200, replace=False)] = 0.0
    key = jax.random.PRNGKey(seed)
    j = int(jinit._draw_index(key, jnp.asarray(pot), 64, None))
    u = jax.random.uniform(key, (), jnp.float32)
    t = int(tinit._draw_index(torch.tensor(float(u)), _t(pot), 64))
    assert t == j
    assert pot[t] > 0


def test_draw_index_batched_equals_one_by_one():
    rng = np.random.default_rng(9)
    pot = _t(rng.uniform(size=(3, 64 * 5)).astype(np.float32))
    u = _t(rng.uniform(size=3).astype(np.float32))
    batched = tinit._draw_index(u, pot, 64)
    for r in range(3):
        assert int(batched[r]) == int(tinit._draw_index(u[r], pot[r], 64))


def test_kmeans_plusplus_batched_picks_weighted_data_rows():
    X = _data()
    w = np.ones(700, np.float32)
    w[:350] = 0.0
    gen = as_generator(0, "cpu")
    centers, idx = tinit.kmeans_plusplus_batched(
        gen, _t(X), None, 5, n_restarts=3, weights=_t(w))
    assert centers.shape == (3, 5, 17) and idx.shape == (3, 5)
    assert (idx >= 350).all()  # zero-weight rows never drawn
    for r in range(3):
        assert len(set(idx[r].tolist())) == 5
        np.testing.assert_array_equal(centers[r].numpy(), X[idx[r].numpy()])
    # same generator seed, same draws
    again, idx2 = tinit.kmeans_plusplus_batched(
        as_generator(0, "cpu"), _t(X), None, 5, n_restarts=3, weights=_t(w))
    assert torch.equal(idx, idx2)
    # the subsample's indices point into the ORIGINAL rows
    c_sub, i_sub = tinit.kmeans_plusplus_batched(
        as_generator(1, "cpu"), _t(X), None, 5, n_restarts=2, subsample=128)
    for r in range(2):
        np.testing.assert_array_equal(c_sub[r].numpy(), X[i_sub[r].numpy()])


@pytest.mark.parametrize("n,k,setting,expect", [
    (70_000, 10, "auto", 4096), (1797, 10, "auto", 0), (10_000, 10, 0, 0),
    (100_000, 10, 1000, 1024)])
def test_resolve_init_subsample_matches_jax(n, k, setting, expect):
    assert tinit.resolve_init_subsample(n, k, setting) == expect
    assert jinit.resolve_init_subsample(n, k, setting) == expect


# -- the Lloyd loop -------------------------------------------------------


def _centers0(X):
    rng = np.random.default_rng(5)
    c0 = np.stack([X[rng.choice(700, 5, replace=False)] for _ in range(3)])
    c0[2, 1] = c0[2, 0]  # a duplicate center: an empty cluster to relocate
    return c0


def test_lloyd_restarts_match_jax_pallas_interpret():
    X = _data()
    Xc = X - X.mean(0)
    w = np.ones(700, np.float32)
    xsq = (Xc * Xc).sum(1)
    c0 = _centers0(Xc)
    run = functools.partial(jqk.lloyd_single, delta=0.0, mode="classic",
                            max_iter=30, tol=1e-6, use_pallas=True,
                            pallas_interpret=True)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    j_lab, j_in, j_c, j_it, j_hist = jax.jit(jax.vmap(
        lambda k, c: run(k, jnp.asarray(Xc), jnp.asarray(w), c,
                         jnp.asarray(xsq))))(keys, jnp.asarray(c0))
    gen = as_generator(0, "cpu")
    t_lab, t_in, t_c, t_it, t_hist = tqk.lloyd_single(
        gen, _t(Xc), _t(w), _t(c0), _t(xsq), delta=0.0, mode="classic",
        max_iter=30, tol=1e-6)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
    np.testing.assert_allclose(t_in.numpy(), np.asarray(j_in), rtol=1e-4)
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), rtol=1e-4,
                               atol=1e-5)
    for name in ("inertia", "center_shift"):
        t_tr, j_tr = t_hist[name].numpy(), np.asarray(j_hist[name])
        np.testing.assert_array_equal(np.isnan(t_tr), np.isnan(j_tr))
        np.testing.assert_allclose(t_tr, j_tr, rtol=1e-4, atol=1e-4)
    assert int(np.argmin(t_in.numpy())) == int(np.argmin(np.asarray(j_in)))
    # the batched entry point returns that restart
    lab, inertia, centers, n_iter, hist = tqk.lloyd_restarts_from(
        as_generator(0, "cpu"), _t(Xc), _t(w), _t(xsq), _t(c0),
        mode="classic", max_iter=30, tol=1e-6)
    best = int(np.argmin(np.asarray(j_in)))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab[best]))
    assert int(n_iter) == int(j_it[best])
    np.testing.assert_allclose(float(inertia), float(j_in[best]), rtol=1e-4)


def test_relocation_matches_jax():
    X = _data()
    w = np.ones(700, np.float32)
    xsq = (X * X).sum(1)
    C = X[:5].copy()
    C[1] = C[0]
    C[3] = C[0]
    labels, inertia, min_d2 = jqk.e_step(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(w),
        jnp.asarray(C), jnp.asarray(xsq), delta=0.0, mode="classic", ipe_q=1)
    sums, counts = jqk._cluster_partials(jnp.asarray(X), jnp.asarray(w),
                                         labels, 5)
    assert (np.asarray(counts) == 0).sum() == 2
    j_s, j_c = jqk.relocate_empty_clusters(jnp.asarray(X), jnp.asarray(w),
                                           labels, min_d2, sums, counts)
    t_s, t_c = tqk.relocate_empty_clusters(
        _t(X), _t(w), _t(np.asarray(labels)), _t(np.asarray(min_d2)),
        _t(np.asarray(sums)), _t(np.asarray(counts)))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), rtol=1e-6)


def test_fit_prestats_matches_jax():
    X = _data(seed=8)
    j = jqk.fit_prestats(jnp.asarray(X), quantum=True, mu_grid=jqk.MU_GRID)
    t = tqk.fit_prestats(_t(X), quantum=True, mu_grid=tqk.MU_GRID)
    for name in ("mean", "Xc", "xsq", "var_mean", "eta", "frob",
                 "mu_vals"):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(t["sigma_min"]) == pytest.approx(float(j["sigma_min"]),
                                                  rel=1e-3)
    assert tqk.tolerance(_t(X), 1e-4) == pytest.approx(
        jqk.tolerance(X, 1e-4), rel=1e-4)


def test_delta_e_step_labels_stay_inside_the_window():
    X, _ = make_blobs(n_samples=300, centers=4, n_features=8,
                      cluster_std=1.5, random_state=1)
    C = X[:4]
    d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
    labels, inertia, min_d2 = tqk.e_step(
        as_generator(0, "cpu"), _t(X), torch.ones(300), _t(C),
        tlinalg.row_norms(_t(X), squared=True), delta=5.0, mode="delta")
    sel = d2[np.arange(300), labels.numpy()]
    assert (sel <= d2.min(1) + 5.0 + 1e-3).all()
    assert (labels.numpy() != d2.argmin(1)).any()
    assert float(inertia) == pytest.approx(d2.min(1).sum(), rel=1e-4)


def test_delta_loop_stops_on_patience_with_nan_padded_traces():
    X, _ = make_blobs(n_samples=300, centers=4, n_features=8,
                      cluster_std=2.0, random_state=2)
    Xc = (X - X.mean(0)).astype(np.float32)
    c0 = np.stack([Xc[[5, 80, 160, 240]], Xc[[1, 2, 3, 4]]])
    lab, inertia, centers, n_iter, hist = tqk.lloyd_single(
        as_generator(0, "cpu"), _t(Xc), torch.ones(300),
        _t(c0), tlinalg.row_norms(_t(Xc), squared=True), delta=2.0,
        mode="delta", max_iter=200, tol=0.0, patience=3)
    assert (n_iter < 200).all() and (n_iter >= 1).all()
    for r in range(2):
        tr = hist["inertia"][r].numpy()
        assert np.isfinite(tr[:int(n_iter[r])]).all()
        assert np.isnan(tr[int(n_iter[r]):]).all()


@pytest.mark.parametrize("setup", ["classic", "delta"])
def test_loop_steps_only_until_the_next_read_of_the_stop_rule(monkeypatch,
                                                              setup):
    """Every step after the last restart stopped is wasted work: the loop
    takes exactly the steps up to the first read of the stop rule at or
    after the longest restart's n_iter (each of the first CHECK_EVERY
    steps is read, so a short fit wastes none)."""
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return lloyd_step(*args, **kw)

    lloyd_step = tqk.lloyd_step
    monkeypatch.setattr(tqk, "lloyd_step", counting)
    if setup == "classic":
        X = _data()
        Xc = X - X.mean(0)
        c0, kw = _centers0(Xc), dict(mode="classic", tol=1e-6)
    else:
        X, _ = make_blobs(n_samples=300, centers=4, n_features=8,
                          cluster_std=2.0, random_state=2)
        Xc = (X - X.mean(0)).astype(np.float32)
        c0 = np.stack([Xc[[5, 80, 160, 240]], Xc[[1, 2, 3, 4]]])
        kw = dict(mode="delta", delta=2.0, tol=0.0, patience=12)
    max_iter = 60
    n_iter = tqk.lloyd_single(
        as_generator(0, "cpu"), _t(Xc), torch.ones(len(Xc)), _t(c0),
        tlinalg.row_norms(_t(Xc), squared=True), max_iter=max_iter, **kw)[3]
    longest = int(n_iter.max())
    expect = next(s for s in range(longest, max_iter + 1)
                  if s == max_iter or tqk._stop_rule_read_due(s))
    assert len(calls) == expect
    if longest < tqk.CHECK_EVERY:
        assert len(calls) == longest


# -- the estimator --------------------------------------------------------


def test_fit_delta0_array_init_matches_jax_estimator():
    X = _data(seed=21, std=2.5)
    init = X[np.random.default_rng(2).choice(700, 5, replace=False)]
    kw = dict(n_clusters=5, init=init, n_init=1, max_iter=100,
              random_state=0)
    with pytest.warns(UserWarning, match="classic"):
        j = JaxQKMeans(**kw).fit(X)
    with pytest.warns(UserWarning, match="classic"):
        t = QKMeans(**kw).fit(X)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-4, atol=1e-4)
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-4)
    np.testing.assert_allclose(t.inertia_history_, j.inertia_history_,
                               rtol=1e-4)
    assert t.labels_.dtype == np.int32
    assert t.cluster_centers_.dtype == np.float32


def test_fit_delta_means_matches_jax_in_distribution():
    X, y = make_blobs(n_samples=300, centers=4, n_features=8,
                      cluster_std=0.5, random_state=9)
    kw = dict(n_clusters=4, n_init=3, delta=0.5,
              true_distance_estimate=False, random_state=0, max_iter=60)
    j = JaxQKMeans(**kw).fit(X)
    t = QKMeans(**kw).fit(X)
    assert adjusted_rand_score(j.labels_, t.labels_) >= 0.95
    assert adjusted_rand_score(y, t.labels_) >= 0.95
    assert t.inertia_ == pytest.approx(j.inertia_, rel=0.02)
    assert 1 <= t.n_iter_ <= 60
    # the exact runtime-model statistics
    assert t.eta_ == pytest.approx(j.eta_, rel=1e-5)
    assert t.mu_ == pytest.approx(j.mu_, rel=1e-4)
    assert t.norm_mu_ == j.norm_mu_
    assert t.condition_number_ == pytest.approx(j.condition_number_,
                                                rel=1e-3)
    assert t.sketch_info_["sketched"] is False


def test_fit_is_deterministic_and_surfaces_work():
    X, y = synthetic_surrogate(600, 20, 4, seed=3)
    est = QKMeans(n_clusters=4, n_init=3, delta=0.5,
                  true_distance_estimate=False, random_state=7)
    a = est.fit(X).labels_.copy()
    b = clone(est).fit(X).labels_
    np.testing.assert_array_equal(a, b)
    assert adjusted_rand_score(y, a) > 0.95
    assert est.predict(X).shape == (600,)
    np.testing.assert_array_equal(est.fit_predict(X), est.labels_)
    dist = est.fit_transform(X)
    assert dist.shape == (600, 4)
    np.testing.assert_array_equal(dist.argmin(1), est.predict(X))
    assert est.score(X) == pytest.approx(-est.inertia_, rel=1e-3)
    assert set(est.fit_history_) == {"inertia", "center_shift"}
    with pytest.raises(ValueError, match="features"):
        est.predict(X[:, :5])


def test_random_init_kmeans_and_functional_api():
    X, y = synthetic_surrogate(500, 12, 3, seed=5)
    km = KMeans(n_clusters=3, init="random", n_init=4, random_state=0)
    km.fit(X)
    assert adjusted_rand_score(y, km.labels_) > 0.95
    centers, labels, inertia, n_iter = k_means(
        X, 3, random_state=0, return_n_iter=True, n_init=2)
    assert centers.shape == (3, 12) and n_iter >= 1
    assert qMeans_ is QKMeans
    assert "use_pallas" not in QKMeans().get_params()
    assert "device" in QKMeans().get_params()


@pytest.mark.parametrize("kw,match", [
    (dict(delta=0.5), "IPE"),
    (dict(delta=0.5, true_distance_estimate=False, intermediate_error=True),
     "tomography"),
    (dict(mesh=object()), "multi-GPU"),
    (dict(algorithm="elkan"), "elkan"),
    (dict(compute_dtype="float16"), "float16"),
])
def test_unported_modes_raise_naming_the_roadmap(kw, match):
    """Modes the port leaves out raise naming their ROADMAP item. The IPE
    E-step and tomography of the centers were ported since: those cases
    now fit, with finite centers and the runtime-model statistics. So were
    ``algorithm='elkan'`` and ``compute_dtype='float16'`` (item 7): elkan
    warns and fits the Lloyd route, float16 fits in plain torch ops. And
    so was ``mesh`` (item 6a): a mesh that is not a ``Mesh`` raises
    TypeError, and a fit on a CPU mesh from an array init is the
    single-device fit (``tests/test_torch_parallel.py`` holds it against
    the JAX package's mesh fit)."""
    X = _data(n=64)
    if "mesh" in kw:
        from sq_learn_tpu_torch.parallel import make_mesh

        with pytest.raises(TypeError, match="make_mesh"):
            QKMeans(n_clusters=3, **kw).fit(X)
        init = X[:3]
        meshed = QKMeans(n_clusters=3, init=init, delta=0.0,
                         mesh=make_mesh(["cpu"] * 2)).fit(X)
        single = QKMeans(n_clusters=3, init=init, delta=0.0).fit(X)
        np.testing.assert_array_equal(meshed.labels_, single.labels_)
        assert meshed.n_iter_ == single.n_iter_
        return
    if match in ("IPE", "tomography"):
        est = QKMeans(n_clusters=3, random_state=0, **kw).fit(X)
        assert np.isfinite(est.cluster_centers_).all() and est.n_iter_ >= 1
        assert np.isfinite(est.condition_number_) and est.eta_ > 0
        return
    if match in ("elkan", "float16"):
        with pytest.warns(RuntimeWarning if match == "elkan"
                          else UserWarning, match=match if match == "elkan"
                          else "classic"):
            est = QKMeans(n_clusters=3, random_state=0, **kw).fit(X)
        assert np.isfinite(est.cluster_centers_).all() and est.n_iter_ >= 1


def test_sketch_auto_at_scale_raises_sketch_zero_runs():
    """sketch='auto' engages from 16 384 tall rows (4 · 4096) and samples
    4096 of them; sketch=0 keeps the exact statistics. (Both raised or
    were exact only before the sketched route was ported.)"""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16_384, 2)).astype(np.float32)
    kw = dict(n_clusters=2, delta=0.5, true_distance_estimate=False,
              n_init=1, max_iter=2)
    sketched = QKMeans(**kw).fit(X)
    assert sketched.sketch_info_["sketched"]
    assert sketched.sketch_info_["sample_rows"] == 4096
    exact = QKMeans(sketch=0, **kw).fit(X)
    assert exact.n_iter_ >= 1 and not exact.sketch_info_["sketched"]
    assert exact.sketch_info_["sample_rows"] == 0


def test_float16_lloyd_matches_jax_xla_route():
    """Item 7: float16 runs the JAX package's XLA route, off the Pallas
    kernel (the port: plain torch ops, no kernel); it holds the JAX
    functional core at δ=0 (labels and n_iter equal, floats at rtol
    1e-4). bfloat16 stays on the kernel (``test_torch_lloyd_kernel.py``)."""
    compute_dtype = "float16"
    X = _data(seed=5)
    Xc = X - X.mean(0)
    w = np.ones(700, np.float32)
    xsq = (Xc * Xc).sum(1)
    c0 = _centers0(Xc)[0]
    j_lab, j_in, j_c, j_it, _ = jax.jit(functools.partial(
        jqk.lloyd_single, delta=0.0, mode="classic", max_iter=30, tol=1e-6,
        use_pallas=False, compute_dtype=compute_dtype))(
        jax.random.PRNGKey(0), jnp.asarray(Xc), jnp.asarray(w),
        jnp.asarray(c0), jnp.asarray(xsq))
    assert tqk._kernel_dtype(_t(Xc), compute_dtype) is None
    assert tqk._kernel_dtype(_t(Xc), "bfloat16") == torch.bfloat16
    t_lab, t_in, t_c, t_it, _ = tqk.lloyd_single(
        as_generator(0, "cpu"), _t(Xc), _t(w), _t(c0)[None], _t(xsq),
        delta=0.0, mode="classic", max_iter=30, tol=1e-6,
        compute_dtype=compute_dtype)
    np.testing.assert_array_equal(t_lab[0].numpy(), np.asarray(j_lab))
    assert int(t_it[0]) == int(j_it)
    np.testing.assert_allclose(t_c[0].numpy(), np.asarray(j_c), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(t_in[0]), float(j_in), rtol=1e-4)


def test_elkan_labels_equal_lloyd_and_float64_fits():
    """Item 7: ``algorithm='elkan'`` at δ=0 warns and runs the Lloyd route
    (sklearn's elkan ≡ lloyd contract: the same labels), and a float64 fit
    (``default_dtype='float64'``) runs the plain torch step and finds the
    float32 fit's clusters."""
    X = _data(seed=8)
    kw = dict(n_clusters=5, n_init=3, delta=0.0, random_state=0)
    with pytest.warns(RuntimeWarning, match="elkan"):
        elkan = QKMeans(algorithm="elkan", **kw).fit(X)
    lloyd = QKMeans(algorithm="lloyd", **kw).fit(X)
    np.testing.assert_array_equal(elkan.labels_, lloyd.labels_)
    np.testing.assert_array_equal(elkan.cluster_centers_,
                                  lloyd.cluster_centers_)
    with config_context(default_dtype="float64"):
        wide = QKMeans(**kw).fit(X)
        assert tqk._kernel_dtype(check_array(X, device="cpu"), None) is None
    assert adjusted_rand_score(wide.labels_, lloyd.labels_) == 1.0
    # the same centers, up to the order the k-means++ draws gave them
    gap = np.linalg.norm(wide.cluster_centers_[:, None]
                         - lloyd.cluster_centers_[None], axis=-1)
    assert gap.min(axis=1).max() < 1e-4


def test_bf16_compute_dtype_fit_clusters():
    X, y = make_blobs(n_samples=300, centers=4, n_features=8,
                      cluster_std=0.5, random_state=4)
    t = QKMeans(n_clusters=4, n_init=2, delta=0.0, random_state=0,
                compute_dtype="bfloat16").fit(X)
    assert adjusted_rand_score(y, t.labels_) > 0.95
    assert np.isfinite(t.inertia_)


# -- configuration and validation ------------------------------------------


def test_default_device_is_cuda_and_never_drops_to_cpu():
    with config_context(device="cuda"):
        assert get_config()["device"] == "cuda"
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device()
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                QKMeans(n_clusters=2).fit(_data(n=20))
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        set_config(device="tpu")


def test_check_array_contract():
    out = check_array(np.arange(6, dtype=np.float64).reshape(3, 2),
                      device="cpu")
    assert out.dtype == torch.float32 and out.shape == (3, 2)
    with pytest.raises(ValueError, match="2D"):
        check_array(np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        check_array(np.array([[np.nan, 1.0]]), device="cpu")
    with config_context(default_dtype="float64"):
        assert check_array([[1, 2]], device="cpu").dtype == torch.float64
