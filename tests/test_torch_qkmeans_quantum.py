"""q-means' quantum modes in the port against the JAX package, on the CPU:
the sketched σ_min/η statistics, the IPE E-step, tomography of the centers
and the runtime model.

Inputs are made with numpy from a seed and go through both sides.
Deterministic parts at rtol 1e-4 (float32); the stochastic ones (IPE,
tomography, the Gumbel picks) in distribution, since torch's Philox
streams cannot match threefry: two-sample KS tests at α = 1e-3, guarantee
rates, and ARI within a stated margin of the JAX fit's.

Run as a script from the repository root (``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_qkmeans_quantum.py``, ~1.5 minutes, ~2 GB) it
measures what ``chip_smoke.py``'s floors are built from: the JAX
package's float32 error on κ (exact σ_min at 70 000 × 784, and the
4096-row sketch the port's fit samples with ``random_state=0``), and its
ARI for the IPE fit and the δ-means fit with true tomography of the
centers on ``synthetic_surrogate(7_000, 784, 10, seed=784)``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sq_learn_tpu.datasets import make_blobs
from sq_learn_tpu.metrics import adjusted_rand_score
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.models import qkmeans as jqk
from sq_learn_tpu.ops.quantum import estimation as jest
from sq_learn_tpu.sketch import engine as jengine
from sq_learn_tpu_torch import QKMeans, config_context
from sq_learn_tpu_torch.cluster import k_means
from sq_learn_tpu_torch.convert import qkmeans_from_numpy
from sq_learn_tpu_torch.models import qkmeans as tqk
from sq_learn_tpu_torch.ops.quantum import estimation as test_
from sq_learn_tpu_torch.sketch import engine as tengine
from sq_learn_tpu_torch.utils import as_generator

MNIST = (70_000, 784)
SKETCH_ROWS = 4096
SKETCH_SEED = 0x5CE7


def jax_kappa_errors():
    """Relative error of the JAX package's float32 κ against float64, on
    ``synthetic_surrogate(70_000, 784, 10, seed=784)``: the exact route
    (σ_min of the full Gram) and the sketch route (λ_min of the scaled
    Gram of the rows the port's fit samples at random_state=0, folded by
    ``finalize_components``)."""
    import jax.numpy as jnp

    from sq_learn_tpu.datasets import synthetic_surrogate
    from sq_learn_tpu.ops.linalg import smallest_singular_value
    from sq_learn_tpu.sketch import engine

    X, _ = synthetic_surrogate(*MNIST, 10, seed=784)
    s32 = float(smallest_singular_value(jnp.asarray(X)))
    X64 = X.astype(np.float64)
    s64 = float(np.sqrt(np.linalg.eigvalsh(X64.T @ X64)[0]))
    exact = abs(1 / s32 - 1 / s64) / (1 / s64)
    idx = engine.sample_indices(np.random.default_rng([0, SKETCH_SEED]),
                                MNIST[0], SKETCH_ROWS)
    grid = tuple(round(0.1 * i, 1) for i in range(11))
    comp = {k: np.asarray(v) for k, v in engine.sketch_components_traced(
        jnp.asarray(X), jnp.asarray(idx), grid).items()}
    Xs = X64[idx]
    lam64 = np.linalg.eigvalsh((Xs.T @ Xs) * (MNIST[0] / SKETCH_ROWS))[0]
    kappas = []
    for lam in (comp["lam_min"], lam64):
        kappas.append(engine.finalize_components(
            dict(comp, lam_min=lam), n=MNIST[0], m=MNIST[1],
            s=SKETCH_ROWS, mu_grid=grid, delta_stat=0.05).condition_number())
    sketch = abs(kappas[0] - kappas[1]) / kappas[1]
    return {"exact_kappa_rel_err": exact, "kappa32": 1 / s32,
            "kappa64": 1 / s64, "sketch_kappa_rel_err": sketch,
            "sketch_kappa32": kappas[0], "sketch_kappa64": kappas[1]}


def jax_fit_aris(n=7000):
    """ARI against the classes of the JAX package's IPE fit (and of its
    ``predict(X, delta=0.5)`` against its labels) and of its δ-means fit
    with true tomography of the centers, at the smoke's parameters on
    ``synthetic_surrogate(n, 784, 10, seed=784)``."""
    from sq_learn_tpu.datasets import synthetic_surrogate
    from sq_learn_tpu.metrics import adjusted_rand_score
    from sq_learn_tpu.models import QKMeans

    X, y = synthetic_surrogate(n, 784, 10, seed=784)
    ipe = QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
                  random_state=0).fit(X)
    tomo = QKMeans(n_clusters=10, n_init=10, delta=0.5,
                   true_distance_estimate=False, intermediate_error=True,
                   random_state=0).fit(X)
    return {"ipe_ari": float(adjusted_rand_score(y, ipe.labels_)),
            "ipe_predict_ari": float(adjusted_rand_score(
                ipe.labels_, ipe.predict(X, delta=0.5))),
            "ipe_n_iter": int(ipe.n_iter_),
            "tomography_ari": float(adjusted_rand_score(y, tomo.labels_)),
            "tomography_n_iter": int(tomo.n_iter_)}


GRID = tuple(round(0.1 * i, 1) for i in range(11))
KS_ALPHA = 1e-3
ARI_MARGIN = 0.05  # the port's fit ARI against the JAX fit's


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(n=600, m=8, k=4, std=1.0, seed=3):
    X, y = make_blobs(n_samples=n, centers=k, n_features=m,
                      cluster_std=std, random_state=seed)
    return X.astype(np.float32), y


def _tall(n=4000, m=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)) * np.linspace(1, 3, m)).astype(
        np.float32)


# -- sketched statistics ---------------------------------------------------


def test_sketch_components_match_jax_and_finalize_alike():
    X = _tall()
    idx = tengine.sample_indices(np.random.default_rng(7), X.shape[0], 512)
    t = tengine.fetch_components(tengine.sketch_components(
        _t(X), _t(idx), GRID))
    j = {k: np.asarray(v) for k, v in jengine.sketch_components_traced(
        jnp.asarray(X), jnp.asarray(idx), GRID).items()}
    assert set(t) == set(j)
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=1e-4,
                                   err_msg=name)
    kw = dict(n=X.shape[0], m=X.shape[1], s=512, mu_grid=GRID,
              delta_stat=0.05)
    ts = tengine.finalize_components(t, **kw)
    js = jengine.finalize_components(j, **kw)
    assert ts.eta == pytest.approx(js.eta, rel=1e-4)
    assert ts.conservative_mu()[0] == js.conservative_mu()[0]
    assert ts.conservative_mu()[1] == pytest.approx(js.conservative_mu()[1],
                                                    rel=1e-4)
    assert ts.condition_number() == pytest.approx(js.condition_number(),
                                                  rel=1e-4)
    ti, ji = ts.info(), js.info()
    for name in ("sigma_min_estimate", "sigma_min_lower", "mu_estimate",
                 "mu_upper", "eta", "frob"):
        assert ti[name] == pytest.approx(ji[name], rel=1e-4, abs=1e-6), name
    assert ti["sigma_certified"] == ji["sigma_certified"]


def test_fit_prestats_sketched_matches_jax():
    X = _tall(seed=1)
    idx = tengine.sample_indices(np.random.default_rng(2), X.shape[0], 256)
    j = jqk.fit_prestats(jnp.asarray(X), quantum=True, mu_grid=GRID,
                         sketch_idx=jnp.asarray(idx))
    t = tqk.fit_prestats(_t(X), quantum=True, mu_grid=GRID,
                         sketch_idx=_t(idx))
    assert "eta" not in t and "sigma_min" not in t
    for name, val in j["sketch"].items():
        np.testing.assert_allclose(t["sketch"][name].numpy(),
                                   np.asarray(val), rtol=1e-4, err_msg=name)


def test_sketched_fit_sets_the_statistics_jax_folds_from_the_same_rows():
    """The estimator's sketched route: its η, μ, κ and sketch_info_ are
    what the JAX package's components of the same sampled rows (drawn by
    the fit's numpy generator, seeded [random_state, 0x5CE7]) fold to."""
    X = _tall(n=16_384, m=6, seed=3)
    est = QKMeans(n_clusters=3, n_init=1, max_iter=3, delta=0.5,
                  true_distance_estimate=False, random_state=5).fit(X)
    idx = jengine.sample_indices(
        np.random.default_rng([5, tengine.SKETCH_SEED]), X.shape[0], 4096)
    comp = {k: np.asarray(v) for k, v in jengine.sketch_components_traced(
        jnp.asarray(X), jnp.asarray(idx), GRID).items()}
    js = jengine.finalize_components(comp, n=X.shape[0], m=X.shape[1],
                                     s=4096, mu_grid=GRID, delta_stat=0.05)
    assert est.sketch_info_["sketched"]
    assert est.eta_ == pytest.approx(js.eta, rel=1e-4)
    assert est.norm_mu_ == js.conservative_mu()[0]
    assert est.mu_ == pytest.approx(js.conservative_mu()[1], rel=1e-4)
    assert est.condition_number_ == pytest.approx(js.condition_number(),
                                                  rel=1e-4)
    assert est.sketch_info_["sigma_min_lower"] == pytest.approx(
        js.info()["sigma_min_lower"], rel=1e-4, abs=1e-6)


def test_sigma_min_and_sketch_lambda_min_decompose_in_float64(monkeypatch):
    """σ_min and the sketch's λ_min decompose their float32 Gram in
    float64 and round back, as the spectrum does."""
    seen = []
    real = torch.linalg.eigvalsh

    def spy(G, *a, **kw):
        seen.append(G.dtype)
        return real(G, *a, **kw)

    monkeypatch.setattr(torch.linalg, "eigvalsh", spy)
    X = _t(_tall(n=600, m=12))
    from sq_learn_tpu_torch.ops.linalg import smallest_singular_value

    sigma = smallest_singular_value(X)
    flat = tengine.sample_kernel(X[:300], 2.0, mu_grid=GRID)
    assert seen == [torch.float64, torch.float64]
    assert sigma.dtype == flat.dtype == torch.float32
    X64 = X.double()
    assert float(sigma) == pytest.approx(
        float(real(X64.T @ X64)[0]) ** 0.5, rel=1e-5)


# -- the IPE E-step --------------------------------------------------------


def test_ipe_selection_matches_jax_given_the_same_d2():
    """With the distances fixed, the IPE mode's pick (window 0) is the
    nearest center, uniform among exact ties, as the JAX package's
    categorical over the same mask."""
    rng = np.random.default_rng(4)
    n, k = 4000, 5
    d2 = rng.integers(0, 4, size=(n, k)).astype(np.float32)
    labels = tqk.pick_labels(as_generator(0, "cpu"), _t(d2), 0.0).numpy()
    tie = d2 == d2.min(1, keepdims=True)
    assert tie[np.arange(n), labels].all()
    single = tie.sum(1) == 1
    jlab = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.where(jnp.asarray(tie), 0.0, -jnp.inf),
        axis=1))
    np.testing.assert_array_equal(labels[single], jlab[single])
    # among ties: the rank of the picked center within the tied set is
    # uniform on both sides (chi-square at α = 1e-3)
    two = tie.sum(1) == 2
    for lab in (labels, jlab):
        first = np.argmax(tie, axis=1)
        share = np.bincount((lab[two] != first[two]).astype(int),
                            minlength=2)
        assert stats.chisquare(share).pvalue >= KS_ALPHA


def _ipe_pairs():
    # (‖x‖², ‖c‖², ⟨x, c⟩) pairs of a q-means E-step's range
    return np.array([[4.0, 9.0, 1.5], [100.0, 80.0, 60.0],
                     [2500.0, 3000.0, -400.0], [1.0, 1.0, 0.99]],
                    np.float32)


@pytest.mark.parametrize("eps", [0.25, 0.05])
def test_batched_ipe_matrix_matches_jax_in_distribution(eps):
    """The (R, n, k) batch of ipe_matrix draws each pair's estimate from
    the distribution of the JAX package's (n, k) ipe_matrix: two-sample
    KS per pair at α = 1e-3, and each side within ε·max(1, |ip|) at a
    share ≥ 1 − γ, γ = e^{−Q·C} the median bound of Q = 5 repetitions."""
    pairs = _ipe_pairs()
    reps, Q, W = 400, 5, tqk.IPE_WINDOW
    # the port: R = reps restarts of one row and one center per pair; the
    # JAX side: reps rows of the same pair
    ests_t = []
    for i, (xs, cs, ip) in enumerate(pairs):
        x_sq = _t(np.full(1, xs, np.float32))
        c = _t(np.full((reps, 1), cs, np.float32))
        inn = _t(np.full((reps, 1, 1), ip, np.float32))
        ests_t.append(test_.ipe_matrix(as_generator(i, "cpu"), inn, x_sq, c,
                                       eps, Q=Q, window=W).numpy().ravel())
    ests_j = []
    for i, (xs, cs, ip) in enumerate(pairs):
        ests_j.append(np.asarray(jest.ipe_matrix(
            jax.random.PRNGKey(i), jnp.full((reps, 1), ip, jnp.float32),
            jnp.full((reps,), xs, jnp.float32),
            jnp.full((1,), cs, jnp.float32), eps, Q=Q,
            window=W)).ravel())
    gamma = math.exp(-Q * 2 * (8 / math.pi**2 - 0.5) ** 2)
    for (xs, cs, ip), et, ej in zip(pairs, ests_t, ests_j):
        assert stats.ks_2samp(et, ej).pvalue >= KS_ALPHA, (xs, cs, ip)
        bound = eps * max(1.0, abs(ip))
        for e in (et, ej):
            assert np.mean(np.abs(e - ip) <= bound * (1 + 1e-5)) >= 1 - gamma


def test_ipe_matrix_blocks_the_rows_of_a_batch(monkeypatch):
    """Row blocks of an (R, n, k) batch: the same shapes and guarantee as
    one block, and an (n, k) input still works."""
    monkeypatch.setattr(test_, "_IPE_BLOCK_ELEMS", 3 * 2 * 3 * 33 * 7)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 6)).astype(np.float32)
    C = rng.normal(size=(3, 2, 6)).astype(np.float32)   # (R, k, m)
    inner = _t(np.einsum("nm,rkm->rnk", X, C))
    xs, cs = _t((X * X).sum(1)), _t((C * C).sum(-1))
    est = test_.ipe_matrix(as_generator(0, "cpu"), inner, xs, cs, 0.1, Q=3,
                           window=16)
    assert est.shape == (3, 50, 2)
    bound = 0.1 * torch.clamp(inner.abs(), min=1.0)
    assert float(((est - inner).abs() <= bound).float().mean()) >= 0.6
    single = test_.ipe_matrix(as_generator(0, "cpu"), inner[0], xs, cs[0],
                              0.1, Q=3, window=16)
    assert single.shape == (50, 2)


def test_ipe_e_step_over_restarts_keeps_its_error_model():
    X, _ = _blobs()
    C = np.stack([X[:4], X[4:8]])
    xsq = (X * X).sum(1)
    labels, inertia, min_d2 = tqk.e_step(
        as_generator(0, "cpu"), _t(X), torch.ones(len(X)), _t(C), _t(xsq),
        delta=0.5, mode="ipe")
    assert labels.shape == (2, len(X)) and inertia.shape == (2,)
    d2 = ((X[None, :, None, :] - C[:, None]) ** 2).sum(-1)
    # IPE errs by ε·max(1, |ip|) per inner product (ε = δ/2), so a picked
    # center's true distance is within 2·2ε·max(1, |ip|) of the nearest
    ip = np.abs(np.einsum("nm,rkm->rnk", X, C))
    slack = 4 * 0.25 * np.maximum(1, ip).max(-1)
    sel = np.take_along_axis(d2, labels.numpy()[..., None].astype(int),
                             -1)[..., 0]
    assert np.mean(sel <= d2.min(-1) + slack) >= 0.99
    assert np.all(np.isfinite(min_d2.numpy()))


# -- the fit: IPE and tomography -------------------------------------------


def test_ipe_at_a_tiny_delta_equals_the_delta0_labels():
    X, _ = _blobs(std=0.5)
    kw = dict(n_clusters=4, n_init=2, random_state=0)
    classic = QKMeans(delta=0.0, **kw)
    with pytest.warns(UserWarning, match="classic"):
        classic.fit(X)
    ipe = QKMeans(delta=1e-4, **kw).fit(X)
    np.testing.assert_array_equal(ipe.labels_, classic.labels_)


@pytest.mark.parametrize("mode", ["ipe", "tomography",
                                  "gaussian_tomography"])
def test_fit_ari_matches_jax_on_blobs(mode):
    X, y = _blobs(std=2.5, seed=6)
    kw = dict(n_clusters=4, n_init=3, delta=0.5, random_state=0)
    if mode != "ipe":
        kw.update(true_distance_estimate=False, intermediate_error=True,
                  true_tomography=mode == "tomography")
    t = QKMeans(**kw).fit(X)
    j = JaxQKMeans(**kw).fit(X)
    t_ari = adjusted_rand_score(y, t.labels_)
    j_ari = adjusted_rand_score(y, j.labels_)
    assert t_ari >= j_ari - ARI_MARGIN, (t_ari, j_ari)
    assert np.isfinite(t.cluster_centers_).all()


def test_gaussian_tomography_keeps_every_center_row_within_half_delta():
    X, _ = _blobs()
    labels = _t(np.arange(len(X)) % 4).to(torch.int32)
    labels = torch.stack([labels, torch.roll(labels, 1)])
    old = _t(np.stack([X[:4], X[4:8]]))
    kw = dict(delta=0.5, min_d2=None)
    exact = tqk.m_step(as_generator(0, "cpu"), _t(X), torch.ones(len(X)),
                       labels, old, **kw)
    for seed in range(5):
        noisy = tqk.m_step(as_generator(seed, "cpu"), _t(X),
                           torch.ones(len(X)), labels, old,
                           intermediate_error=True, true_tomography=False,
                           **kw)
        row_err = torch.linalg.norm(noisy - exact, dim=-1)
        assert bool((row_err <= 0.25 * (1 + 1e-5)).all())
        assert bool((row_err > 0).any())


def test_true_tomography_of_the_centers_is_per_row():
    rng = np.random.default_rng(0)
    C = _t(rng.normal(size=(3, 4, 64)).astype(np.float32))
    est = tqk.center_tomography(as_generator(0, "cpu"), C, 0.25)
    assert est.shape == C.shape
    err = torch.linalg.norm(est - C, dim=-1)
    # Algorithm 4.1 holds each row within δ with high probability
    assert float((err <= 0.25 * torch.linalg.norm(C, dim=-1)).float()
                 .mean()) >= 0.9


def test_a_frozen_restart_keeps_its_centers_bit_equal(monkeypatch):
    """Once a restart's stop rule fired, the centers it carries through
    the later iterations (which still run for the others) are bit-equal
    to those it stopped with, under IPE and true tomography draws."""
    seen = []
    real = tqk.e_step

    def spy(generator, X, weights, centers, *a, **kw):
        seen.append(centers.clone())
        return real(generator, X, weights, centers, *a, **kw)

    monkeypatch.setattr(tqk, "e_step", spy)
    X, _ = _blobs(n=300, std=2.0, seed=2)
    Xc = (X - X.mean(0)).astype(np.float32)
    c0 = np.stack([Xc[[5, 80, 160, 240]], Xc[[1, 2, 3, 4]],
                   Xc[[9, 99, 199, 299]]])
    _, _, _, n_iter, _ = tqk.lloyd_single(
        as_generator(0, "cpu"), _t(Xc), torch.ones(300), _t(c0),
        _t((Xc * Xc).sum(1)), delta=0.5, mode="ipe", max_iter=40, tol=0.0,
        patience=2, intermediate_error=True)
    steps = seen[:-2]   # the last two calls are the final re-evaluation
    n_iter = n_iter.tolist()
    assert len(set(n_iter)) > 1, n_iter
    for r, stop in enumerate(n_iter):
        for later in steps[stop + 1:]:
            assert torch.equal(later[r], steps[stop][r])


def test_the_same_seed_gives_the_same_fit_twice():
    X, _ = _blobs(std=2.0, seed=8)
    kw = dict(n_clusters=4, n_init=4, delta=0.5, intermediate_error=True,
              random_state=3)
    a, b = QKMeans(**kw).fit(X), QKMeans(**kw).fit(X)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    assert a.n_iter_ == b.n_iter_


def test_ipe_with_a_reduced_compute_dtype_warns_and_fits():
    X, _ = _blobs()
    with pytest.warns(RuntimeWarning, match="IPE"):
        est = QKMeans(n_clusters=4, n_init=1, delta=0.5,
                      compute_dtype="bfloat16", random_state=0).fit(X)
    assert np.isfinite(est.cluster_centers_).all()


def test_ipe_predict_and_k_means_default_mode():
    X, y = _blobs(std=1.0)
    est = QKMeans(n_clusters=4, n_init=2, delta=0.5, random_state=0).fit(X)
    pred = est.predict(X, delta=0.5)
    assert pred.shape == (len(X),)
    assert adjusted_rand_score(est.labels_, pred) >= 0.95
    centers, labels, inertia = k_means(X, 4, delta=0.5, random_state=0,
                                       n_init=2)
    assert centers.shape == (4, 8) and np.isfinite(inertia)


def test_ipe_predict_on_jax_state_agrees_with_jax():
    X, _ = _blobs(std=1.0)
    j = JaxQKMeans(n_clusters=4, n_init=2, delta=0.5, random_state=0).fit(X)
    t = qkmeans_from_numpy(vars(j), device="cpu", params=j.get_params())
    assert adjusted_rand_score(j.predict(X, delta=0.5),
                               t.predict(X, delta=0.5)) >= 0.95


# -- the runtime model -----------------------------------------------------


@pytest.mark.parametrize("well_clusterable", [False, True])
def test_quantum_runtime_model_matches_jax(well_clusterable):
    X, _ = _blobs()
    j = JaxQKMeans(n_clusters=4, n_init=2, delta=0.5,
                   true_distance_estimate=False, random_state=0).fit(X)
    t = qkmeans_from_numpy(vars(j), device="cpu", params=j.get_params())
    for args in ((70_000, 784), (np.arange(1, 5) * 1000, 784)):
        tq, tc = t.quantum_runtime_model(*args,
                                         well_clusterable=well_clusterable)
        jq, jc = j.quantum_runtime_model(*args,
                                         well_clusterable=well_clusterable)
        np.testing.assert_allclose(tq, jq, rtol=1e-4)
        np.testing.assert_allclose(tc, jc, rtol=1e-4)
    tq, tc = t.runtime_comparison(70_000, 784,
                                  well_clusterable=well_clusterable)
    jq, jc = j.runtime_comparison(70_000, 784,
                                  well_clusterable=well_clusterable)
    assert tq.shape == tc.shape == (100, 100)
    np.testing.assert_allclose(tq, jq, rtol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4)


def test_runtime_model_needs_delta_and_renders(tmp_path):
    X, _ = _blobs()
    with pytest.warns(UserWarning, match="classic"):
        classic = QKMeans(n_clusters=4, n_init=1, delta=0.0).fit(X)
    with pytest.raises(ValueError, match="delta > 0"):
        classic.quantum_runtime_model(100, 8)
    est = QKMeans(n_clusters=4, n_init=1, delta=0.5, random_state=0).fit(X)
    out = tmp_path / "surfaces.png"
    q, c = est.runtime_comparison(1000, 8, saveas=str(out))
    assert out.stat().st_size > 0 and q.shape == (100, 100)


# -- the slice as a whole, small ---------------------------------------------


def test_path_a_at_a_small_size_against_jax():
    """Path A (q-means at its defaults, predict/score/transform, both
    runtime models) at 3 000 × 16 against the JAX fit of the same data:
    ARI within ARI_MARGIN, the exact statistics η and μ at rtol 1e-4 and
    κ at rtol 1e-3 (the JAX side decomposes the Gram in float32)."""
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, y = synthetic_surrogate(3000, 16, 10, seed=784)
    kw = dict(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
              random_state=0)
    t = QKMeans(**kw).fit(X)
    j = JaxQKMeans(**kw).fit(X)
    assert adjusted_rand_score(y, t.labels_) >= adjusted_rand_score(
        y, j.labels_) - ARI_MARGIN
    assert not t.sketch_info_["sketched"]
    assert t.eta_ == pytest.approx(j.eta_, rel=1e-4)
    assert t.mu_ == pytest.approx(j.mu_, rel=1e-4)
    assert t.condition_number_ == pytest.approx(j.condition_number_,
                                                rel=1e-3)
    pred = t.predict(X, delta=0.5)
    assert adjusted_rand_score(t.labels_, pred) >= 0.95
    assert np.isfinite(t.score(X)) and t.transform(X).shape == (3000, 10)
    for wc in (False, True):
        q, c = t.quantum_runtime_model(70_000, 784, well_clusterable=wc)
        assert np.isfinite(q) and q > 0 and c > 0
    q, c = t.runtime_comparison(70_000, 784)
    assert q.shape == c.shape == (100, 100)


def test_path_b_at_a_small_size():
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, y = synthetic_surrogate(3000, 16, 10, seed=784)
    est = QKMeans(n_clusters=10, n_init=10, delta=0.5,
                  true_distance_estimate=False, intermediate_error=True,
                  random_state=0).fit(X)
    assert np.isfinite(est.cluster_centers_).all()
    assert adjusted_rand_score(y, est.labels_) >= 0.95


if __name__ == "__main__":
    print(jax_kappa_errors(), flush=True)
    print(jax_fit_aris(), flush=True)
