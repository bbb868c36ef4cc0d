"""The port's qPCA (``models/qpca``, the ``decomposition`` facade) against
the JAX package's ``QPCA``, on the CPU, and the reference's MNIST trial
as a whole at a small size.

Tolerances:
- ε = δ = 0 (classical): spectra, ``noise_variance_``, transforms,
  ``score_samples`` and covariances at rtol 1e-4; components (same signs)
  at rtol 1e-4 with an absolute floor of 1e-4 × the largest entry, since
  they hold near-zero entries; float32 sums are taken in another order and
  the port decomposes the float32 Gram in float64.
- ε, δ > 0: the bounds ``tests/test_qpca.py::TestQuantumEstimators``
  checks on the JAX side, on the same data (the two sides draw from
  different generators).
- The trial (qPCA → quantum transform → 10-fold 7-NN CV) at ε = δ = 0:
  fold scores equal to JAX's.

Run as a script (``python tests/test_torch_qpca.py``) it measures the JAX
package's own float32 error of ``explained_variance_`` at the trial's
shape, 70 000 × 784 with 61 components, against a float64 reference — the
number ``chip_smoke.py``'s spectrum check is scaled from — and the same
error of its bfloat16 partial-U route, which sets the smoke's bfloat16
tolerance.
"""

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu_torch import NotFittedError, config_context, clone
from sq_learn_tpu_torch.datasets import synthetic_surrogate
from sq_learn_tpu_torch.models import PCA, QPCA
from sq_learn_tpu_torch.models.qpca import (_infer_dimension,
                                            singular_value_estimates)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    # low-rank-ish data with decaying spectrum (tests/test_qpca.py's)
    B = rng.normal(size=(200, 20)) @ rng.normal(size=(20, 30))
    X = B + 0.05 * rng.normal(size=(200, 30))
    return X.astype(np.float64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol=1e-4):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


def jax_spectrum_error(n, m, k, seed=784, compute_dtype=None):
    """Largest relative error of the JAX package's float32
    ``explained_variance_`` (its partial-U Gram route, ``centered_svd_topk``,
    with ``compute_dtype`` on its GEMMs) over the first k components of
    ``synthetic_surrogate(n, m, 10, seed)``, against the same route in
    float64."""
    import jax.numpy as jnp

    from sq_learn_tpu.datasets import _loaders
    from sq_learn_tpu.ops.linalg import centered_svd_topk

    X, _ = _loaders.synthetic_surrogate(n, m, 10, seed=seed)
    _, _, S, _ = centered_svd_topk(jnp.asarray(X), k,
                                   compute_dtype=compute_dtype)
    ev32 = np.asarray(S)[:k].astype(np.float64) ** 2 / (n - 1)
    Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
    ev64 = np.linalg.eigvalsh(Xc.T @ Xc)[::-1][:k] / (n - 1)
    return float(np.max(np.abs(ev32 - ev64) / ev64))


# -- ε = δ = 0 against the JAX package ---------------------------------------


CLASSICAL = [("full", 10), ("full", "mle"), ("full", 0.9), ("full", None),
             ("randomized", 5), ("auto", 8)]


@pytest.mark.parametrize("solver,n_components", CLASSICAL)
def test_classical_fit_matches_jax(data, solver, n_components):
    j = JaxQPCA(n_components=n_components, svd_solver=solver,
                random_state=0).fit(data)
    t = QPCA(n_components=n_components, svd_solver=solver,
             random_state=0).fit(data)
    assert t.n_components_ == j.n_components_
    assert t._fit_svd_solver == j._fit_svd_solver
    for name in ("explained_variance_", "explained_variance_ratio_",
                 "singular_values_"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(t.noise_variance_, j.noise_variance_,
                               rtol=1e-4)
    # the data has rank 20 plus 0.05 noise: past the 20th component the
    # eigenvalues crowd and their vectors are not determined to float32
    # precision, on either side
    k = min(t.n_components_, 20)
    _close(t.components_[:k], j.components_[:k])
    np.testing.assert_allclose(t.mean_, j.mean_, rtol=1e-5, atol=1e-6)
    _close(_np(t.transform(data))[:, :k], j.transform(data)[:, :k])
    Z = _np(t.transform(data))
    _close(t.inverse_transform(Z), j.inverse_transform(Z))
    _close(t.get_covariance(), j.get_covariance())


@pytest.mark.parametrize("solver,n_components", [("full", 10), ("full", 0.9),
                                                 ("randomized", 5)])
def test_probabilistic_pca_matches_jax(data, solver, n_components):
    j = JaxQPCA(n_components=n_components, svd_solver=solver,
                random_state=0).fit(data)
    t = QPCA(n_components=n_components, svd_solver=solver,
             random_state=0).fit(data)
    _close(t.get_precision(), j.get_precision())
    np.testing.assert_allclose(_np(t.score_samples(data)),
                               j.score_samples(data), rtol=1e-4)
    np.testing.assert_allclose(t.score(data), j.score(data), rtol=1e-4)


def test_whiten_and_fit_transform_match_jax(data):
    j = JaxQPCA(n_components=6, whiten=True, random_state=0)
    t = QPCA(n_components=6, whiten=True, random_state=0)
    _close(t.fit_transform(data), j.fit_transform(data))
    Z = _np(t.transform(data))
    _close(t.inverse_transform(Z), j.inverse_transform(Z))
    assert np.allclose(Z.var(0, ddof=1), 1.0, rtol=1e-3)
    from sq_learn_tpu.models import PCA as JaxPCA

    p = PCA(n_components=6, svd_solver="full", random_state=0)
    jp = JaxPCA(n_components=6, svd_solver="full", random_state=0)
    _close(p.fit_transform(data), jp.fit_transform(data))
    Z = _np(p.transform(data))
    _close(p.inverse_transform(Z), jp.inverse_transform(Z))


def test_mle_dimension_matches_jax_internal(data):
    from sq_learn_tpu.models.qpca import _infer_dimension as jinfer

    ev = np.sort(np.random.default_rng(0).uniform(0.1, 10, 30))[::-1]
    assert _infer_dimension(ev, 200) == jinfer(ev, 200)


def test_partial_u_route_matches_the_full_route():
    X, _ = synthetic_surrogate(1600, 32, 10, seed=5)
    topk = QPCA(n_components=6, svd_solver="full", random_state=0).fit(X)
    full = QPCA(n_components=0.999, svd_solver="full", random_state=0).fit(X)
    j = JaxQPCA(n_components=6, svd_solver="full", random_state=0).fit(X)
    np.testing.assert_allclose(topk.explained_variance_,
                               full.explained_variance_[:6], rtol=1e-4)
    _close(topk.left_sv, full.left_sv[:6])
    _close(topk.left_sv, j.left_sv)
    assert topk.left_sv.shape == (6, 1600)
    assert topk.ingest_ == "monolithic"


def test_clone_and_device_parameter(data):
    est = QPCA(n_components=3, random_state=0, device="cpu")
    assert clone(est).get_params() == est.get_params()
    est.fit(data)
    assert est.transform(data).device.type == "cpu"
    with pytest.raises(NotFittedError):
        QPCA().transform(data)


def test_cuda_request_without_cuda_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QPCA(n_components=2, device="cuda").fit(data)
    with config_context(device="cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QPCA(n_components=2).fit(data)


# -- ε, δ > 0: the JAX side's bounds on the same data ------------------------


def test_sv_estimates_within_eps():
    rng = np.random.default_rng(0)
    S = np.sort(rng.uniform(0.5, 10.0, size=30))[::-1].astype(np.float32)
    scale = float(np.linalg.norm(S) * 1.2)
    est = singular_value_estimates(torch.Generator().manual_seed(0),
                                   torch.from_numpy(S), scale, 0.05,
                                   n_features=64).numpy()
    assert np.max(np.abs(est - S)) < scale * 0.05 * (0.05 + np.pi)


def test_spectral_norm_estimation(data):
    pca = QPCA(n_components=10, random_state=0).fit(
        data, spectral_norm_est=True, eps=0.5, delta=0.01)
    true = pca.spectral_norm
    assert abs(pca.est_spectral_norm - true) / true < 0.15


def test_condition_number_estimation(data):
    pca = QPCA(random_state=0).fit(
        data, condition_number_est=True, eps=0.1, delta=0.001, p=0.999)
    sigma_min = pca.all_singular_values_[-1]
    assert pca.est_sigma_min == pytest.approx(sigma_min, rel=1.0)
    assert pca.est_cond_number == pytest.approx(
        pca.spectral_norm / pca.est_sigma_min)


def test_factor_score_ratio_sum(data):
    pca = QPCA(n_components=30, random_state=0, compute_mu=True).fit(data)
    S = pca.singular_values_
    theta = 0.5 * (S[19] + S[20]) / pca.muA
    p_est = pca.quantum_factor_score_ratio_sum(eps=0.01, theta=theta,
                                               eta=0.01)
    p_true = float(np.sum(S[:20] ** 2) / np.sum(S**2))
    assert abs(p_est - p_true) < 0.05


def test_estimate_theta_binary_search(data):
    pca = QPCA(random_state=0).fit(
        data, theta_estimate=True, eps_theta=0.05, eta=0.05, p=0.8)
    S = pca.singular_values_
    mass = np.sum(S[S >= pca.est_theta] ** 2) / np.sum(S**2)
    assert abs(mass - 0.8) < 0.15


def test_estimate_all_gaussian(data):
    pca = QPCA(n_components=8, random_state=0).fit(
        data, estimate_all=True, eps=0.01, delta=0.05, theta_major=1e-6,
        true_tomography=False)
    assert pca.topk == 8
    err = np.linalg.norm(pca.estimate_right_sv - pca.components_, axis=1)
    assert np.all(err < 0.2)
    np.testing.assert_allclose(np.sum(pca.estimate_fs_ratio),
                               np.sum(pca.explained_variance_ratio_all[:8]),
                               atol=0.1)


def test_estimate_all_true_tomography_small():
    X = np.random.default_rng(3).normal(size=(60, 8))
    pca = QPCA(n_components=3, random_state=0).fit(
        X, estimate_all=True, eps=0.01, delta=0.3, theta_major=1e-6,
        true_tomography=True)
    err = np.linalg.norm(pca.estimate_right_sv - pca.components_, axis=1)
    assert np.all(err < 0.45)


def test_least_k_extraction(data):
    pca = QPCA(random_state=0).fit(
        data, estimate_least_k=True, eps=0.01, delta=0.05, theta_minor=5.0,
        true_tomography=False, p=0.999)
    S = pca.singular_values_
    expected = int(np.sum(S[~np.isclose(S, 0)] < 5.0))
    assert abs(pca.least_k - expected) <= 2
    assert pca.estimate_least_right_sv.shape[1] == data.shape[1]


def test_delta_eps_zero_is_classical(data):
    pca = QPCA(n_components=5, random_state=0).fit(
        data, estimate_all=True, eps=0, delta=0, theta_major=1e-9)
    np.testing.assert_allclose(pca.estimate_right_sv, pca.components_)
    np.testing.assert_allclose(pca.estimate_s_values, pca.singular_values_)
    j = JaxQPCA(n_components=5, random_state=0).fit(
        data, estimate_all=True, eps=0, delta=0, theta_major=1e-9)
    _close(pca.estimate_left_sv, j.estimate_left_sv)
    np.testing.assert_allclose(pca.estimate_fs, j.estimate_fs, rtol=1e-4)


def test_eps_zero_estimators_exact(data):
    pca = QPCA(random_state=0).fit(
        data, spectral_norm_est=True, condition_number_est=True, eps=0,
        p=0.999)
    assert pca.est_spectral_norm == pca.spectral_norm
    assert pca.est_sigma_min == float(pca.all_singular_values_[-1])


@pytest.fixture(scope="module")
def fitted(data):
    with config_context(device="cpu"):
        return QPCA(n_components=5, random_state=0).fit(
            data, estimate_all=True, eps=0.01, delta=0.02,
            theta_major=1e-6, true_tomography=False)


def test_quantum_transform_paths(fitted, data):
    with pytest.warns(UserWarning, match="quantum parameter"):
        fitted.transform(data, classic_transform=True, epsilon_delta=0.5)
    Xq = _np(fitted.transform(data, classic_transform=False,
                              use_classical_components=False))
    Xc = _np(fitted.transform(data))
    assert np.linalg.norm(Xq - Xc) / np.linalg.norm(Xc) < 0.1
    kw = dict(classic_transform=False, quantum_representation=True,
              epsilon_delta=0.1, true_tomography=False)
    Y = fitted.transform(data, norm="None", psi=0.1,
                         **kw)["quantum_representation_results"]
    assert Y.shape == (len(data), 5)
    A_sign, _, f_norm = fitted.transform(
        data, norm="est_representation", psi=0,
        **kw)["quantum_representation_results"]
    assert A_sign.shape == (len(data), 5) and f_norm >= 0
    qs = fitted.transform(data[:16], norm="q_state", psi=0.1,
                          **kw)["quantum_representation_results"]
    np.testing.assert_allclose(float(qs.probabilities.sum()), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="psi"):
        fitted.transform(data, norm="None", psi=0, **kw)
    with pytest.raises(ValueError, match="epsilon_delta"):
        fitted.transform(data, norm="None", psi=0.1,
                         **{**kw, "epsilon_delta": 0})
    Y = fitted.transform(data, norm="f_norm", psi=0.1,
                         **kw)["quantum_representation_results"]
    np.testing.assert_allclose(float(torch.linalg.norm(Y)), 1.0, rtol=1e-5)
    Xr_c = _np(fitted.inverse_transform(Xc))
    Xr_q = _np(fitted.inverse_transform(Xc, use_classical_components=False))
    assert np.linalg.norm(Xr_q - Xr_c) / np.linalg.norm(Xr_c) < 0.1


def test_check_sv_uniform_distribution_is_stored_and_cleared(data):
    pca = QPCA(n_components=5, random_state=0)
    pca.fit(data, estimate_all=True, eps=0.01, delta=0.02, theta_major=1e-6,
            true_tomography=False, check_sv_uniform_distribution=True)
    assert pca.sv_uniform_distribution_.shape == (5,)
    pca.fit(data, estimate_all=True, eps=0.01, delta=0.02, theta_major=1e-6,
            true_tomography=False)
    assert not hasattr(pca, "sv_uniform_distribution_")


def test_q_ret_variance_and_ret_variance(data):
    pca = QPCA(random_state=0, compute_mu=True).fit(data)
    k = pca.q_ret_variance(100_000, 0.9)
    exact = pca.ret_variance(pca.explained_variance_ratio_all, 0.9)
    assert abs(k - exact) <= 2
    assert QPCA(n_components=4).fit(data).q_ret_variance(10, 0.9) == 4


def test_fit_validation(data):
    assert QPCA(random_state=0).fit(data).n_components_ == 30
    with pytest.raises(ValueError, match="theta_major"):
        QPCA().fit(data, estimate_all=True)
    with pytest.raises(ValueError, match="theta_minor"):
        QPCA().fit(data, estimate_least_k=True)
    with pytest.raises(ValueError, match="svd_solver"):
        QPCA(n_components=3, svd_solver="randomized").fit(
            data, estimate_all=True, theta_major=1.0)
    with pytest.raises(ValueError, match="ingest"):
        QPCA(ingest="lazy").fit(data)
    with pytest.raises(ValueError, match="mu"):
        QPCA(n_components=3).fit(data).quantum_factor_score_ratio_sum(
            0.1, 0.1, 0.1)


class _Store:
    """An object with the JAX package's shard-store protocol."""
    shape, dtype, nbytes, fingerprint = (10, 3), np.float32, 120, "x"

    def read_rows(self, lo, hi):
        return np.zeros((hi - lo, 3), np.float32)


@pytest.mark.parametrize("kw,fit_input,item", [
    (dict(mesh=object()), None, "item 6"),
    (dict(ingest="streamed"), None, "item 7"),
    (dict(compute_dtype="bfloat16"), None, "item 7"),
    (dict(compute_dtype="float16"), None, "item 7"),
    ({}, _Store(), "partial-U Gram route"),
])
def test_unported_options_raise_naming_the_roadmap(data, kw, fit_input,
                                                   item):
    """Every option of this test's old subject was ported since. ``mesh``
    (item 6a): a mesh that is not a ``Mesh`` raises TypeError, and a CPU
    mesh fits the single-device spectrum (``tests/test_torch_parallel_
    pca.py`` holds it against the JAX package's mesh fit).
    ``ingest='streamed'``, the reduced compute dtypes and store-backed
    ingest (item 7): on this short input (not tall enough for the partial-U route)
    'streamed' warns and ingests monolithically, a compute dtype warns
    that it did not engage, and a 10-row store, which has no resident
    form, raises the JAX package's ValueError, while a tall store fits on
    the streamed route (``tests/test_torch_oocore.py`` holds it in
    full)."""
    X = data if fit_input is None else fit_input
    if fit_input is not None:
        from sq_learn_tpu_torch.oocore import ArraySource

        with pytest.raises(ValueError, match=item):
            QPCA(n_components=3, **kw).fit(X)
        tall = ArraySource(np.tile(data, (2, 1))[:, :6], shard_rows=50)
        pca = QPCA(n_components=3, **kw).fit(tall)
        ref = QPCA(n_components=3, svd_solver="full",
                   ingest="streamed").fit(np.tile(data, (2, 1))[:, :6])
        assert pca.ingest_ == "streamed"
        np.testing.assert_array_equal(pca.singular_values_,
                                      ref.singular_values_)
        return
    if "ingest" in kw or "compute_dtype" in kw:
        with pytest.warns(RuntimeWarning, match="monolithically|partial-U"):
            pca = QPCA(n_components=3, svd_solver="full", **kw).fit(X)
        ref = QPCA(n_components=3, svd_solver="full").fit(X)
        assert pca.ingest_ == "monolithic"
        assert pca.effective_compute_dtype_ is None
        np.testing.assert_array_equal(pca.singular_values_,
                                      ref.singular_values_)
        return
    from sq_learn_tpu_torch.parallel import make_mesh

    with pytest.raises(TypeError, match="make_mesh"):
        QPCA(n_components=3, **kw).fit(X)
    meshed = QPCA(n_components=3, mesh=make_mesh(["cpu"] * 4)).fit(X)
    ref = QPCA(n_components=3, svd_solver="full").fit(X)
    assert meshed._fit_svd_solver == "full"
    np.testing.assert_allclose(meshed.singular_values_,
                               ref.singular_values_, rtol=1e-4)


def test_runtime_model_and_truncated_svd_raise_naming_the_roadmap(data):
    """Both parts of this test's old subject are ported now: the runtime
    model returns finite positive cost surfaces, and the decomposition
    facade's TruncatedSVD fits (its parity with the JAX package is in
    ``tests/test_torch_truncated_svd.py``)."""
    from sq_learn_tpu_torch.decomposition import TruncatedSVD

    pca = QPCA(n_components=3).fit(data, estimate_all=True, eps=0.01,
                                   delta=0.01, theta_major=1e-6)
    surfaces = pca.accumulate_q_runtime(100, 10)
    assert len(surfaces) == 1 and np.isfinite(surfaces[0]).all()
    n, m, q, c = pca.runtime_comparison(100, 10)
    assert q.shape == c.shape == n.shape == (100, 100)
    assert np.isfinite(q).all() and (q > 0).all()
    svd = TruncatedSVD(n_components=2, algorithm="arpack").fit(data)
    assert svd.components_.shape == (2, data.shape[1])
    assert np.isfinite(svd.singular_values_).all()
    assert (np.diff(svd.singular_values_) <= 0).all()


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float16"])
def test_reduced_compute_dtype_matches_jax(compute_dtype):
    """Item 7: a reduced ``compute_dtype`` engages the partial-U Gram route
    with the full solver (both GEMMs on rounded operands, float32
    accumulation) and is recorded in ``effective_compute_dtype_``; the
    spectrum and components hold the JAX package's at rtol 1e-4 (the same
    rounded operands, sums in another order), and the reduced Gram moves
    the spectrum off the float32 one."""
    X, _ = synthetic_surrogate(1600, 16, 4, seed=2)
    kw = dict(n_components=4, svd_solver="full", ingest="monolithic",
              compute_dtype=compute_dtype)
    port = QPCA(**kw).fit(X)
    ref = JaxQPCA(**kw).fit(X)
    assert port.effective_compute_dtype_ == ref.effective_compute_dtype_ \
        == compute_dtype
    np.testing.assert_allclose(port.all_singular_values_,
                               ref.all_singular_values_, rtol=1e-4)
    _close(port.components_, ref.components_, 1e-4)
    f32 = QPCA(n_components=4, svd_solver="full").fit(X)
    assert not np.array_equal(port.singular_values_, f32.singular_values_)
    with pytest.warns(RuntimeWarning, match="partial-U"):
        short = QPCA(n_components=0.9, compute_dtype=compute_dtype).fit(X)
    assert short.effective_compute_dtype_ is None


def test_float32_compute_dtype_engages_the_partial_u_route():
    X, _ = synthetic_surrogate(800, 16, 4, seed=1)
    pca = QPCA(n_components=4, svd_solver="full",
               compute_dtype="float32").fit(X)
    assert pca.effective_compute_dtype_ == "float32"
    with pytest.warns(RuntimeWarning, match="partial-U"):
        QPCA(n_components=0.9, compute_dtype="float32").fit(X)


def test_facade_names():
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch.decomposition import PCA as fPCA
    from sq_learn_tpu_torch.decomposition import QPCA as fQPCA
    from sq_learn_tpu_torch.decomposition import qPCA

    assert fQPCA is qPCA is QPCA is sqt.QPCA
    assert fPCA is PCA is sqt.PCA


def test_retained_variance_and_theta_estimators_together(data):
    """tests/test_qpca.py's combined fit (θ search at p = 0.7, the top-3
    mass step of the 5 kept values, plus the Theorem-9 ratio sum)."""
    pca = QPCA(n_components=5, random_state=0).fit(
        data, estimate_all=True, theta_estimate=True,
        quantum_retained_variance=True, eps=0.1, eps_theta=0.1, eta=0.1,
        delta=0.1, p=0.7, true_tomography=False)
    S = pca.singular_values_
    mass = np.sum(S[S >= pca.est_theta] ** 2) / np.sum(S**2)
    assert abs(mass - 0.7) < 0.15
    # theta_major = 0: the ratio sum takes the estimated θ
    assert abs(pca.p - mass) < 0.15
    assert pca.topk == int(np.sum(pca.estimate_s_values >= pca.est_theta))


def test_fit_transform_forwards_quantum_kwargs():
    from sq_learn_tpu.datasets import make_blobs

    X, _ = make_blobs(n_samples=200, centers=3, n_features=16,
                      cluster_std=0.8, random_state=0)
    pca = QPCA(n_components=4, random_state=0)
    Xt = pca.fit_transform(
        X, estimate_all=True, theta_major=1e-9, eps=0.05, delta=0.05,
        true_tomography=False, classic_transform=False,
        use_classical_components=False)
    assert Xt.shape == (200, 4) and hasattr(pca, "estimate_right_sv")
    assert QPCA(n_components=4, random_state=0).fit_transform(X).shape == (
        200, 4)


def test_sv_ratios_per_side_and_the_mle_tie_guard(data):
    from sq_learn_tpu_torch.models.qpca import _assess_dimension, _sv_ratio

    pca = QPCA(random_state=0).fit(
        data, estimate_all=True, estimate_least_k=True, eps=0.05,
        delta=0.05, theta_major=1e-6, theta_minor=3.0,
        true_tomography=False, check_sv_uniform_distribution=True,
        use_computed_qcomponents=True, fs_ratio_estimation=True)
    assert pca.use_computed_qcomponents is True
    assert pca.sv_uniform_distribution_.shape == (pca.topk,)
    assert pca.least_k_sv_uniform_distribution_.shape == (pca.least_k,)
    assert np.all(np.abs(pca.sv_uniform_distribution_ - 1.0) < 0.5)
    out = _sv_ratio(np.array([1.0, 2.0]), np.array([0.0, 2.0]))
    assert np.isnan(out[0]) and out[1] == 1.0
    with pytest.raises(ValueError, match="tied eigenvalues"):
        _assess_dimension(np.array([5.0, 5.0, 2.0, 1.0, 0.5]), 2, 100)


def test_precision_is_the_inverse_covariance():
    X = np.random.default_rng(1).normal(size=(200, 8)).astype(np.float32)
    pca = QPCA(n_components=3, svd_solver="full").fit(X)
    prod = (pca.get_covariance() @ pca.get_precision()).numpy()
    np.testing.assert_allclose(prod, np.eye(8), atol=5e-3)


# -- the slice as a whole ------------------------------------------------------


def test_mnist_trial_fold_scores_equal_jax():
    """examples/mnist_trial.py at a small size, ε = δ = 0: qPCA with every
    top-k estimator, the quantum transform and a 10-fold stratified CV of
    7-NN give JAX's fold scores."""
    from sq_learn_tpu.model_selection import StratifiedKFold as JSKF
    from sq_learn_tpu.model_selection import cross_validate as jcv
    from sq_learn_tpu.models import KNeighborsClassifier as JKNN
    from sq_learn_tpu_torch.model_selection import (StratifiedKFold,
                                                    cross_validate)
    from sq_learn_tpu_torch.models import KNeighborsClassifier

    X, y = synthetic_surrogate(2000, 64, 10, seed=784)
    kw = dict(estimate_all=True, eps=0, delta=0, theta_major=1e-9,
              true_tomography=False)
    t = QPCA(n_components=16, svd_solver="full", random_state=0).fit(X, **kw)
    j = JaxQPCA(n_components=16, svd_solver="full", random_state=0).fit(
        X, **kw)
    assert t.topk == j.topk == 16
    Xq = t.transform(X, classic_transform=False,
                     use_classical_components=False)
    jXq = j.transform(X, classic_transform=False,
                      use_classical_components=False)
    _close(Xq, jXq)
    ts = cross_validate(KNeighborsClassifier(n_neighbors=7), Xq, y,
                        cv=StratifiedKFold(10))["test_score"]
    js = jcv(JKNN(n_neighbors=7), jXq, y, cv=JSKF(10))["test_score"]
    np.testing.assert_array_equal(ts, js)


def test_mnist_trial_at_the_papers_error_budget():
    """The same trial at ε + δ = 0.8: every σ̂ within the PE decoding bound,
    the Gaussian tomography's rows within δ, and the CV unharmed."""
    from sq_learn_tpu_torch.model_selection import (StratifiedKFold,
                                                    cross_validate)
    from sq_learn_tpu_torch.models import KNeighborsClassifier

    X, y = synthetic_surrogate(2000, 64, 10, seed=784)
    pca = QPCA(n_components=16, svd_solver="full", random_state=0).fit(
        X, estimate_all=True, eps=0.4, delta=0.4, theta_major=1e-9,
        true_tomography=False)
    assert pca.topk == 16 and pca.sketch_info_ is not None
    err = np.linalg.norm(pca.estimate_right_sv - pca.components_, axis=1)
    assert err.max() <= 0.4
    eps_scaled = 0.4 / pca.muA
    assert (np.abs(pca.estimate_s_values - pca.singular_values_)
            <= pca.muA * eps_scaled * (eps_scaled + np.pi)).all()
    Xq = pca.transform(X, classic_transform=False,
                       use_classical_components=False)
    scores = cross_validate(KNeighborsClassifier(n_neighbors=7), Xq, y,
                            cv=StratifiedKFold(10))["test_score"]
    assert scores.min() >= 0.95


def test_jax_spectrum_error_helper_at_a_small_shape():
    err = jax_spectrum_error(3000, 48, 12)
    assert 0 < err < 1e-3



def test_fit_mu_does_not_depend_on_earlier_fits():
    """The fit's sampled μ(A) is a function of its own data and seed: a
    fit with another seed, or of data changed in place, earlier in the
    process does not change it."""
    from sq_learn_tpu_torch.sketch import cache as tcache

    rng = np.random.default_rng(5)
    X = (rng.normal(size=(2000, 12)) * np.linspace(0.5, 3.0, 12)
         ).astype(np.float32)

    def info(seed, data):
        pca = QPCA(n_components=4, svd_solver="full", compute_mu=True,
                   sketch=256,
                   random_state=seed).fit(data)
        assert pca.sketch_info_["sketched"]
        return pca.sketch_info_, pca.muA

    tcache.clear()
    alone = info(1, X)
    tcache.clear()
    assert info(0, X) != alone  # the plug-in μ follows the row sample
    assert info(1, X) == alone
    changed = X.copy()
    changed[1] *= 10.0
    tcache.clear()
    fresh = info(1, changed)
    tcache.clear()
    info(1, X)
    X[1] *= 10.0
    assert info(1, X) == fresh

if __name__ == "__main__":
    # the JAX package's float32 error at the trial's shape (see the module
    # docstring), then its bfloat16 partial-U route's; run with
    # JAX_PLATFORMS=cpu
    print(jax_spectrum_error(70_000, 784, 61))
    print("bfloat16", jax_spectrum_error(70_000, 784, 61,
                                         compute_dtype="bfloat16"))
