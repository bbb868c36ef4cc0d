"""Fitted state carried from the JAX package into the port.

A JAX ``QKMeans`` is fitted and its attributes handed to
``convert.qkmeans_from_numpy``; the port's ``predict`` must give the same
labels and ``transform``/``score`` the same values at rtol 1e-4 (float32
products summed in another order).
"""

import numpy as np
import pytest

from sq_learn_tpu.datasets import make_blobs
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.convert import qkmeans_from_numpy


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def fitted():
    X, _ = make_blobs(n_samples=400, centers=5, n_features=12,
                      cluster_std=1.5, random_state=3)
    X = X.astype(np.float32)
    est = JaxQKMeans(n_clusters=5, n_init=2, delta=0.5,
                     true_distance_estimate=False, random_state=0).fit(X)
    Xq, _ = make_blobs(n_samples=150, centers=5, n_features=12,
                       cluster_std=3.0, random_state=4)
    return est, X, Xq.astype(np.float32)


def _port(est, device="cpu"):
    attrs = {k: v for k, v in vars(est).items() if k.endswith("_")}
    return qkmeans_from_numpy(attrs, device=device,
                              params=est.get_params())


def test_state_carries_over(fitted):
    est, _, _ = fitted
    port = _port(est)
    np.testing.assert_array_equal(port.cluster_centers_,
                                  est.cluster_centers_)
    np.testing.assert_array_equal(port.labels_, est.labels_)
    assert port.inertia_ == est.inertia_ and port.n_iter_ == est.n_iter_
    assert port.n_features_in_ == 12 and port.n_clusters == 5
    assert (port.eta_, port.mu_, port.norm_mu_, port.condition_number_) == (
        est.eta_, est.mu_, est.norm_mu_, est.condition_number_)
    np.testing.assert_array_equal(port.fit_history_["inertia"],
                                  est.fit_history_["inertia"])
    assert port.delta == 0.5 and port.true_distance_estimate is False
    assert port.device == "cpu"


@pytest.mark.parametrize("data", ["train", "queries"])
def test_inference_matches_jax(fitted, data):
    est, X, Xq = fitted
    Z = X if data == "train" else Xq
    port = _port(est)
    np.testing.assert_array_equal(port.predict(Z), est.predict(Z))
    np.testing.assert_allclose(port.transform(Z), est.transform(Z),
                               rtol=1e-4, atol=1e-4)
    w = np.random.default_rng(0).uniform(0.5, 2.0, len(Z))
    assert port.score(Z, sample_weight=w) == pytest.approx(
        est.score(Z, sample_weight=w), rel=1e-4)


def test_delta_predict_stays_in_the_window(fitted):
    est, X, _ = fitted
    port = _port(est)
    labels = port.predict(X, delta=2.0)
    d2 = ((X[:, None, :] - port.cluster_centers_[None]) ** 2).sum(-1)
    sel = d2[np.arange(len(X)), labels]
    assert (sel <= d2.min(1) + 2.0 + 1e-3).all()


def test_rejects_inconsistent_state(fitted):
    est, _, _ = fitted
    with pytest.raises(ValueError, match="cluster_centers_"):
        qkmeans_from_numpy({"labels_": est.labels_})
    with pytest.raises(ValueError, match="n_features_in_"):
        qkmeans_from_numpy({"cluster_centers_": est.cluster_centers_,
                            "n_features_in_": 3})


@pytest.fixture(scope="module")
def fitted_knn():
    from sq_learn_tpu.models.neighbors import KNeighborsClassifier as JaxKNN

    X, y = make_blobs(n_samples=400, centers=4, n_features=10,
                      cluster_std=3.0, random_state=6)
    X = X.astype(np.float32)
    est = JaxKNN(n_neighbors=6, weights="distance", use_pallas=True).fit(
        X[:300], y[:300] * 3 - 1)
    est._host_search = lambda X, k: None  # JAX's own device search
    return est, X[300:]


def _port_knn(est, device="cpu"):
    from sq_learn_tpu_torch.convert import kneighbors_from_numpy

    attrs = {k: np.asarray(v) for k, v in vars(est).items()
             if k.endswith("_")}
    return kneighbors_from_numpy(attrs, device=device,
                                 params=est.get_params())


def test_kneighbors_inference_matches_jax(fitted_knn):
    est, Xq = fitted_knn
    port = _port_knn(est)
    assert (port.n_neighbors, port.weights, port.device) == (6, "distance",
                                                             "cpu")
    np.testing.assert_array_equal(port.classes_, est.classes_)
    np.testing.assert_array_equal(port.predict(Xq), est.predict(Xq))
    np.testing.assert_allclose(port.predict_proba(Xq), est.predict_proba(Xq),
                               rtol=1e-5)
    dist_p, idx_p = port.kneighbors(Xq)
    dist_j, idx_j = est.kneighbors(Xq)
    np.testing.assert_array_equal(idx_p, idx_j)
    np.testing.assert_allclose(dist_p, dist_j, rtol=1e-4, atol=1e-4)


def test_kneighbors_rejects_inconsistent_state(fitted_knn):
    from sq_learn_tpu_torch.convert import kneighbors_from_numpy

    est, _ = fitted_knn
    attrs = {k: np.asarray(v) for k, v in vars(est).items()
             if k.endswith("_")}
    with pytest.raises(ValueError, match="y_fit_"):
        kneighbors_from_numpy({"X_fit_": attrs["X_fit_"],
                               "classes_": attrs["classes_"]})
    with pytest.raises(ValueError, match="do not match"):
        kneighbors_from_numpy({**attrs, "y_fit_": attrs["y_fit_"][:-1]})
    with pytest.raises(ValueError, match="index classes_"):
        kneighbors_from_numpy({**attrs, "classes_": attrs["classes_"][:2]})
    with pytest.raises(ValueError, match="n_features_in_"):
        kneighbors_from_numpy({**attrs, "n_features_in_": 3})


@pytest.fixture(scope="module")
def fitted_qpca():
    from sq_learn_tpu.models import QPCA as JaxQPCA
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, _ = synthetic_surrogate(1200, 24, 6, seed=9)
    est = JaxQPCA(n_components=7, svd_solver="full", random_state=0).fit(
        X, estimate_all=True, eps=0.01, delta=0.05, theta_major=1e-6,
        true_tomography=False)
    Xq, _ = synthetic_surrogate(300, 24, 6, seed=10)
    return est, X, Xq


def _port_qpca(est, device="cpu"):
    from sq_learn_tpu_torch.convert import qpca_from_numpy

    return qpca_from_numpy(vars(est), device=device, params=est.get_params())


def test_qpca_state_carries_over(fitted_qpca):
    est, _, _ = fitted_qpca
    port = _port_qpca(est)
    for name in ("mean_", "components_", "all_components",
                 "explained_variance_", "singular_values_", "left_sv",
                 "estimate_right_sv", "estimate_left_sv",
                 "estimate_s_values", "estimate_fs"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(est, name)))
    assert (port.n_components_, port.noise_variance_, port.muA,
            port.norm_muA) == (est.n_components_, est.noise_variance_,
                               est.muA, est.norm_muA)
    assert port.n_components == 7 and port.device == "cpu"
    assert port.n_features_in_ == 24


@pytest.mark.parametrize("data", ["train", "queries"])
@pytest.mark.parametrize("quantum", [False, True])
def test_qpca_transforms_match_jax(fitted_qpca, data, quantum):
    """The classical transform, and the quantum one on the tomography
    estimates (``use_classical_components=False``), of a JAX-fitted state,
    at rtol 1e-4 (float32 products summed in another order)."""
    est, X, Xq = fitted_qpca
    Z = X if data == "train" else Xq
    port = _port_qpca(est)
    kw = (dict(classic_transform=False, use_classical_components=False)
          if quantum else {})
    out = port.transform(Z, **kw).numpy()
    ref = np.asarray(est.transform(Z, **kw))
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    back = port.inverse_transform(
        out, use_classical_components=not quantum).numpy()
    ref_back = np.asarray(est.inverse_transform(
        ref, use_classical_components=not quantum))
    np.testing.assert_allclose(back, ref_back, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_back).max())


def test_qpca_rejects_inconsistent_state(fitted_qpca):
    from sq_learn_tpu_torch.convert import qpca_from_numpy

    est, _, _ = fitted_qpca
    attrs = dict(vars(est))
    with pytest.raises(ValueError, match="components_"):
        qpca_from_numpy({"mean_": attrs["mean_"]})
    with pytest.raises(ValueError, match="do not match"):
        qpca_from_numpy({**attrs, "mean_": attrs["mean_"][:-1]})
    with pytest.raises(ValueError, match="n_components_"):
        qpca_from_numpy({**attrs, "n_components_": 3})
    with pytest.raises(ValueError, match="estimate_right_sv"):
        qpca_from_numpy({**attrs, "estimate_right_sv":
                         attrs["estimate_right_sv"][:, :5]})
