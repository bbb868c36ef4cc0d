"""The port's k-NN classifier and ``knn_indices`` against the JAX package.

The JAX classifier runs its fused Pallas search (``use_pallas=True``, in
interpret mode on the CPU) with the host fast path defeated, as
``tests/test_pallas.py``'s ``test_classifier_end_to_end`` runs it; the
port runs on CPU tensors. Tolerances: predictions and neighbor indices
equal; ``predict_proba`` at rtol 1e-5 (distance weights from float32
distances summed in another order); distances at rtol 1e-4.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sq_learn_tpu.datasets import make_blobs
from sq_learn_tpu.models.neighbors import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.models.neighbors import knn_indices as jax_knn_indices
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.models import KNeighborsClassifier, knn_indices
from sq_learn_tpu_torch.ops.kernels import argkmin


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    X, y = make_blobs(n_samples=400, centers=3, n_features=12,
                      cluster_std=2.0, random_state=9)
    X = X.astype(np.float32)
    return X[:300], y[:300], X[300:]


def _jax_fit(Xtr, ytr, **kw):
    est = JaxKNN(use_pallas=True, **kw).fit(Xtr, ytr)
    est._host_search = lambda X, k: None
    return est


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_classifier_matches_jax(blobs, weights):
    Xtr, ytr, Xte = blobs
    ref = _jax_fit(Xtr, ytr, n_neighbors=7, weights=weights)
    port = KNeighborsClassifier(n_neighbors=7, weights=weights).fit(Xtr, ytr)
    np.testing.assert_array_equal(port.predict(Xte), ref.predict(Xte))
    np.testing.assert_allclose(port.predict_proba(Xte),
                               ref.predict_proba(Xte), rtol=1e-5)
    dist_p, idx_p = port.kneighbors(Xte)
    dist_j, idx_j = ref.kneighbors(Xte)
    np.testing.assert_array_equal(idx_p, idx_j)
    np.testing.assert_allclose(dist_p, dist_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        port.kneighbors(Xte, n_neighbors=3, return_distance=False),
        ref.kneighbors(Xte, n_neighbors=3, return_distance=False))
    assert port.score(Xte, ref.predict(Xte)) == 1.0


def test_fit_state(blobs):
    Xtr, ytr, _ = blobs
    port = KNeighborsClassifier().fit(Xtr, ytr + 10)
    assert isinstance(port.X_fit_, torch.Tensor)
    assert port.X_fit_.dtype == torch.float32
    np.testing.assert_array_equal(port.classes_, [10, 11, 12])
    np.testing.assert_array_equal(port.y_fit_, ytr)
    assert port.y_fit_.dtype == np.int32
    assert (port.n_samples_fit_, port.n_features_in_) == (300, 12)
    torch.testing.assert_close(port._x_sq_fit,
                               torch.sum(port.X_fit_ ** 2, dim=1))
    assert port._estimator_type == "classifier"


def test_exact_search_goes_through_argkmin(blobs, monkeypatch):
    """compute_dtype None (and its float32 spelling) searches through the
    kernel's wrapper with the norms kept at fit."""
    Xtr, ytr, Xte = blobs
    calls = []

    def spy(T, xsq, Q, k):
        calls.append((T, xsq, k))
        return argkmin(T, xsq, Q, k)

    from sq_learn_tpu_torch.models import neighbors

    monkeypatch.setattr(neighbors, "argkmin", spy)
    for cdt in (None, "float32"):
        port = KNeighborsClassifier(n_neighbors=4,
                                    compute_dtype=cdt).fit(Xtr, ytr)
        port.predict(Xte)
    assert len(calls) == 2 and all(c[2] == 4 for c in calls)
    assert calls[0][0] is not calls[1][0]


@pytest.mark.parametrize("k", [1, 5, 13])
def test_knn_indices_exact_matches_jax(k):
    rng = np.random.RandomState(3)
    Xt = rng.randn(1000, 17).astype(np.float32)
    Xq = rng.randn(300, 17).astype(np.float32)
    Xt[500] = Xt[0]  # a tie: the lower index first on both sides
    Xq[0] = Xt[0]
    ji, jd = jax_knn_indices(jnp.asarray(Xt), jnp.asarray(Xq), k)
    ti, td = knn_indices(torch.from_numpy(Xt), torch.from_numpy(Xq), k,
                         block=64)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    if k > 1:
        assert ti[0, :2].tolist() == [0, 500]


def _near_duplicates():
    """ROADMAP §3's smallest input: two training rows a few float32 ulps
    from the query, whose exact distances differ far below float32
    resolution of the scores."""
    q = np.array([[100, 100]], np.float32)
    T = np.array([[100 - 2**-15, 100 - 2**-16],
                  [100 + 3 * 2**-16, 100 - 2**-16]], np.float32)
    return T, q, 1


def _near_duplicate_clusters():
    """200 queries, each at the center of a cluster of 1 to 6 training rows
    a few ulps away (offsets in multiples of 2**-16 at magnitude ~100), far
    from every other cluster, shuffled: k=8 reaches into the nearer
    clusters, and the rows of a cluster of one stand alone."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-100, 100, (200, 8)).astype(np.float32)
    sizes = rng.integers(1, 7, 200)
    T = np.concatenate([
        c + rng.integers(-4, 5, (n, 8)) * 2.0**-16
        for c, n in zip(centers, sizes)]).astype(np.float32)
    return T[rng.permutation(len(T))], centers, 8


@pytest.mark.parametrize("case", [_near_duplicates, _near_duplicate_clusters])
def test_knn_indices_near_duplicates_agree_with_jax_up_to_the_margin(case):
    """Where exact distances differ below float32 resolution, the port
    (which ranks ‖t‖²−2·q·t, as the Pallas search does) and JAX's XLA
    route (which ranks the clamped full distance) order near-duplicate
    rows by rounding noise. The lists must agree wherever the exact
    float64 gap to the neighbouring positions exceeds the margin, and
    every position where they differ must hold rows whose exact distances
    lie within the margin of each other: 3× the larger measured float32
    distance error of the two sides, the rule ``chip_smoke.py`` holds the
    kernel to on the card."""
    Xt, Xq, k = case()
    ji, jd = (np.asarray(a) for a in jax_knn_indices(
        jnp.asarray(Xt), jnp.asarray(Xq), k))
    ti, td = (a.numpy() for a in knn_indices(
        torch.from_numpy(Xt), torch.from_numpy(Xq), k))
    exact = ((Xq.astype(np.float64)[:, None, :]
              - Xt.astype(np.float64)[None]) ** 2).sum(-1)
    ej = np.take_along_axis(exact, ji.astype(np.int64), 1)
    et = np.take_along_axis(exact, ti.astype(np.int64), 1)
    margin = 3.0 * max(np.abs(jd - ej).max(), np.abs(td - et).max())
    differ = ti != ji
    assert (np.abs(et - ej)[differ] <= margin).all()
    # positions whose exact distance stands more than the margin from its
    # neighbours' (and, at the k-th, from the (k+1)-th nearest)
    order = np.argsort(exact, axis=1, kind="stable")
    near = np.take_along_axis(exact, order, 1)[:, :k + 1]
    gaps = np.diff(near, axis=1)
    left = np.concatenate([np.full((len(Xq), 1), np.inf), gaps[:, :k - 1]],
                          axis=1)
    alone = (left > margin) & (gaps[:, :k] > margin)
    np.testing.assert_array_equal(ti[alone], order[:, :k][alone])
    np.testing.assert_array_equal(ji[alone], order[:, :k][alone])
    if case is _near_duplicate_clusters:
        # the data exercise both halves of the rule: the two sides break
        # near-ties apart, and many positions stand alone
        assert differ.any() and alone.sum() > 100


@pytest.mark.parametrize("k", [1, 7])
def test_knn_indices_bfloat16_matches_jax(k):
    """Shortlist in bfloat16, refine exactly: the same neighbors and the
    exact (difference-form) distances."""
    rng = np.random.RandomState(4)
    Xt = rng.randn(800, 24).astype(np.float32)
    Xq = rng.randn(120, 24).astype(np.float32)
    ji, jd = jax_knn_indices(jnp.asarray(Xt), jnp.asarray(Xq), k,
                             compute_dtype="bfloat16")
    ti, td = knn_indices(torch.from_numpy(Xt), torch.from_numpy(Xq), k,
                         compute_dtype="bfloat16")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    exact = ((Xq[:, None, :] - Xt[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ti.numpy(), np.argsort(
        exact, axis=1, kind="stable")[:, :k])


def test_knn_indices_drops_a_shortlist_as_large_as_the_train_set():
    rng = np.random.RandomState(5)
    Xt = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    Xq = torch.from_numpy(rng.randn(9, 6).astype(np.float32))
    for a, b in zip(knn_indices(Xt, Xq, 7, compute_dtype="bfloat16"),
                    knn_indices(Xt, Xq, 7)):
        assert torch.equal(a, b)


def test_classifier_bfloat16_matches_jax(blobs):
    Xtr, ytr, Xte = blobs
    ref = JaxKNN(n_neighbors=5, compute_dtype="bfloat16").fit(Xtr, ytr)
    port = KNeighborsClassifier(n_neighbors=5,
                                compute_dtype="bfloat16").fit(Xtr, ytr)
    np.testing.assert_array_equal(port.kneighbors(Xte)[1],
                                  ref.kneighbors(Xte)[1])
    np.testing.assert_array_equal(port.predict(Xte), ref.predict(Xte))


@pytest.mark.parametrize("k,match", [
    (0, "positive integer"), (-2, "positive integer"),
    (2.5, "positive integer"), (301, "n_samples_fit = 300"),
])
def test_check_k_errors_match_jax(blobs, k, match):
    Xtr, ytr, Xte = blobs
    port = KNeighborsClassifier().fit(Xtr, ytr)
    ref = JaxKNN().fit(Xtr, ytr)
    for est in (port, ref):
        with pytest.raises(ValueError, match=match):
            est.kneighbors(Xte, n_neighbors=k)
    for est in (KNeighborsClassifier(n_neighbors=k).fit(Xtr, ytr),
                JaxKNN(n_neighbors=k).fit(Xtr, ytr)):
        with pytest.raises(ValueError, match=match):
            est.predict(Xte)


def test_not_ported_modes_raise(blobs):
    """``mesh`` raises naming its item. float64 data was ported since
    (item 7): a float64 fit searches in plain float64 ops, off the kernel,
    ranking by max(‖q‖²+‖t‖²−2·q·t, 0) with ties to the lowest index, as
    the JAX package's XLA search does."""
    Xtr, ytr, Xte = blobs
    with pytest.raises(NotImplementedError, match="item 6"):
        KNeighborsClassifier(mesh=object()).fit(Xtr, ytr)
    with config_context(default_dtype="float64"):
        wide = KNeighborsClassifier(n_neighbors=5).fit(Xtr, ytr)
        assert wide.X_fit_.dtype == torch.float64
        dist, idx = wide.kneighbors(Xte)
        assert wide._search_impl(torch.from_numpy(
            Xte.astype(np.float64)), 5)[1] == "plain"
    Q, T = Xte.astype(np.float64), Xtr.astype(np.float64)
    d = np.maximum((Q * Q).sum(1)[:, None] + (T * T).sum(1)[None]
                   - 2.0 * Q @ T.T, 0.0)
    ref = np.argsort(d, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_allclose(dist, np.sqrt(np.take_along_axis(d, ref, 1)),
                               rtol=1e-12, atol=1e-12)
    narrow = KNeighborsClassifier(n_neighbors=5).fit(Xtr, ytr)
    np.testing.assert_array_equal(wide.predict(Xte), narrow.predict(Xte))


def test_input_errors(blobs):
    Xtr, ytr, Xte = blobs
    with pytest.raises(ValueError, match="inconsistent numbers"):
        KNeighborsClassifier().fit(Xtr, ytr[:-1])
    with pytest.raises(ValueError, match="compute_dtype"):
        KNeighborsClassifier(compute_dtype="int8").fit(Xtr, ytr)
    port = KNeighborsClassifier().fit(Xtr, ytr)
    with pytest.raises(ValueError, match="features"):
        port.predict(Xte[:, :5])
    from sq_learn_tpu_torch import NotFittedError

    with pytest.raises(NotFittedError):
        KNeighborsClassifier().predict(Xte)


def test_cuda_request_without_cuda_raises(blobs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    Xtr, ytr, _ = blobs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KNeighborsClassifier(device="cuda").fit(Xtr, ytr)


def test_facade_names():
    from sq_learn_tpu_torch import KNeighborsClassifier as top
    from sq_learn_tpu_torch.neighbors import (KNeighborsClassifier as facade,
                                              knn_indices as facade_knn)

    assert top is facade is KNeighborsClassifier
    assert facade_knn is knn_indices
