"""The port's splitters, cross-validation and scores against the JAX
package's.

Splitters are index bookkeeping: the same indices, fold for fold. The
scores equal JAX's: label metrics exactly where both count in integers,
at rtol 1e-5 where JAX computes in float32 and the port in float64, and
at rtol 1e-4 for the metrics over float32 data (sums in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import sq_learn_tpu.metrics as jm
import sq_learn_tpu.model_selection as jms
import sq_learn_tpu_torch.metrics as tm
import sq_learn_tpu_torch.model_selection as tms
from sq_learn_tpu.models.neighbors import KNeighborsClassifier as JaxKNN
from sq_learn_tpu_torch import config_context, get_config
from sq_learn_tpu_torch.datasets import synthetic_surrogate
from sq_learn_tpu_torch.models import KNeighborsClassifier
from sq_learn_tpu_torch.utils import check_random_state


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _labels(n=97, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, classes, n)


def _same_folds(port_folds, jax_folds):
    port_folds, jax_folds = list(port_folds), list(jax_folds)
    assert len(port_folds) == len(jax_folds)
    for (tr_p, te_p), (tr_j, te_j) in zip(port_folds, jax_folds):
        np.testing.assert_array_equal(tr_p, tr_j)
        np.testing.assert_array_equal(te_p, te_j)


@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 3)])
def test_kfold_matches_jax(shuffle, seed):
    X = np.zeros((23, 2))
    _same_folds(tms.KFold(4, shuffle=shuffle, random_state=seed).split(X),
                jms.KFold(4, shuffle=shuffle, random_state=seed).split(X))


@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 5)])
def test_stratified_kfold_matches_jax(shuffle, seed):
    y = np.array([7, 3, 3, 9, 7, 7, 3, 9, 9, 9, 3, 7, 7, 3, 9] * 7)
    X = np.zeros((len(y), 2))
    _same_folds(
        tms.StratifiedKFold(10, shuffle=shuffle,
                            random_state=seed).split(X, y),
        jms.StratifiedKFold(10, shuffle=shuffle,
                            random_state=seed).split(X, y))


def test_stratified_kfold_errors_match_jax():
    y = np.array([0, 0, 1, 1, 1])
    for mod in (tms, jms):
        with pytest.raises(ValueError, match="n_splits=4 exceeds"):
            list(mod.StratifiedKFold(4).split(np.zeros(5), y))
        with pytest.warns(UserWarning, match="least populated"):
            list(mod.StratifiedKFold(3).split(np.zeros(5), y))
    with pytest.raises(ValueError, match="n_splits"):
        tms.KFold(1)
    assert tms.KFold(3).get_n_splits() == 3


@pytest.mark.parametrize("kw", [
    {"random_state": 0},
    {"test_size": 0.3, "random_state": 1},
    {"test_size": 11, "random_state": 2},
    {"train_size": 0.6, "random_state": 3},
    {"shuffle": False, "test_size": 0.2},
    {"stratify": "y", "test_size": 0.25, "random_state": 4},
])
def test_train_test_split_matches_jax(kw):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(61, 3)).astype(np.float32)
    y = _labels(61, 3, seed=1)
    kw = {k: (y if v == "y" else v) for k, v in kw.items()}
    port = tms.train_test_split(X, y, **kw)
    ref = jms.train_test_split(X, y, **kw)
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    # a tensor is indexed where it lies, to the same rows
    Xt, Xe = tms.train_test_split(torch.from_numpy(X), **{
        k: v for k, v in kw.items() if k != "stratify"})
    Xt_ref, Xe_ref = jms.train_test_split(X, **{
        k: v for k, v in kw.items() if k != "stratify"})
    np.testing.assert_array_equal(Xt.numpy(), Xt_ref)
    np.testing.assert_array_equal(Xe.numpy(), Xe_ref)


def test_check_random_state_matches_jax():
    from sq_learn_tpu.utils import check_random_state as jax_crs

    np.testing.assert_array_equal(check_random_state(7).permutation(20),
                                  jax_crs(7).permutation(20))
    rs = np.random.RandomState(1)
    assert check_random_state(rs) is rs
    assert check_random_state(None) is np.random.mtrand._rand
    with pytest.raises(ValueError, match="cannot be used"):
        check_random_state("seed")


@pytest.fixture(scope="module")
def surrogate():
    X, y = synthetic_surrogate(600, 20, 4, seed=3, cluster_std=60.0)
    return X, y


@pytest.mark.parametrize("n_jobs", [None, 3])
def test_cross_validate_matches_jax(surrogate, n_jobs):
    X, y = surrogate
    port = tms.cross_validate(KNeighborsClassifier(n_neighbors=7), X, y,
                              cv=tms.StratifiedKFold(10), n_jobs=n_jobs)
    ref = jms.cross_validate(JaxKNN(n_neighbors=7), X, y,
                             cv=jms.StratifiedKFold(10))
    assert set(port) == {"fit_time", "score_time", "test_score"}
    np.testing.assert_allclose(port["test_score"], ref["test_score"],
                               rtol=1e-6)
    assert port["test_score"].min() < 1.0  # the classes overlap a little
    assert (port["fit_time"] >= 0).all() and (port["score_time"] >= 0).all()


def test_cross_validate_int_cv_stratifies_and_scores(surrogate):
    X, y = surrogate
    port = tms.cross_validate(KNeighborsClassifier(n_neighbors=3), X, y,
                              cv=5, return_train_score=True,
                              scoring="accuracy")
    ref = jms.cross_validate(JaxKNN(n_neighbors=3), X, y, cv=5,
                             return_train_score=True, scoring="accuracy")
    for key in ("test_score", "train_score"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6)
    np.testing.assert_allclose(
        tms.cross_val_score(KNeighborsClassifier(n_neighbors=3), X, y,
                            cv=5, scoring=lambda e, Xs, ys: e.score(Xs, ys)),
        ref["test_score"], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scoring"):
        tms.cross_val_score(KNeighborsClassifier(), X, y, scoring="nope")
    with pytest.raises(ValueError, match="n_jobs == 0"):
        tms.cross_val_score(KNeighborsClassifier(), X, y, n_jobs=0)


def test_worker_threads_run_under_the_callers_config(surrogate):
    """The folds of a thread pool compute where the caller asked: the
    global default device is 'cuda', which would raise here."""
    X, y = surrogate
    seen = []

    class Probe(KNeighborsClassifier):
        def fit(self, X, y):
            seen.append(get_config()["device"])
            return super().fit(X, y)

    tms.cross_val_score(Probe(), X, y, cv=4, n_jobs=4)
    assert seen == ["cpu"] * 4


def test_classifier_scores():
    y_true = np.array([0, 1, 2, 2, 1, 0, 1, 1, 2, 0, 2])
    y_pred = np.array([0, 2, 2, 2, 1, 0, 0, 1, 2, 1, 2])
    assert tm.accuracy_score(y_true, y_pred) == pytest.approx(
        float(jm.accuracy_score(y_true, y_pred)), rel=1e-7)
    assert tm.accuracy_score(torch.from_numpy(y_true),
                             y_pred) == tm.accuracy_score(y_true, y_pred)
    np.testing.assert_array_equal(tm.confusion_matrix(y_true, y_pred),
                                  jm.confusion_matrix(y_true, y_pred))
    for average in ("macro", "micro", "weighted"):
        assert tm.f1_score(y_true, y_pred, average=average) == \
            jm.f1_score(y_true, y_pred, average=average)
    assert tm.f1_score(y_true, y_pred, pos_label=2) == \
        jm.f1_score(y_true, y_pred, pos_label=2)
    for fn in (tm.f1_score, jm.f1_score):
        with pytest.raises(ValueError, match="pos_label"):
            fn(y_true, y_pred, pos_label=9)
        with pytest.raises(ValueError, match="unknown average"):
            fn(y_true, y_pred, average="samples")


@pytest.mark.parametrize("seed", [0, 1])
def test_clustering_scores(seed):
    a = _labels(300, 5, seed)
    b = np.where(_labels(300, 2, seed + 10) == 0, a, _labels(300, 6, seed + 20))
    assert tm.adjusted_rand_score(a, b) == pytest.approx(
        float(jm.adjusted_rand_score(a, b)), rel=1e-5)
    assert tm.adjusted_rand_score(a, a) == 1.0
    assert tm.normalized_mutual_info_score(a, b) == \
        jm.normalized_mutual_info_score(a, b)


def test_scores_over_data():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(120, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 120)
    C = rng.normal(size=(3, 6)).astype(np.float32)
    X += 2.0 * C[labels]  # some cluster structure: silhouette well above 0
    assert tm.inertia(X, C, labels) == pytest.approx(
        float(jm.inertia(X, C, labels)), rel=1e-4)
    assert tm.inertia(torch.from_numpy(X), C, labels) == pytest.approx(
        tm.inertia(X, C, labels), rel=1e-6)
    sv = np.array([5.0, 3.0, 1.5, 0.2], np.float32)
    np.testing.assert_allclose(tm.explained_variance_ratio(sv, 50),
                               np.asarray(jm.explained_variance_ratio(sv, 50)),
                               rtol=1e-5)
    out = tm.explained_variance_ratio(torch.from_numpy(sv), 50, 40.0)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jm.explained_variance_ratio(sv, 50, 40.0)),
        rtol=1e-5)
    for kw in ({}, {"sample_size": 60, "random_state": 4}):
        assert tm.silhouette_score(X, labels, **kw) == pytest.approx(
            jm.silhouette_score(X, labels, **kw), rel=1e-4, abs=1e-6)
    with pytest.raises(ValueError, match="silhouette"):
        tm.silhouette_score(X, np.zeros(120, int))


def test_scores_over_array_data_run_on_the_configured_device():
    """Array input goes to the configured device, as the estimators' does:
    a CUDA request computes there, or raises without CUDA; a tensor stays
    where it is."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 5)).astype(np.float32)
    C = rng.normal(size=(2, 5)).astype(np.float32)
    labels = rng.integers(0, 2, 40)
    sv = np.array([4.0, 2.0, 0.5], np.float32)
    calls = (lambda: tm.inertia(X, C, labels),
             lambda: tm.explained_variance_ratio(sv, 30),
             lambda: tm.silhouette_score(X, labels))
    on_cpu = [call() for call in calls]
    with config_context(device="cuda"):
        if torch.cuda.is_available():
            for call, want in zip(calls, on_cpu):
                np.testing.assert_allclose(call(), want, rtol=1e-4)
        else:
            for call in calls:
                with pytest.raises(RuntimeError, match="CUDA is not available"):
                    call()
        assert tm.inertia(torch.from_numpy(X), C, labels) == pytest.approx(
            on_cpu[0], rel=1e-6)


def test_knn_slice_as_a_whole():
    """The slice end to end at 3 000 × 64: fit, predict, kneighbors and a
    10-fold stratified CV of k-NN (k=7) on both sides."""
    X, y = synthetic_surrogate(3000, 64, 10, seed=784, cluster_std=60.0)
    Xtr, ytr, Xte, yte = X[:2400], y[:2400], X[2400:], y[2400:]
    port = KNeighborsClassifier(n_neighbors=7).fit(Xtr, ytr)
    ref = JaxKNN(n_neighbors=7, use_pallas=True).fit(Xtr, ytr)
    ref._host_search = lambda X, k: None
    np.testing.assert_array_equal(port.kneighbors(Xte)[1],
                                  ref.kneighbors(Xte)[1])
    pred = port.predict(Xte)
    np.testing.assert_array_equal(pred, ref.predict(Xte))
    acc = port.score(Xte, yte)
    assert acc == pytest.approx(float(ref.score(Xte, yte)), rel=1e-7)
    assert 0.5 < acc < 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_cv = tms.cross_validate(KNeighborsClassifier(n_neighbors=7),
                                     X, y, cv=tms.StratifiedKFold(10))
    ref_cv = jms.cross_validate(JaxKNN(n_neighbors=7), X, y,
                                cv=jms.StratifiedKFold(10))
    np.testing.assert_allclose(port_cv["test_score"], ref_cv["test_score"],
                               rtol=1e-6)


def test_ari_of_a_single_sample_is_one():
    """The reference (sklearn's ``adjusted_rand_score``) returns 1.0 when
    there is nothing to split; the JAX package divides 0 by 0 there and
    returns nan. The port follows the reference."""
    assert tm.adjusted_rand_score([1], [2]) == 1.0
    assert tm.adjusted_rand_score([0, 0], [0, 1]) == 0.0


@pytest.mark.parametrize("n", [46_341, 46_342, 50_000])
def test_ari_past_int32_pair_counts_follows_sklearn(n):
    """From n = 46 342 samples n·(n − 1) passes 2³¹: the JAX package
    multiplies the pair counts in int32 and its ARI is off (0.6735 against
    sklearn's 0.0204 at 46 342, below). The port counts in float64 and
    gives sklearn's value at every n."""
    from sklearn.metrics import adjusted_rand_score as sk_ari

    t = np.arange(n) % 2
    p = (np.arange(n) // 7) % 2
    assert tm.adjusted_rand_score(t, p) == pytest.approx(sk_ari(t, p),
                                                         rel=1e-9)
    jax_value = float(jm.adjusted_rand_score(t, p))
    if n == 46_341:
        assert jax_value == pytest.approx(sk_ari(t, p), rel=1e-5)
    elif n == 46_342:
        assert abs(jax_value - sk_ari(t, p)) > 0.5
