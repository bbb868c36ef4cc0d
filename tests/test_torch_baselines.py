"""BASELINE #4 and #5 and the error-budget grid search, through the port
and the JAX package at a small size.

- The δ-sweep of ``examples/delta_tradeoff.py`` (``load_cicids``, then
  ``StandardScaler``, then δ-means q-means): from one explicit init the
  δ=0 fit gives the JAX package's labels and ``n_iter``, and each δ > 0
  an ARI within 0.03 of the JAX package's (both scored by sklearn's ARI:
  the JAX package's own ``adjusted_rand_score`` multiplies pair counts in
  int32 and is off past 46 341 samples, ROADMAP.md §3).
- ``TruncatedSVD`` on a covertype-shaped surrogate: both algorithms give
  the JAX package's singular values at rtol 1e-4.
- ``GridSearchCV(Pipeline(StandardScaler, QPCA, KNeighborsClassifier))``
  over (n_components, n_neighbors) on an MNIST-shaped surrogate: the JAX
  package's ``cv_results_`` and ``best_params_``.

Run as a script from the repository root (``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_baselines.py``, ~6 min, ~2 GB)
it measures at full size the JAX package's numbers that ``chip_smoke.py``
holds the card to: the δ-sweep's ARI (scored by sklearn's ARI, and at
random_state 0 by the JAX package's own too) over random_state 0–9 for
both packages, and the largest relative error of
``TruncatedSVD(n_components=10, random_state=0)``'s float32
``singular_values_`` against a float64 SVD of the same float32 data, for
'randomized' and 'arpack'. It first prints the JAX package's ARI beside
sklearn's at 46 341 and 46 342 samples.
"""

import warnings

import numpy as np
import pytest
from sklearn.metrics import adjusted_rand_score as sk_ari

from sq_learn_tpu.datasets import load_cicids as jax_load_cicids
from sq_learn_tpu.datasets import synthetic_surrogate
from sq_learn_tpu.metrics import adjusted_rand_score as jax_ari
from sq_learn_tpu.model_selection import GridSearchCV as JaxGridSearchCV
from sq_learn_tpu.model_selection import StratifiedKFold as JaxSKF
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu.pipeline import Pipeline as JaxPipeline
from sq_learn_tpu.preprocessing import StandardScaler as JaxScaler
import sq_learn_tpu_torch as sqt
from sq_learn_tpu_torch.datasets import load_cicids
from sq_learn_tpu_torch.model_selection import GridSearchCV, StratifiedKFold
from sq_learn_tpu_torch.preprocessing import StandardScaler

DELTAS = (0.0, 0.1, 0.3, 0.5, 1.0)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.config_context(device="cpu"):
        yield


def _sweep_data(n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X, y, real = load_cicids(n_samples=n)
    assert real is False
    return StandardScaler().fit_transform(X), y


@pytest.fixture(scope="module")
def sweep():
    with sqt.config_context(device="cpu"):
        Xs, y = _sweep_data(4000)
    means = np.stack([Xs[y == c].mean(0).numpy() for c in range(6)])
    # a poor start for δ=0, so that the Lloyd loop runs: every other
    # center from its class's first row
    poor = means.copy()
    poor[::2] = Xs.numpy()[[np.flatnonzero(y == c)[0] for c in (0, 2, 4)]]
    return Xs, y, {"poor": poor, "means": means}


@pytest.mark.parametrize("delta", DELTAS)
def test_delta_sweep_matches_jax_from_one_init(sweep, delta):
    """δ=0 from a poor init is deterministic. With δ > 0 the two streams
    differ, so the fits start from the class means, where the δ-window
    noise, not the path, sets the ARI."""
    Xs, y, inits = sweep
    kw = dict(n_clusters=6, init=inits["poor" if delta == 0 else "means"],
              n_init=1, delta=delta, true_distance_estimate=False,
              random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = sqt.QKMeans(**kw).fit(Xs)
        ref = JaxQKMeans(**kw).fit(Xs.numpy())
    if delta == 0:
        np.testing.assert_array_equal(port.labels_, ref.labels_)
        assert port.n_iter_ == ref.n_iter_ and port.n_iter_ > 1
        assert sk_ari(y, port.labels_) == 1.0
        np.testing.assert_allclose(port.cluster_centers_,
                                   ref.cluster_centers_, rtol=1e-4,
                                   atol=1e-5)
    else:
        assert abs(sk_ari(y, port.labels_) - sk_ari(y, ref.labels_)) <= 0.03
    assert port.inertia_ == pytest.approx(ref.inertia_, rel=2e-3)


@pytest.mark.parametrize("algorithm", ["randomized", "arpack"])
def test_truncated_svd_on_a_covertype_shaped_surrogate(algorithm):
    X, _ = synthetic_surrogate(20_000, 54, 7, seed=54)
    ours = sqt.TruncatedSVD(n_components=10, algorithm=algorithm, n_iter=5,
                            random_state=0)
    Xt = ours.fit_transform(X)
    ref = JaxTruncatedSVD(n_components=10, algorithm=algorithm, n_iter=5,
                          random_state=0).fit(X)
    np.testing.assert_allclose(ours.singular_values_, ref.singular_values_,
                               rtol=1e-4)
    np.testing.assert_allclose(ours.explained_variance_ratio_,
                               ref.explained_variance_ratio_, rtol=1e-4)
    comps = ours.components_
    np.testing.assert_allclose(comps @ comps.T, np.eye(10), atol=1e-4)
    assert Xt.shape == (20_000, 10)


def test_error_budget_grid_search_matches_jax():
    X, y = synthetic_surrogate(1500, 784, 10, seed=784)
    grid = {"pca__n_components": [10, 16], "knn__n_neighbors": [5, 7]}
    port = sqt.Pipeline([
        ("scale", StandardScaler()),
        ("pca", sqt.QPCA(svd_solver="full", random_state=0)),
        ("knn", sqt.KNeighborsClassifier())])
    ref = JaxPipeline([("scale", JaxScaler()),
                       ("pca", JaxQPCA(svd_solver="full", random_state=0)),
                       ("knn", JaxKNN())])
    gs = GridSearchCV(port, grid, cv=StratifiedKFold(5)).fit(X, y)
    gj = JaxGridSearchCV(ref, grid, cv=JaxSKF(5)).fit(X, y)
    assert gs.cv_results_["params"] == gj.cv_results_["params"]
    np.testing.assert_allclose(gs.cv_results_["split_test_scores"],
                               gj.cv_results_["split_test_scores"],
                               atol=1e-6)
    assert gs.best_params_ == gj.best_params_
    assert gs.best_score_ == pytest.approx(gj.best_score_, abs=1e-6)
    assert gs.cv_results_["split_test_scores"].min() >= 0.95


def _measure_sweep(seeds=range(10)):
    """The full-size δ-sweep's ARI (sklearn's) by δ, for each package and
    random_state."""
    with sqt.config_context(device="cpu"):
        Xs, y = _sweep_data(50_000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Xj, yj, _ = jax_load_cicids(n_samples=50_000)
    Xj = JaxScaler().fit_transform(Xj)
    out = {"jax": {}, "port": {}}
    for seed in seeds:
        for d in DELTAS[1:]:
            kw = dict(n_clusters=6, n_init=10, delta=d,
                      true_distance_estimate=False, random_state=seed)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                j = JaxQKMeans(**kw).fit(Xj)
                with sqt.config_context(device="cpu"):
                    p = sqt.QKMeans(**kw).fit(Xs)
            out["jax"].setdefault(d, []).append(sk_ari(yj, j.labels_))
            out["port"].setdefault(d, []).append(sk_ari(y, p.labels_))
            if seed == 0:
                print(f"δ={d}: the JAX package's own adjusted_rand_score "
                      f"of its labels {float(jax_ari(yj, j.labels_))!r}, "
                      f"sklearn's {out['jax'][d][-1]!r}", flush=True)
        print(f"random_state {seed}: JAX "
              f"{[round(out['jax'][d][-1], 5) for d in DELTAS[1:]]}, port "
              f"{[round(out['port'][d][-1], 5) for d in DELTAS[1:]]}",
              flush=True)
    for d in DELTAS[1:]:
        first = out["jax"][d][0]
        low = min(out["jax"][d] + out["port"][d])
        print(f"δ={d}: JAX at random_state 0 {first!r}; JAX "
              f"{min(out['jax'][d])!r}..{max(out['jax'][d])!r}, port "
              f"{min(out['port'][d])!r}..{max(out['port'][d])!r}; lowest "
              f"of the 20 fits {first - low!r} below JAX's first")


def _measure_ari_overflow():
    """The JAX package's ARI against sklearn's on either side of 46 342
    samples, where its int32 pair count n·(n − 1) overflows."""
    for n in (46_341, 46_342):
        t, p = np.arange(n) % 2, (np.arange(n) // 7) % 2
        print(f"n={n}: JAX adjusted_rand_score "
              f"{float(jax_ari(t, p))!r}, sklearn {sk_ari(t, p)!r}")


def _measure_svd():
    """The JAX package's float32 spectrum error on the covertype
    surrogate."""
    X, _ = synthetic_surrogate(581_012, 54, 7, seed=54)
    s64 = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:10]
    print("float64 singular values:", s64.tolist())
    for algorithm in ("randomized", "arpack"):
        est = JaxTruncatedSVD(n_components=10, algorithm=algorithm,
                              random_state=0).fit(X)
        err = np.max(np.abs(est.singular_values_ - s64) / s64)
        print(f"JAX TruncatedSVD {algorithm}: largest relative error of "
              f"singular_values_ against float64 {err!r}")


if __name__ == "__main__":
    _measure_ari_overflow()
    _measure_svd()
    _measure_sweep()
