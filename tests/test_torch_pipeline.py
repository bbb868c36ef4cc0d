"""The port's Pipeline, ParameterGrid and GridSearchCV against the JAX
package's.

``Pipeline(StandardScaler, QPCA, KNeighborsClassifier)`` fits, predicts and
scores as the JAX pipeline does on the same seeded data: predictions equal
(the k-NN lists agree away from float32 ties, ROADMAP.md §3's margin rule,
and the classes here leave no tie), and a grid search over it gives the
same ``cv_results_`` and ``best_params_``.
"""

import numpy as np
import pytest
import torch

from sq_learn_tpu import Pipeline as JaxPipeline
from sq_learn_tpu import make_pipeline as jax_make_pipeline
from sq_learn_tpu.datasets import synthetic_surrogate
from sq_learn_tpu.model_selection import GridSearchCV as JaxGridSearchCV
from sq_learn_tpu.model_selection import ParameterGrid as JaxParameterGrid
from sq_learn_tpu.model_selection import StratifiedKFold as JaxSKF
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.preprocessing import StandardScaler as JaxScaler
from sq_learn_tpu_torch import (QPCA, KNeighborsClassifier, Pipeline, QKMeans,
                                clone, config_context, make_pipeline)
from sq_learn_tpu_torch.model_selection import (GridSearchCV, ParameterGrid,
                                                StratifiedKFold)
from sq_learn_tpu_torch.preprocessing import MinMaxScaler, StandardScaler


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    # overlapping classes, so that scores fall below 1 and settings differ
    return synthetic_surrogate(600, 40, 5, seed=11, cluster_std=150.0)


def _pipes(n_components=8, k=5):
    port = Pipeline([("scale", StandardScaler()),
                     ("pca", QPCA(n_components=n_components,
                                  svd_solver="full", random_state=0)),
                     ("knn", KNeighborsClassifier(n_neighbors=k))])
    ref = JaxPipeline([("scale", JaxScaler()),
                       ("pca", JaxQPCA(n_components=n_components,
                                       svd_solver="full", random_state=0)),
                       ("knn", JaxKNN(n_neighbors=k))])
    return port, ref


def test_pipeline_fit_predict_score_match_jax(data):
    X, y = data
    port, ref = _pipes()
    port.fit(X[:450], y[:450])
    ref.fit(X[:450], y[:450])
    Xq, yq = X[450:], y[450:]
    np.testing.assert_array_equal(port.predict(Xq), ref.predict(Xq))
    np.testing.assert_allclose(port.predict_proba(Xq),
                               ref.predict_proba(Xq), rtol=1e-6)
    assert port.score(Xq, yq) == pytest.approx(float(ref.score(Xq, yq)),
                                               rel=1e-6)
    assert 0.3 < port.score(Xq, yq) < 1.0
    # each step hands the next a tensor on the estimator's device
    Xt = port.named_steps["scale"].transform(Xq)
    assert isinstance(Xt, torch.Tensor) and Xt.device.type == "cpu"
    step_by_step = port.named_steps["knn"].predict(
        port.named_steps["pca"].transform(Xt))
    np.testing.assert_array_equal(port.predict(Xq), step_by_step)


def test_pipeline_params_round_trip():
    pipe = make_pipeline(StandardScaler(), QPCA(n_components=5))
    ref = jax_make_pipeline(JaxScaler(), JaxQPCA(n_components=5))
    assert [n for n, _ in pipe.steps] == [n for n, _ in ref.steps] == [
        "standardscaler", "qpca"]
    params = pipe.get_params()
    assert params["qpca__n_components"] == 5
    assert params["standardscaler"] is pipe.named_steps["standardscaler"]
    pipe.set_params(qpca__n_components=7, standardscaler__with_mean=False)
    assert pipe.named_steps["qpca"].n_components == 7
    assert pipe.get_params()["standardscaler__with_mean"] is False
    # a whole step replaced by name
    scaler = MinMaxScaler()
    pipe.set_params(standardscaler=scaler)
    assert pipe.named_steps["standardscaler"] is scaler
    twin = clone(pipe)
    assert twin is not pipe and twin.named_steps["qpca"] is not \
        pipe.named_steps["qpca"]
    assert twin.named_steps["qpca"].n_components == 7
    assert type(twin.named_steps["standardscaler"]) is MinMaxScaler
    assert not hasattr(twin.named_steps["qpca"], "components_")
    with pytest.raises(ValueError, match="invalid parameter"):
        pipe.set_params(nosuchstep=1)
    with pytest.raises(ValueError, match="unique"):
        Pipeline([("a", StandardScaler()), ("a", MinMaxScaler())])


def test_make_pipeline_names_repeated_steps_as_jax():
    pipe = make_pipeline(StandardScaler(), StandardScaler(), MinMaxScaler())
    ref = jax_make_pipeline(JaxScaler(), JaxScaler(), JaxScaler())
    assert [n for n, _ in pipe.steps][:2] == [n for n, _ in ref.steps][:2] \
        == ["standardscaler", "standardscaler-2"]


def test_pipeline_passthrough_transform_and_fit_predict(data):
    X, _ = data
    pipe = Pipeline([("skip", "passthrough"), ("scale", StandardScaler())])
    out = pipe.fit_transform(X)
    np.testing.assert_allclose(out.numpy(), pipe.transform(X).numpy(),
                               rtol=1e-6)
    init = X[:4]
    clus = Pipeline([("scale", StandardScaler()),
                     ("km", QKMeans(n_clusters=4, init=StandardScaler().fit(
                         X).transform(init), n_init=1, delta=0.0))])
    with pytest.warns(UserWarning, match="classic"):
        labels = clus.fit_predict(X)
    np.testing.assert_array_equal(labels, clus.named_steps["km"].labels_)
    assert clus.score(X) == pytest.approx(
        clus.named_steps["km"].score(clus.named_steps["scale"].transform(X)))


@pytest.mark.parametrize("grid", [
    {"b": [1, 2], "a": ["x", "y", "z"]},
    [{"c": [0]}, {"a": [1, 2], "b": [True, False]}],
    {},
])
def test_parameter_grid_order_and_length_match_jax(grid):
    ours, ref = ParameterGrid(grid), JaxParameterGrid(grid)
    assert list(ours) == list(ref)
    assert len(ours) == len(ref) == len(list(ours))


def test_grid_search_matches_jax(data):
    X, y = data
    grid = {"pca__n_components": [4, 12], "knn__n_neighbors": [1, 7]}
    port, ref = _pipes()
    gs = GridSearchCV(port, grid, cv=StratifiedKFold(3)).fit(X, y)
    gj = JaxGridSearchCV(ref, grid, cv=JaxSKF(3)).fit(X, y)
    assert gs.cv_results_["params"] == gj.cv_results_["params"]
    np.testing.assert_allclose(gs.cv_results_["split_test_scores"],
                               gj.cv_results_["split_test_scores"],
                               rtol=1e-6)
    np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                               gj.cv_results_["mean_test_score"], rtol=1e-6)
    assert gs.best_params_ == gj.best_params_
    assert gs.best_score_ == pytest.approx(gj.best_score_, rel=1e-6)
    assert gs.best_score_ == pytest.approx(
        gs.cv_results_["mean_test_score"].max())
    # the scores differ across the grid, so the choice is not a tie
    assert len(set(gs.cv_results_["mean_test_score"].round(6))) > 1
    np.testing.assert_array_equal(gs.predict(X[:50]), gj.predict(X[:50]))
    assert gs.score(X, y) == pytest.approx(float(gj.score(X, y)), rel=1e-6)
    refit = gs.best_estimator_
    assert refit.named_steps["pca"].n_components == \
        gs.best_params_["pca__n_components"]


def test_grid_search_without_refit_and_ties_pick_the_first():
    X, y = synthetic_surrogate(300, 16, 3, seed=2)
    gs = GridSearchCV(KNeighborsClassifier(), {"n_neighbors": [3, 5]},
                      cv=3, refit=False).fit(X, y)
    assert not hasattr(gs, "best_estimator_")
    # far-apart classes: every setting scores 1.0, the first one wins
    assert gs.best_params_ == {"n_neighbors": 3} and gs.best_score_ == 1.0
    assert gs.cv_results_["split_test_scores"].shape == (2, 3)
