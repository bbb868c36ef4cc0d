"""BASELINE #1 on the port, on the CPU: sklearn's digits (1797 × 64) read
from the port's own copy, and q-means k=10 on them against the JAX
package and sklearn.

- ``load_digits()`` equals the JAX package's bit for bit (X and y, dtypes
  included), and its file is sklearn's bundled copy byte for byte.
- δ=0 from one explicit init: labels and ``n_iter_`` equal to
  ``sq_learn_tpu``'s ``QKMeans``, inertia within rtol 1e-4. The init is
  the ten classes' means. Digits are integer-valued, so an init of data
  rows puts two centers at exactly the same distance from some row; on
  the centered rows each package then settles that tie by its own
  float32 rounding, and the two paths can part (from the rows
  ``default_rng(0).choice(1797, 10)``: equal final labels, ``n_iter_`` 15
  against the JAX package's 16). From the class means every row's two
  nearest centers lie at least 0.228 apart.
- δ=0.5 (BASELINE #1's own setting): the ARI against the JAX fit and
  against sklearn's ``KMeans`` at least ``chip_smoke.DIGITS_ARI_FLOOR``,
  the inertia within 2 % of the JAX fit's, and the floor and ceiling
  that ``chip_smoke.py`` holds the card to (the median ARI of seeds 0–2
  against the δ=0 fit of seed 0, the median ratio of their inertias).
"""

import gzip
import importlib.util
import os
import warnings

import numpy as np
import pytest

import chip_smoke
from sq_learn_tpu.datasets import load_digits as jax_load_digits
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.datasets import _loaders, load_digits
from sq_learn_tpu_torch.metrics import adjusted_rand_score
from sq_learn_tpu_torch.models import QKMeans

#: BASELINE #1 (``BASELINE.md`` row 1; ``bench.py``'s headline fit)
BASELINE1 = dict(n_clusters=10, n_init=10, max_iter=300,
                 true_distance_estimate=False)
SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # δ=0's classic-route notice
        yield


def test_load_digits_equals_the_jax_packages_bit_for_bit():
    X, y = load_digits()
    Xj, yj = jax_load_digits()
    assert X.dtype == Xj.dtype == np.float32
    assert y.dtype == yj.dtype == np.int32
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    assert X.shape == (chip_smoke.DIGITS_N, chip_smoke.DIGITS_M)
    assert sorted(np.unique(y)) == list(range(chip_smoke.DIGITS_K))
    assert float(X.sum()) == chip_smoke.DIGITS_X_SUM
    assert X.min() == 0 and X.max() == 16


def test_the_data_file_is_sklearns_copy():
    spec = importlib.util.find_spec("sklearn.datasets")
    theirs = os.path.join(os.path.dirname(spec.origin), "data",
                          "digits.csv.gz")
    with open(_loaders._DIGITS_PATH, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with gzip.open(_loaders._DIGITS_PATH, "rt") as fh:
        assert sum(1 for _ in fh) == 1797
    readme = os.path.join(os.path.dirname(_loaders._DIGITS_PATH), "README")
    with open(readme) as fh:
        text = fh.read()
    assert "CC BY 4.0" in text and "BSD 3-Clause" in text


def _class_means(X, y):
    return np.stack([X[y == c].mean(0) for c in range(10)]).astype(
        np.float32)


def test_delta0_from_one_init_matches_the_jax_package():
    X, y = load_digits()
    init = _class_means(X, y)
    d2 = ((X[:, None, :].astype(np.float64)
           - init[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > 0.2  # no row near a tie
    kw = dict(BASELINE1, init=init, n_init=1, delta=0.0, random_state=0)
    t = QKMeans(**kw).fit(X)
    j = JaxQKMeans(**kw).fit(X)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert t.n_iter_ == j.n_iter_
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-4)
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def fits():
    """The port's BASELINE #1 fits on the CPU: δ=0 at seed 0, δ=0.5 at
    seeds 0–2; the JAX package's δ=0.5 fits at the same seeds; sklearn's
    ``KMeans(10, n_init=10, random_state=0)``."""
    from sklearn.cluster import KMeans as SkKMeans

    X, _ = load_digits()
    with config_context(device="cpu"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = QKMeans(delta=0.0, random_state=0, **BASELINE1).fit(X)
        port = [QKMeans(delta=0.5, random_state=s, **BASELINE1).fit(X)
                for s in SEEDS]
        jax = [JaxQKMeans(delta=0.5, random_state=s, **BASELINE1).fit(X)
               for s in SEEDS]
    sk = SkKMeans(10, n_init=10, random_state=0).fit(X)
    return {"exact": exact, "port": port, "jax": jax, "sklearn": sk}


@pytest.mark.parametrize("seed", SEEDS)
def test_delta_means_against_jax_and_sklearn(fits, seed):
    t, j = fits["port"][seed], fits["jax"][seed]
    assert adjusted_rand_score(j.labels_, t.labels_) \
        >= chip_smoke.DIGITS_ARI_FLOOR
    assert adjusted_rand_score(fits["sklearn"].labels_, t.labels_) \
        >= chip_smoke.DIGITS_ARI_FLOOR
    assert t.inertia_ == pytest.approx(j.inertia_, rel=0.02)
    assert 1 <= t.n_iter_ <= 300
    assert t.cluster_centers_.shape == (10, 64)


def test_the_cards_floor_and_ceiling_hold_on_the_cpu(fits):
    exact = fits["exact"]
    aris = [adjusted_rand_score(exact.labels_, f.labels_)
            for f in fits["port"]]
    ratios = [f.inertia_ / exact.inertia_ for f in fits["port"]]
    assert np.median(aris) >= chip_smoke.DIGITS_ARI_FLOOR
    assert np.median(ratios) <= chip_smoke.DIGITS_INERTIA_CEIL
