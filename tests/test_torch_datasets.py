"""The port's seeded datasets against the JAX package's.

Each is a copy that imports nothing of ``sq_learn_tpu``; on the same
arguments it must give the same arrays bit for bit (both are numpy only,
so nothing is left to tolerance).
"""

import numpy as np
import pytest

from sq_learn_tpu.datasets import _loaders as jax_loaders
from sq_learn_tpu_torch import datasets


@pytest.mark.parametrize("n,grades,seed", [
    (500, jax_loaders._MNIST_LOW_MARGIN_GRADES, 785),
    (333, (0.5, 2.0), 1),
    (64, (1.0,), 7),
])
def test_graded_pair_surrogate_equals_the_jax_package(n, grades, seed):
    X, y = datasets.graded_pair_surrogate(n, 40, grades, seed)
    Xj, yj = jax_loaders.graded_pair_surrogate(n, 40, grades, seed)
    assert X.dtype == Xj.dtype == np.float32 and y.dtype == yj.dtype
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    assert set(np.unique(y)) <= set(range(2 * len(grades)))


def test_low_margin_surrogate_equals_the_jax_package():
    assert (datasets._MNIST_LOW_MARGIN_GRADES
            == jax_loaders._MNIST_LOW_MARGIN_GRADES)
    X, y = datasets.load_mnist_surrogate_low_margin(300)
    Xj, yj = jax_loaders.load_mnist_surrogate_low_margin(300)
    assert X.shape == (300, 784)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("n,m,classes,seed", [(400, 30, 4, 3),
                                              (257, 784, 10, 784)])
def test_synthetic_surrogate_equals_the_jax_package(n, m, classes, seed):
    X, y = datasets.synthetic_surrogate(n, m, classes, seed)
    Xj, yj = jax_loaders.synthetic_surrogate(n, m, classes, seed)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("n,m", [(500, 78), (64, 10)])
def test_cicids_surrogate_equals_the_jax_package(n, m, monkeypatch):
    monkeypatch.delenv("CICIDS_CSV", raising=False)
    with pytest.warns(UserWarning, match="surrogate"):
        X, y, real = datasets.load_cicids(n_samples=n, n_features=m)
    with pytest.warns(UserWarning, match="surrogate"):
        Xj, yj, real_j = jax_loaders.load_cicids(n_samples=n, n_features=m)
    assert real is real_j is False
    assert X.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    assert set(np.unique(y)) <= set(range(6))


def test_cicids_csv_is_read_as_the_jax_package_reads_it(tmp_path):
    """A quoted field (the JAX package then takes its csv-module branch,
    the port's only one), an inf row that is dropped, a non-numeric row
    that is skipped and a blank line."""
    path = tmp_path / "cicids_rel.csv"
    path.write_text(
        'Flow Duration,Fwd Packets,"Flow Bytes/s",Label\n'
        '10,2,0.5,BENIGN\n'
        '3,"1",1.25, DoS\n'
        '7,4,inf,PortScan\n'
        '\n'
        'x,1,2,BENIGN\n'
        '1e3,0,-2,DDoS\n')
    X, y, real = datasets.load_cicids(str(path))
    Xj, yj, real_j = jax_loaders.load_cicids(str(path))
    assert real is real_j is True
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(
        X, np.float32([[10, 2, 0.5], [3, 1, 1.25], [1000, 0, -2]]))
    # labels coded by their sorted order: BENIGN, DDoS, DoS
    assert y.tolist() == [0, 2, 1]


def test_covtype_and_mnist_stand_ins_are_the_jax_packages_surrogates():
    """The JAX loaders fall back to these surrogates offline; the port
    never tries the fetch."""
    X, y, real = datasets.load_covtype()
    assert real is False and X.shape == (581_012, 54)
    Xj, yj = jax_loaders.synthetic_surrogate(581_012, 54, 7, seed=54)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    del X, Xj
    X, y, real = datasets.load_mnist()
    assert real is False and X.shape == (70_000, 784)
    Xj, yj = jax_loaders.synthetic_surrogate(70_000, 784, 10, seed=784)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("kw", [
    {},
    {"n_samples": 130, "centers": 3, "n_features": 4, "cluster_std": 0.3,
     "random_state": 7},
    {"n_samples": 50, "centers": [[0.0, 1.0], [5.0, 5.0]],
     "random_state": 1},
])
def test_make_blobs_equals_the_jax_package(kw):
    X, y = datasets.make_blobs(**kw)
    Xj, yj = jax_loaders.make_blobs(**kw)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_bunch_and_the_unported_fetchers():
    b = datasets.Bunch(data=1)
    b.target = 2
    assert b.data == 1 and b["target"] == 2
    with pytest.raises(AttributeError):
        b.missing
    for fetch in (datasets.fetch_openml, datasets.fetch_covtype):
        with pytest.raises(NotImplementedError,
                           match="item 7, the dataset fetchers"):
            fetch()
    X, y = datasets.load_digits()  # the port's own copy: no download
    assert X.shape == (1797, 64) and y.shape == (1797,)
