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
