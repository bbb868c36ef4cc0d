"""Synthetic datasets (copies of ``synthetic_surrogate``,
``graded_pair_surrogate`` and ``load_mnist_surrogate_low_margin`` from
``sq_learn_tpu/datasets/_loaders.py``): data made from a seed, so nothing
is downloaded."""

import numpy as np


def synthetic_surrogate(n_samples, n_features, n_classes, seed,
                        cluster_std=4.0, dtype=np.float32):
    """Deterministic class-structured surrogate data of a given shape.

    Gaussian blobs around per-class centroids with per-feature scale
    decay. ``synthetic_surrogate(70_000, 784, 10, seed=784)`` is the
    offline MNIST-shaped stand-in. Returns (X, y).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=10.0, size=(n_classes, n_features))
    scales = np.geomspace(1.0, 0.05, n_features)
    y = rng.integers(0, n_classes, size=n_samples)
    X = centers[y] + rng.normal(scale=cluster_std,
                                size=(n_samples, n_features)) * scales
    return X.astype(dtype), y.astype(np.int32)


def graded_pair_surrogate(n_samples, n_features, grades, seed,
                          center_scale=10.0, cluster_std=4.0,
                          dtype=np.float32):
    """Class-pair surrogate whose margins are graded against the
    within-class spread.

    ``len(grades)`` well-separated family centroids are each split into a
    pair of classes offset along a random direction by ``grade ×
    within-class spread`` (the spread being ``cluster_std·‖scales‖`` under
    the per-feature decay of :func:`synthetic_surrogate`). Tight pairs
    (grade ≲ 1) overlap; loose pairs (grade ≳ 3) stay apart. Returns
    (X, y) with ``2·len(grades)`` classes.
    """
    rng = np.random.default_rng(seed)
    fams = len(grades)
    centers = rng.normal(scale=center_scale, size=(fams, n_features))
    scales = np.geomspace(1.0, 0.05, n_features)
    within = cluster_std * np.linalg.norm(scales)
    y = rng.integers(0, 2 * fams, size=n_samples)
    fam = y // 2
    dirs = rng.normal(size=(fams, n_features))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    offsets = np.asarray(grades)[:, None] * within * dirs
    X = (centers[fam] + (y % 2)[:, None] * offsets[fam]
         + rng.normal(scale=cluster_std, size=(n_samples, n_features))
         * scales)
    return X.astype(dtype), y.astype(np.int32)


#: pair grades of the low-margin MNIST-shaped surrogate: the tightest pair
#: barely separable, the loosest well apart
_MNIST_LOW_MARGIN_GRADES = (0.3, 0.6, 1.0, 1.8, 3.0)


def load_mnist_surrogate_low_margin(n_samples=10_000):
    """MNIST-shaped (784-wide, 10-class) surrogate whose class pairs
    overlap by the grades ``_MNIST_LOW_MARGIN_GRADES``, seed 785. Always
    synthetic; returns (X, y)."""
    return graded_pair_surrogate(n_samples, 784,
                                 _MNIST_LOW_MARGIN_GRADES, seed=785)
