"""Synthetic datasets (a copy of ``synthetic_surrogate`` from
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
