"""``graded_pair_surrogate`` (``sq_learn_tpu_torch/datasets/_loaders.py``):
``len(grades)`` family centers, each split into a pair of classes offset
along a random direction by grade × the within-class spread; uniform
labels; row = its class center + N(0, cluster_std) × scales.

Configuration keys: ``n_samples``, ``n_features``, ``grades``,
``center_scale``, ``cluster_std``, ``geometry_seed`` and ``geometry_n``
(the row count the original recipe drew its geometry at).
"""

import numpy as np

from perfbench import data


def geometry(n, m, grades, seed, center_scale=10.0, cluster_std=4.0):
    """(class centers (2·fams, m), scales (m,)) of the recipe at ``seed``,
    drawn in its order: the family centers, the labels (n of them: they
    come before the directions), the directions."""
    rng = np.random.default_rng(seed)
    fams = len(grades)
    centers = rng.normal(scale=center_scale, size=(fams, m))
    scales = np.geomspace(1.0, 0.05, m)
    within = cluster_std * np.linalg.norm(scales)
    rng.integers(0, 2 * fams, size=n)
    dirs = rng.normal(size=(fams, m))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    offsets = np.asarray(grades, dtype=np.float64)[:, None] * within * dirs
    classes = np.empty((2 * fams, m))
    classes[0::2] = centers
    classes[1::2] = centers + offsets
    return classes, scales


def make(config, device, gen):
    classes, scales = geometry(
        config["geometry_n"], config["n_features"], config["grades"],
        config["geometry_seed"], config["center_scale"],
        config["cluster_std"])
    y = data.uniform_labels(classes.shape[0], config["n_samples"], gen,
                            device)
    X = data.rows(classes, scales, config["cluster_std"], y, gen, device)
    return {"X": X, "y": y}
