"""The CICIDS surrogate (``_cicids_surrogate`` of
``sq_learn_tpu_torch/datasets/_loaders.py``), at any number of classes and
with the class sizes the configuration gives.

Geometry, as the original draws it at 6 classes: ⌈k/2⌉ family centers
N(0, 10), then ⌊k/2⌋ random directions; the first ⌊k/2⌋ families each get
a twin at its grade × √m along its direction. The classes are the
families, then the twins. Row = its class center + N(0, noise_std) ×
scales, scales geometric from 1 to 0.05.

Configuration keys: ``n_features``, ``n_classes``, ``grades`` (⌊k/2⌋ of
them), ``noise_std``, ``geometry_seed``, and either ``class_counts`` (one
per class, in class order: exactly that many rows of each, in a drawn
order) or ``n_samples`` (uniform labels, as the original draws them).
"""

import numpy as np

from perfbench import data


def geometry(m, seed, n_classes=6, grades=(0.45, 0.7, 1.1)):
    """(class centers (k, m), scales (m,)) at ``seed``."""
    k = n_classes
    rng = np.random.default_rng(seed)
    families = rng.normal(scale=10.0, size=((k + 1) // 2, m))
    dirs = rng.normal(size=(k // 2, m))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    grades = np.asarray(grades, dtype=np.float64)[:k // 2]
    twins = families[:k // 2] + dirs * (grades[:, None] * np.sqrt(m))
    return np.concatenate([families, twins]), np.geomspace(1.0, 0.05, m)


def make(config, device, gen):
    k = config["n_classes"]
    classes, scales = geometry(config["n_features"], config["geometry_seed"],
                               k, config["grades"])
    if "class_counts" in config:
        counts = [int(c) for c in config["class_counts"].values()]
        assert len(counts) == k, "one count per class"
        y = data.counted_labels(counts, gen, device)
    else:
        y = data.uniform_labels(k, config["n_samples"], gen, device)
    X = data.rows(classes, scales, config["noise_std"], y, gen, device)
    return {"X": X, "y": y}
