"""Datasets (copies from ``sq_learn_tpu/datasets/_loaders.py``): the
seeded surrogates, the BASELINE loaders as their offline stand-ins, the
digits from the port's own copy of the data, the CICIDS CSV reader and
``make_blobs``. Nothing is downloaded."""

import csv
import gzip
import os
import warnings

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


# ---------------------------------------------------------------------------
# The BASELINE loaders (copies of ``load_mnist``, ``load_covtype``,
# ``load_cicids``, ``_cicids_surrogate``, ``make_blobs`` and ``Bunch`` from
# ``sq_learn_tpu/datasets/_loaders.py:100-288``), offline only
# ---------------------------------------------------------------------------

_FETCHERS = ("{} is not ported: it needs a download, and the port never "
             "fetches; ROADMAP.md §1 item 7, the dataset fetchers")


def load_mnist(data_home=None):
    """The MNIST-784 stand-in (BASELINE #2/#3): ``synthetic_surrogate(70_000,
    784, 10, seed=784)``, the JAX package's offline fallback. The port never
    fetches; returns (X, y, real) with ``real`` False."""
    X, y = synthetic_surrogate(70_000, 784, 10, seed=784)
    return X, y, False


def load_covtype(data_home=None):
    """The covertype stand-in (BASELINE #4): ``synthetic_surrogate(581_012,
    54, 7, seed=54)``, the JAX package's offline fallback. The port never
    fetches; returns (X, y, real) with ``real`` False."""
    X, y = synthetic_surrogate(581_012, 54, 7, seed=54)
    return X, y, False


#: the CICIDS2017 classes the surrogate stands in for
_CICIDS_CLASSES = ("BENIGN", "DoS", "PortScan", "DDoS", "Bot", "Infiltration")


def load_cicids(path=None, n_samples=50_000, n_features=78):
    """CICIDS intrusion-detection loader (BASELINE #5).

    ``path`` names a ``cicids_rel.csv``-style file: a header line, then
    numeric feature columns and a trailing string label column. It is read
    with the ``csv`` module, as float32; rows with a non-numeric feature
    are skipped and rows with a non-finite one dropped, and the labels are
    coded by their sorted order. None or a missing file gives the
    surrogate (:func:`_cicids_surrogate`, seed 78) with a warning.

    Returns (X, y, real): float32 features, int32 labels, ``real`` False
    for the surrogate.
    """
    if path and os.path.exists(path):
        feats, labels = [], []
        with open(path, newline="") as fh:
            reader = csv.reader(fh)
            next(reader, None)
            for row in reader:
                if not row:
                    continue
                try:
                    vals = [float(v) for v in row[:-1]]
                except ValueError:
                    continue
                feats.append(vals)
                labels.append(row[-1].strip())
        X = np.asarray(feats, dtype=np.float32)
        mask = np.isfinite(X).all(axis=1)
        _, y = np.unique(np.asarray(labels)[mask], return_inverse=True)
        return X[mask], y.astype(np.int32), True
    warnings.warn(
        "cicids CSV not found — using a deterministic synthetic surrogate")
    X, y = _cicids_surrogate(n_samples, n_features, seed=78)
    return X, y, False


def _cicids_surrogate(n_samples, n_features, seed):
    """Overlapping-class surrogate with CICIDS-like geometry: three
    well-separated family centroids, each split into a pair of classes at
    a graded offset (0.45, 0.7 and 1.1 × √m along a random direction), so
    that the δ-window merges the tightest pair first and the ARI falls
    smoothly as δ grows."""
    k = len(_CICIDS_CLASSES)
    rng = np.random.default_rng(seed)
    families = rng.normal(scale=10.0, size=(k // 2, n_features))
    dirs = rng.normal(size=(k // 2, n_features))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    grades = np.asarray([0.45, 0.7, 1.1][:k // 2])
    twins = families + dirs * (grades[:, None] * np.sqrt(n_features))
    centers = np.concatenate([families, twins])
    scales = np.geomspace(1.0, 0.05, n_features)
    y = rng.integers(0, k, size=n_samples)
    X = centers[y] + rng.normal(scale=0.5,
                                size=(n_samples, n_features)) * scales
    return X.astype(np.float32), y.astype(np.int32)


def make_blobs(n_samples=400, centers=4, n_features=2, cluster_std=1.0,
               random_state=0):
    """Isotropic Gaussian blobs from a seed; returns (X float32, y int32)."""
    rng = np.random.default_rng(random_state)
    if isinstance(centers, int):
        centers = rng.uniform(-10, 10, size=(centers, n_features))
    centers = np.asarray(centers, dtype=np.float64)
    y = rng.integers(0, len(centers), size=n_samples)
    X = centers[y] + rng.normal(scale=cluster_std,
                                size=(n_samples, centers.shape[1]))
    return X.astype(np.float32), y.astype(np.int32)


class Bunch(dict):
    """Attribute-accessible dict (the sklearn container convention)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value


#: the port's copy of sklearn's bundled digits (``data/README``)
_DIGITS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "digits.csv.gz")


def load_digits():
    """The optical-recognition digits, 1797 × 64 (BASELINE #1): the UCI
    test set as scikit-learn bundles it, read from the port's byte-for-byte
    copy (``datasets/data/digits.csv.gz``) with numpy and gzip alone, so it
    needs neither sklearn nor a network. Returns (X float32 (1797, 64),
    y int32 (1797,)), the JAX package's ``load_digits``."""
    with gzip.open(_DIGITS_PATH, "rt", encoding="utf-8") as fh:
        data = np.loadtxt(fh, delimiter=",")
    return data[:, :-1].astype(np.float32), data[:, -1].astype(np.int32)


def fetch_openml(*args, **kwargs):
    """Not ported: the port has no network fetcher (:func:`load_mnist`
    gives the MNIST stand-in)."""
    raise NotImplementedError(_FETCHERS.format("fetch_openml"))


def fetch_covtype(*args, **kwargs):
    """Not ported: the port has no network fetcher (:func:`load_covtype`
    gives the covertype stand-in)."""
    raise NotImplementedError(_FETCHERS.format("fetch_covtype"))
