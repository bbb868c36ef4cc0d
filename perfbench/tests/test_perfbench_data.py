"""The torch data recipes against the port's NumPy ones: the same geometry,
and rows with the same statistics at a small size."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import data
from sq_learn_tpu_torch.datasets import _loaders

ROOT = os.path.dirname(data.named.BENCH)

GRADES = (0.3, 0.6, 1.0, 1.8, 3.0)
graded = data.recipe("graded_pair_surrogate")
cicids = data.recipe("cicids_surrogate")


def test_graded_pair_geometry_is_the_recipes():
    n, m = 4000, 784
    classes, scales = graded.geometry(n, m, GRADES, 785)
    X, y = _loaders.graded_pair_surrogate(n, m, GRADES, seed=785,
                                          dtype=np.float64)
    # the recipe's rows less their noise are exactly the class centers
    rng = np.random.default_rng(785)
    rng.normal(scale=10.0, size=(5, m))
    rng.integers(0, 10, size=n)
    rng.normal(size=(5, m))
    noise = rng.normal(scale=4.0, size=(n, m)) * scales
    np.testing.assert_allclose(X - noise, classes[y], rtol=0, atol=1e-9)


def test_cicids_geometry_is_the_recipes():
    n, m = 3000, 78
    classes, scales = cicids.geometry(m, 78)
    X, y = _loaders._cicids_surrogate(n, m, seed=78)
    rng = np.random.default_rng(78)
    rng.normal(scale=10.0, size=(3, m))
    rng.normal(size=(3, m))
    rng.integers(0, 6, size=n)
    noise = rng.normal(scale=0.5, size=(n, m)) * scales
    np.testing.assert_allclose(X, (classes[y] + noise).astype(np.float32),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("recipe", ["graded", "cicids"])
def test_rows_have_the_recipes_statistics(recipe):
    n = 20_000
    if recipe == "graded":
        m = 784
        classes, scales = graded.geometry(70_000, m, GRADES, 785)
        std = 4.0
    else:
        m = 78
        classes, scales = cicids.geometry(m, 78)
        std = 0.5
    gen = data.generator(12345, "cpu")
    y = data.uniform_labels(len(classes), n, gen, "cpu")
    X = data.rows(classes, scales, std, y, gen, "cpu")
    assert X.dtype == torch.float32 and X.shape == (n, m)
    counts = torch.bincount(y, minlength=len(classes)).numpy()
    expect = n / len(classes)
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))
    resid = X.double().numpy() - classes[y.numpy()]
    # per-feature noise scale std·scale, within sampling error
    ratio = resid.std(axis=0) / (std * scales)
    assert np.all(np.abs(ratio - 1) < 0.05)
    assert np.all(np.abs(resid.mean(axis=0)) < 5 * std * scales / np.sqrt(n))


def test_make_is_one_data_set_per_configuration():
    cfg = {"recipe": "cicids_surrogate", "n_samples": 500, "n_features": 78,
           "n_classes": 6, "grades": [0.45, 0.7, 1.1], "noise_std": 0.5,
           "geometry_seed": 78, "data_seed": 78, "standardize": True}
    a, b = data.make(cfg, "cpu"), data.make(cfg, "cpu")
    assert torch.equal(a["X"], b["X"]) and torch.equal(a["y"], b["y"])
    X = a["X"].double()
    assert float(X.mean(0).abs().max()) < 1e-5
    assert float((X.std(0, correction=0) - 1).abs().max()) < 1e-4
    other = data.make({**cfg, "data_seed": 79}, "cpu")
    assert not torch.equal(a["X"], other["X"])


def test_generator_takes_large_seeds():
    g = data.generator(2**31 + 12345, "cpu")
    h = data.generator(2**31 + 12345, "cpu")
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=h))


def test_cicids_at_the_releases_15_labels():
    """The configuration's own recipe, at a tenth of each class's rows:
    exactly those counts, 15 centers (8 families, then 7 twins at the
    recipe's grades), the 6-class geometry's draws as its first ones."""
    cfg = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                      "cicids2017.json")))
    assert sum(cfg["class_counts"].values()) == cfg["n_samples"]
    assert len(cfg["class_counts"]) == cfg["n_classes"] == 15
    assert cfg["n_clusters"] == cfg["n_classes"]
    small = {**cfg, "class_counts": {k: max(1, v // 10) for k, v in
                                     cfg["class_counts"].items()}}
    out = data.make({**small, "standardize": False}, "cpu")
    counts = torch.bincount(out["y"], minlength=15).tolist()
    assert counts == list(small["class_counts"].values())
    classes, scales = cicids.geometry(78, 78, 15, cfg["grades"])
    assert classes.shape == (15, 78)
    twin = np.linalg.norm(classes[8:] - classes[:7], axis=1)
    np.testing.assert_allclose(twin, np.asarray(cfg["grades"]) * np.sqrt(78))
    rng = np.random.default_rng(78)
    np.testing.assert_array_equal(classes[:3],
                                  rng.normal(scale=10.0, size=(8, 78))[:3])
    resid = out["X"].double().numpy() - classes[out["y"].numpy()]
    assert np.all(np.abs(resid.std(axis=0) / (0.5 * scales) - 1) < 0.05)
