"""The benchmark's data, made on the device in set-up.

A configuration names its ``recipe``; ``data/<recipe>.py`` makes its rows
with ``make(config, device, gen)`` and returns {"X": (n, m) float32, "y":
(n,) int64}, both on ``device``. The recipes are frozen copies of the
port's seeded surrogates (``sq_learn_tpu_torch/datasets/_loaders.py``),
rewritten so that the rows are drawn on the device. Each has two parts:
the geometry (class centers, pair offsets, per-feature scales) is a few
rows, drawn on the host with NumPy as the original recipe draws it, from
the configuration's ``geometry_seed``; the rows (labels and noise, the
bulk) are drawn on the device by a ``torch.Generator`` seeded from its
``data_seed``, in a few large calls, in float32. So a configuration is one
fixed data set, as MNIST or CIC-IDS2017 is; a run's ``--seed`` draws the
work on it.
"""

import torch

from perfbench import named


def generator(seed, device):
    """A generator on ``device`` seeded from ``seed`` (any whole number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def rows(classes, scales, noise_std, y, gen, device):
    """The rows of labels ``y``: each label's center plus N(0, noise_std)
    × scales, drawn from ``gen``."""
    centers = torch.as_tensor(classes, dtype=torch.float32, device=device)
    sc = torch.as_tensor(scales * noise_std, dtype=torch.float32,
                         device=device)
    X = torch.randn((y.shape[0], centers.shape[1]), generator=gen,
                    device=device)
    X.mul_(sc).add_(centers[y])
    return X


def uniform_labels(n_classes, n, gen, device):
    """n labels drawn uniformly from 0..n_classes-1."""
    return torch.randint(0, n_classes, (n,), generator=gen, device=device)


def counted_labels(counts, gen, device):
    """Exactly ``counts[j]`` rows of each label j, in an order drawn from
    ``gen``."""
    y = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.as_tensor(counts, device=device))
    return y[torch.randperm(y.shape[0], generator=gen, device=device)]


def standardize(X):
    """Columns to zero mean and unit population variance, in place (as
    ``StandardScaler`` does; a constant column is left centered)."""
    mean = X.mean(dim=0)
    std = X.std(dim=0, correction=0)
    std = torch.where(std > 0, std, torch.ones_like(std))
    X.sub_(mean).div_(std)
    return X


def recipe(name):
    """The module ``data/<name>.py``."""
    return named.load("data", name)


def make(config, device):
    """The configuration's rows, made on ``device`` by its recipe, then
    standardized where the configuration says so."""
    gen = generator(config["data_seed"], device)
    out = recipe(config["recipe"]).make(config, device, gen)
    if config.get("standardize"):
        standardize(out["X"])
    return out
