"""Clustering — reference-namespace facade (``sklearn/cluster``): the
names a reference user imports resolve to the port's implementations."""

import numpy as np
import torch

from ..models.minibatch import MiniBatchKMeans, MiniBatchQKMeans
from ..models.qkmeans import (KMeans, QKMeans, k_means, kmeans_plusplus,
                              lloyd_single)

# the reference's class name (``_dmeans.py:833``)
qMeans_ = QKMeans


def select_labels(a, generator=None):
    """Uniform pick among candidate labels (reference ``select_labels``,
    ``_dmeans.py:2252``, the δ-means tie-break; the JAX package's shim).
    The fused E-step samples the δ-window pick itself
    (:func:`~sq_learn_tpu_torch.models.qkmeans.pick_labels`); reference
    code calling this directly runs unmodified. The pick is drawn from
    the torch ``generator`` when one is given, else from a fresh
    entropy-seeded CPU generator. ``a`` is a sequence, array or tensor;
    the pick is its element. Raises ``ValueError`` on an empty candidate
    set, where the reference prints 'Error' and returns None."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if len(a.reshape(-1)) == 0:
        raise ValueError("select_labels: empty candidate set")
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    idx = int(torch.randint(a.shape[0], (), generator=generator,
                            device=generator.device))
    return a[idx]


__all__ = ["KMeans", "MiniBatchKMeans", "MiniBatchQKMeans", "QKMeans",
           "qMeans_", "k_means", "kmeans_plusplus", "lloyd_single",
           "select_labels"]
