"""Pairwise distances (counterpart of ``sq_learn_tpu/metrics/pairwise.py``,
the slice q-means ``transform`` reads)."""

import torch

from ..ops.linalg import pairwise_sq_distances


def euclidean_distances(X, Y=None, squared=False):
    """Euclidean distances between the rows of X and Y (tensors), by the
    ‖x‖²+‖y‖²−2XYᵀ form clipped at 0."""
    Y = X if Y is None else Y
    d2 = pairwise_sq_distances(X, Y)
    return d2 if squared else torch.sqrt(d2)
