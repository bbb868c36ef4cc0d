"""Pairwise distances and kernels (counterpart of
``sq_learn_tpu/metrics/pairwise.py``): the slice q-means ``transform``
reads and the kernels of ``QLSSVC`` (reference ``svm/_qSVM.py:375-389``).
A product and elementwise ops on tensors, as the JAX package leaves them
to XLA."""

import torch

from ..ops.linalg import pairwise_sq_distances


def _pair(X, Y):
    return X, (X if Y is None else Y)


def euclidean_distances(X, Y=None, squared=False):
    """Euclidean distances between the rows of X and Y (tensors), by the
    ‖x‖²+‖y‖²−2XYᵀ form clipped at 0."""
    X, Y = _pair(X, Y)
    d2 = pairwise_sq_distances(X, Y)
    return d2 if squared else torch.sqrt(d2)


def linear_kernel(X, Y=None):
    """X·Yᵀ."""
    X, Y = _pair(X, Y)
    return X @ Y.T


def polynomial_kernel(X, Y=None, degree=3, gamma=None, coef0=1.0):
    """(γ·X·Yᵀ + coef0)^degree, γ = 1/m by default."""
    X, Y = _pair(X, Y)
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return (gamma * (X @ Y.T) + coef0) ** degree


def rbf_kernel(X, Y=None, gamma=None):
    """exp(−γ·‖x − y‖²), γ = 1/m by default."""
    X, Y = _pair(X, Y)
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return torch.exp(-gamma * pairwise_sq_distances(X, Y))


def sigmoid_kernel(X, Y=None, gamma=None, coef0=1.0):
    """tanh(γ·X·Yᵀ + coef0), γ = 1/m by default."""
    X, Y = _pair(X, Y)
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return torch.tanh(gamma * (X @ Y.T) + coef0)


KERNELS = {
    "linear": linear_kernel,
    "poly": polynomial_kernel,
    "polynomial": polynomial_kernel,
    "rbf": rbf_kernel,
    "sigmoid": sigmoid_kernel,
}


def pairwise_kernels(X, Y=None, metric="linear", **kwds):
    """The kernel named ``metric`` between the rows of X and Y."""
    try:
        fn = KERNELS[metric]
    except KeyError:
        raise ValueError(
            f"unknown kernel {metric!r}; available: {sorted(set(KERNELS))}"
        ) from None
    return fn(X, Y, **kwds)
