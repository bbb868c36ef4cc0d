"""Tensor operations and the port's hand-written kernels."""

from . import linalg, quantum
from .linalg import (centered_svd, pairwise_sq_distances, randomized_svd,
                     row_norms, smallest_singular_value, stable_cumsum,
                     svd_flip, thin_svd)

__all__ = ["linalg", "quantum", "centered_svd", "pairwise_sq_distances",
           "randomized_svd", "row_norms", "smallest_singular_value",
           "stable_cumsum", "svd_flip", "thin_svd"]
