"""Metrics."""

from .pairwise import (euclidean_distances, linear_kernel, pairwise_kernels,
                       polynomial_kernel, rbf_kernel, sigmoid_kernel)
from .scores import (accuracy_score, adjusted_rand_score, confusion_matrix,
                     explained_variance_ratio, f1_score, inertia,
                     normalized_mutual_info_score, silhouette_score)

__all__ = ["accuracy_score", "adjusted_rand_score", "confusion_matrix",
           "euclidean_distances", "explained_variance_ratio", "f1_score",
           "inertia", "linear_kernel", "normalized_mutual_info_score",
           "pairwise_kernels", "polynomial_kernel", "rbf_kernel",
           "sigmoid_kernel", "silhouette_score"]
