"""Estimators."""

from .neighbors import KNeighborsClassifier, knn_indices
from .qkmeans import KMeans, QKMeans, k_means

__all__ = ["KMeans", "KNeighborsClassifier", "QKMeans", "k_means",
           "knn_indices"]
