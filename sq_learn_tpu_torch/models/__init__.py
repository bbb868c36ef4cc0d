"""Estimators."""

from .neighbors import KNeighborsClassifier, knn_indices
from .qkmeans import KMeans, QKMeans, k_means
from .qlssvc import QLSSVC
from .qpca import PCA, QPCA

__all__ = ["KMeans", "KNeighborsClassifier", "PCA", "QKMeans", "QLSSVC",
           "QPCA", "k_means", "knn_indices"]
