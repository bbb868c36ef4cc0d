"""Estimators."""

from .minibatch import MiniBatchKMeans, MiniBatchQKMeans
from .neighbors import KNeighborsClassifier, knn_indices
from .qkmeans import KMeans, QKMeans, k_means, kmeans_plusplus, lloyd_single
from .qlssvc import QLSSVC
from .qpca import PCA, QPCA
from .truncated_svd import TruncatedSVD

__all__ = ["KMeans", "KNeighborsClassifier", "MiniBatchKMeans",
           "MiniBatchQKMeans", "PCA", "QKMeans", "QLSSVC", "QPCA",
           "TruncatedSVD", "k_means", "kmeans_plusplus", "knn_indices",
           "lloyd_single"]
