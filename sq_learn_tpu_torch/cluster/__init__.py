"""Clustering — reference-namespace facade (``sklearn/cluster``): the
names a reference user imports resolve to the port's implementations."""

from ..models.minibatch import MiniBatchKMeans, MiniBatchQKMeans
from ..models.qkmeans import KMeans, QKMeans, k_means

# the reference's class name (``_dmeans.py:833``)
qMeans_ = QKMeans

__all__ = ["KMeans", "MiniBatchKMeans", "MiniBatchQKMeans", "QKMeans",
           "qMeans_", "k_means"]
