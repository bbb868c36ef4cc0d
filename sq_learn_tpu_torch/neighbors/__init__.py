"""Neighbors — reference-namespace facade (``sklearn/neighbors``): the
names a reference user imports resolve to the port's brute-force search."""

from ..models.neighbors import KNeighborsClassifier, knn_indices

__all__ = ["KNeighborsClassifier", "knn_indices"]
