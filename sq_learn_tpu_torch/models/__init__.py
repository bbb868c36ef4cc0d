"""Estimators."""

from .qkmeans import KMeans, QKMeans, k_means

__all__ = ["KMeans", "QKMeans", "k_means"]
