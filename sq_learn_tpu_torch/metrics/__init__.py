"""Metrics."""

from .pairwise import euclidean_distances

__all__ = ["euclidean_distances"]
