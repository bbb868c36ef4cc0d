"""Datasets made from a seed."""

from ._loaders import synthetic_surrogate

__all__ = ["synthetic_surrogate"]
