"""Datasets made from a seed."""

from ._loaders import (_MNIST_LOW_MARGIN_GRADES, graded_pair_surrogate,
                       load_mnist_surrogate_low_margin, synthetic_surrogate)

__all__ = ["graded_pair_surrogate", "load_mnist_surrogate_low_margin",
           "synthetic_surrogate"]
