"""Datasets made from a seed, the BASELINE loaders' offline stand-ins and
the CICIDS CSV reader."""

from ._loaders import (_MNIST_LOW_MARGIN_GRADES, Bunch, fetch_covtype,
                       fetch_openml, graded_pair_surrogate, load_cicids,
                       load_covtype, load_digits, load_mnist,
                       load_mnist_surrogate_low_margin, make_blobs,
                       synthetic_surrogate)

__all__ = ["Bunch", "fetch_covtype", "fetch_openml", "graded_pair_surrogate",
           "load_cicids", "load_covtype", "load_digits", "load_mnist",
           "load_mnist_surrogate_low_margin", "make_blobs",
           "synthetic_surrogate"]
