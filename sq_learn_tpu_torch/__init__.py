"""sq_learn_tpu_torch — the PyTorch/CUDA port of sq_learn_tpu.

The same simulated fault-tolerant-quantum estimators, on PyTorch tensors,
with the JAX package's TPU kernels rewritten by hand for NVIDIA Hopper
(CUDA C++ under ``csrc/``, built at first use). Entry points compute on
``"cuda"`` unless the caller asks for the CPU
(``set_config(device="cpu")``); they never fall back on their own.

The port imports neither JAX nor any module of ``sq_learn_tpu``.
"""

from ._config import config_context, get_config, resolve_device, set_config
from .base import (BaseEstimator, ClassifierMixin, ClusterMixin,
                   NotFittedError, TransformerMixin, check_is_fitted, clone)
from . import feature_extraction, pipeline, preprocessing
from .feature_extraction import FeatureHasher
from .models import (PCA, QLSSVC, QPCA, KMeans, KNeighborsClassifier,
                     MiniBatchKMeans, MiniBatchQKMeans, QKMeans,
                     TruncatedSVD, k_means)
from .pipeline import Pipeline, make_pipeline

__version__ = "0.1.0"

__all__ = ["BaseEstimator", "ClassifierMixin", "ClusterMixin",
           "FeatureHasher", "KMeans", "KNeighborsClassifier",
           "MiniBatchKMeans", "MiniBatchQKMeans", "NotFittedError", "PCA",
           "Pipeline", "QKMeans", "QLSSVC", "QPCA", "TransformerMixin",
           "TruncatedSVD", "check_is_fitted", "clone", "config_context",
           "feature_extraction", "get_config", "k_means", "make_pipeline",
           "pipeline", "preprocessing", "resolve_device", "set_config"]
