"""sq_learn_tpu_torch — the PyTorch/CUDA port of sq_learn_tpu.

The same simulated fault-tolerant-quantum estimators, on PyTorch tensors,
with the JAX package's TPU kernels rewritten by hand for NVIDIA Hopper
(CUDA C++ under ``csrc/``, built at first use). Entry points compute on
``"cuda"`` unless the caller asks for the CPU
(``set_config(device="cpu")``); they never fall back on their own.

The port imports neither JAX nor any module of ``sq_learn_tpu``. Importing
the package loads only :mod:`.obs` (standard library only, so that
``python -m sq_learn_tpu_torch.obs`` reads an artifact without torch);
the names below and every subpackage (the streaming engine and
``resilience`` among them) load on first use.
"""

import importlib
import importlib.util

from . import obs  # first: the estimators instrument through it

__version__ = "0.1.0"

#: the package's names, by the module that defines them
_EXPORTS = {
    "._config": ("config_context", "default_dtype", "get_config",
                 "resolve_device", "set_config"),
    ".base": ("BaseEstimator", "ClassifierMixin", "ClusterMixin",
              "NotFittedError", "TransformerMixin", "check_is_fitted",
              "clone"),
    ".feature_extraction": ("FeatureHasher",),
    ".models": ("PCA", "QLSSVC", "QPCA", "KMeans", "KNeighborsClassifier",
                "MiniBatchKMeans", "MiniBatchQKMeans", "QKMeans",
                "TruncatedSVD", "k_means"),
    ".pipeline": ("Pipeline", "make_pipeline"),
    ".utils.checkpoint": ("load_estimator", "save_estimator"),
    ".utils._show_versions": ("show_versions",),
}
_ORIGIN = {name: module for module, names in _EXPORTS.items()
           for name in names}

#: the subpackages and modules, each loaded on first use
_SUBMODULES = ("QuantumUtility", "cluster", "datasets", "decomposition",
               "feature_extraction", "metrics", "model_selection", "models",
               "neighbors", "obs", "ops", "parallel", "pipeline",
               "preprocessing", "resilience", "serving", "streaming", "svm",
               "utils")

__all__ = sorted([*_ORIGIN, *_SUBMODULES])


def __getattr__(name):
    """Load an exported name, or a subpackage, on first use."""
    if name in _ORIGIN:
        value = getattr(importlib.import_module(_ORIGIN[name], __name__),
                        name)
    elif not name.startswith("__") and importlib.util.find_spec(
            f"{__name__}.{name}") is not None:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted({*globals(), *__all__})
