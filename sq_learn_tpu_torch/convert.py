"""Carry fitted state from the JAX package into the port.

:func:`qkmeans_from_numpy` takes a fitted JAX ``QKMeans``'s attributes as
numpy arrays and returns a fitted port :class:`~.models.QKMeans` whose
``predict``, ``transform`` and ``score`` compute what the JAX ones do;
:func:`kneighbors_from_numpy` does the same for ``KNeighborsClassifier``,
:func:`qpca_from_numpy` for ``QPCA`` (classical and quantum transforms,
the runtime model), :func:`qlssvc_from_numpy` for ``QLSSVC``,
:func:`minibatch_from_numpy` for ``MiniBatchQKMeans``/``MiniBatchKMeans``,
:func:`truncated_svd_from_numpy` for ``TruncatedSVD`` and
:func:`scaler_from_numpy` for each of the three scalers.
The port imports nothing of the JAX package: the caller reads the
attributes (``vars(est)``) and hands them over.
"""

import numpy as np
import torch

from . import preprocessing
from ._config import resolve_device
from .models.minibatch import MiniBatchKMeans, MiniBatchQKMeans
from .models.neighbors import KNeighborsClassifier
from .models.qkmeans import QKMeans
from .models.qlssvc import QLSSVC
from .models.qpca import QPCA
from .models.truncated_svd import TruncatedSVD
from .ops.linalg import row_norms

def _unfitted(cls, params, device, **fixed):
    """An unfitted ``cls`` on ``device`` from the hyperparameters in
    ``params`` that it has (the JAX estimator's ``get_params()``; the
    others, such as ``use_pallas``, are dropped), ``fixed`` on top."""
    names = set(cls._get_param_names())
    kw = {k: v for k, v in (params or {}).items() if k in names}
    kw.update(fixed, device=device)
    return cls(**kw)


def _set_attrs(est, attrs, arrays, scalars):
    """Copy the fitted arrays (as the given dtypes) and scalars (through
    the given casts) that ``attrs`` holds and that are not None."""
    for name, dtype in arrays.items():
        if attrs.get(name) is not None:
            setattr(est, name, np.array(attrs[name], dtype))
    for name, cast in scalars.items():
        if attrs.get(name) is not None:
            setattr(est, name, cast(attrs[name]))


#: fitted attributes carried over, with the type each is stored as
_ARRAYS = {"cluster_centers_": np.float32, "labels_": np.int32,
           "inertia_history_": None, "center_shift_history_": None}
_SCALARS = {"inertia_": float, "n_iter_": int, "n_features_in_": int,
            "eta_": float, "mu_": float, "condition_number_": float}


def qkmeans_from_numpy(attrs, device=None, params=None):
    """A fitted port ``QKMeans`` from a JAX ``QKMeans``'s fitted state.

    Parameters
    ----------
    attrs : dict
        Fitted attributes: ``cluster_centers_`` (required), ``labels_``,
        ``inertia_``, ``n_iter_``, ``n_features_in_``, the history arrays
        and the quantum statistics (``eta_``, ``mu_``, ``norm_mu_``,
        ``condition_number_``, ``sketch_info_``). Other keys are ignored.
    device : str or torch.device, optional
        Where the estimator's inference runs (None = the configured
        device).
    params : dict, optional
        Hyperparameters (for example the JAX estimator's ``get_params()``);
        those the port does not have (``use_pallas``) are dropped.
    """
    if "cluster_centers_" not in attrs:
        raise ValueError("attrs must hold the fitted cluster_centers_")
    centers = np.asarray(attrs["cluster_centers_"], np.float32)
    if centers.ndim != 2:
        raise ValueError(f"cluster_centers_ must be 2-D, got shape "
                         f"{centers.shape}")
    est = _unfitted(QKMeans, params, device, n_clusters=centers.shape[0])
    for name, dtype in _ARRAYS.items():
        if name in attrs:
            value = np.asarray(attrs[name])
            setattr(est, name, value.astype(dtype) if dtype else value)
    for name, cast in _SCALARS.items():
        if name in attrs:
            setattr(est, name, cast(attrs[name]))
    for name in ("norm_mu_", "sketch_info_"):
        if name in attrs:
            setattr(est, name, attrs[name])
    width = getattr(est, "n_features_in_", centers.shape[1])
    if width != centers.shape[1]:
        raise ValueError(
            f"n_features_in_={width} does not match cluster_centers_ of "
            f"width {centers.shape[1]}")
    est.n_features_in_ = centers.shape[1]
    return est


def kneighbors_from_numpy(attrs, device=None, params=None):
    """A fitted port ``KNeighborsClassifier`` from a JAX one's fitted state.

    Parameters
    ----------
    attrs : dict
        Fitted attributes as arrays: ``X_fit_`` (n, m), ``y_fit_`` (n,)
        (the encoded labels), ``classes_``, and optionally
        ``n_samples_fit_`` and ``n_features_in_``, which must agree with
        ``X_fit_``. Other keys are ignored.
    device : str or torch.device, optional
        Where the training rows are kept and every search runs (None = the
        configured device).
    params : dict, optional
        Hyperparameters (for example the JAX estimator's ``get_params()``);
        those the port does not have (``use_pallas``) are dropped.
    """
    missing = [a for a in ("X_fit_", "y_fit_", "classes_") if a not in attrs]
    if missing:
        raise ValueError(f"attrs must hold the fitted {', '.join(missing)}")
    X = np.asarray(attrs["X_fit_"], np.float32)
    y = np.asarray(attrs["y_fit_"]).astype(np.int32)
    classes = np.asarray(attrs["classes_"])
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X_fit_ (n, m) and y_fit_ (n,) do not match: "
                         f"{X.shape} and {y.shape}")
    if len(y) and not 0 <= y.min() <= y.max() < len(classes):
        raise ValueError("y_fit_ must index classes_")
    for name, value in (("n_samples_fit_", X.shape[0]),
                        ("n_features_in_", X.shape[1])):
        if int(attrs.get(name, value)) != value:
            raise ValueError(f"{name}={attrs[name]} does not match X_fit_ "
                             f"of shape {X.shape}")
    est = _unfitted(KNeighborsClassifier, params, device)
    est.X_fit_ = torch.tensor(X, device=resolve_device(device))
    est.y_fit_ = y
    est.classes_ = classes
    est.n_samples_fit_, est.n_features_in_ = X.shape
    est._x_sq_fit = row_norms(est.X_fit_, squared=True)
    return est


#: fitted QPCA arrays carried over (float32, as the JAX package keeps them)
_QPCA_ARRAYS = ("mean_", "components_", "all_components",
                "explained_variance_", "explained_variance_ratio_",
                "explained_variance_all", "explained_variance_ratio_all",
                "singular_values_", "all_singular_values_", "left_sv",
                "estimate_right_sv", "estimate_left_sv",
                "estimate_s_values", "estimate_fs", "estimate_fs_ratio")
_QPCA_SCALARS = {"n_components_": int, "noise_variance_": float,
                 "n_features_in_": int, "n_samples_": int,
                 "n_features_": int, "spectral_norm": float,
                 "frob_norm": float}
#: the fit's quantum parameters, flags and selections, which the runtime
#: model reads (``accumulate_q_runtime``)
_QPCA_FIT_STATE = ("eps", "delta", "eps_theta", "eta", "theta_major",
                   "theta_minor", "theta", "est_theta", "topk", "topk_p",
                   "least_k", "least_k_p", "tomography_norm",
                   "theta_estimate", "quantum_retained_variance",
                   "estimate_all", "estimate_least_k")


def _host_value(v):
    """A numpy or 0-d array scalar as a Python number; anything else as
    it is."""
    if isinstance(v, np.generic) or (isinstance(v, np.ndarray)
                                     and v.ndim == 0):
        return v.item()
    return v


def qpca_from_numpy(attrs, device=None, params=None):
    """A fitted port ``QPCA`` from a JAX ``QPCA``'s fitted state.

    Parameters
    ----------
    attrs : dict
        Fitted attributes (for example ``vars(est)`` of the JAX
        estimator): ``mean_`` and ``components_`` (required), the spectra
        (``explained_variance_(ratio_)``, ``singular_values_``,
        ``all_components``, the ``*_all`` arrays), ``left_sv``,
        ``muA``/``norm_muA``, where present the top-k estimates
        ``estimate_right_sv``/``estimate_left_sv``/``estimate_s_values``/
        ``estimate_fs`` (and ``estimate_fs_ratio``), ``n_components_``,
        ``noise_variance_``, and the fit's quantum parameters, flags and
        selections that the runtime model reads (``eps``, ``delta``,
        ``eps_theta``, ``eta``, ``theta``/``est_theta``, ``topk``,
        ``topk_p``, ``least_k``, ``least_k_p``, ``theta_minor``,
        ``spectral_norm``, ``tomography_norm``, the estimator flags).
        Other keys are ignored.
    device : str or torch.device, optional
        Where the estimator's transforms run (None = the configured
        device).
    params : dict, optional
        Hyperparameters (for example the JAX estimator's ``get_params()``);
        those the port does not have are dropped, and ``mesh`` must be
        None.
    """
    missing = [a for a in ("mean_", "components_") if a not in attrs]
    if missing:
        raise ValueError(f"attrs must hold the fitted {', '.join(missing)}")
    est = _unfitted(QPCA, params, device)
    for name in _QPCA_ARRAYS:
        if attrs.get(name) is not None:
            setattr(est, name, np.asarray(attrs[name], np.float32))
    for name, cast in _QPCA_SCALARS.items():
        if attrs.get(name) is not None:
            setattr(est, name, cast(attrs[name]))
    for name in ("muA", "norm_muA") + _QPCA_FIT_STATE:
        if name in attrs:
            setattr(est, name, _host_value(attrs[name]))
    comps, mean = est.components_, est.mean_
    if comps.ndim != 2 or mean.shape != (comps.shape[1],):
        raise ValueError(f"components_ (k, m) and mean_ (m,) do not match: "
                         f"{comps.shape} and {mean.shape}")
    if getattr(est, "n_components_", comps.shape[0]) != comps.shape[0]:
        raise ValueError(f"n_components_={est.n_components_} does not match "
                         f"components_ of shape {comps.shape}")
    est.n_components_ = comps.shape[0]
    if getattr(est, "n_features_in_", comps.shape[1]) != comps.shape[1]:
        raise ValueError(f"n_features_in_={est.n_features_in_} does not "
                         f"match components_ of width {comps.shape[1]}")
    est.n_features_in_ = comps.shape[1]
    right = getattr(est, "estimate_right_sv", None)
    if right is not None and (right.ndim != 2
                              or right.shape[1] != comps.shape[1]):
        raise ValueError(f"estimate_right_sv of shape {right.shape} does "
                         f"not match components_ of width {comps.shape[1]}")
    return est


#: fitted QLSSVC attributes carried over, with the type each is stored as
_QLSSVC_ARRAYS = {"alpha_": np.float32, "singular_values_F_": np.float32,
                  "coef_": np.float32}
_QLSSVC_SCALARS = {"b_": float, "Nu_": float, "alpha_F_": float,
                   "cond_": float, "normF_": float, "n_features_in_": int}


def qlssvc_from_numpy(attrs, device=None, params=None):
    """A fitted port ``QLSSVC`` from a JAX ``QLSSVC``'s fitted state.

    Parameters
    ----------
    attrs : dict
        Fitted attributes (for example ``vars(est)`` of the JAX
        estimator): ``X_`` (N, m) and ``alpha_`` (N,) (required), ``b_``,
        ``Nu_``, ``alpha_F_``, ``cond_``, ``normF_``,
        ``singular_values_F_``, ``coef_`` and ``n_features_in_``. Other
        keys are ignored.
    device : str or torch.device, optional
        Where the training rows are kept and inference runs (None = the
        configured device).
    params : dict, optional
        Hyperparameters (for example the JAX estimator's ``get_params()``);
        those the port does not have are dropped.
    """
    missing = [a for a in ("X_", "alpha_") if a not in attrs]
    if missing:
        raise ValueError(f"attrs must hold the fitted {', '.join(missing)}")
    X = np.asarray(attrs["X_"], np.float32)
    alpha = np.asarray(attrs["alpha_"])
    if X.ndim != 2 or alpha.shape != (X.shape[0],):
        raise ValueError(f"X_ (N, m) and alpha_ (N,) do not match: "
                         f"{X.shape} and {alpha.shape}")
    if int(attrs.get("n_features_in_", X.shape[1])) != X.shape[1]:
        raise ValueError(f"n_features_in_={attrs['n_features_in_']} does "
                         f"not match X_ of shape {X.shape}")
    est = _unfitted(QLSSVC, params, device)
    est.X_ = torch.tensor(X, device=resolve_device(device))
    _set_attrs(est, attrs, _QLSSVC_ARRAYS, _QLSSVC_SCALARS)
    est.n_features_in_ = X.shape[1]
    return est


def _check_width(est, width, what):
    if int(getattr(est, "n_features_in_", width)) != width:
        raise ValueError(f"n_features_in_={est.n_features_in_} does not "
                         f"match {what} of width {width}")
    est.n_features_in_ = width


#: fitted mini-batch attributes carried over, with their types
_MINIBATCH_ARRAYS = {"cluster_centers_": np.float32, "counts_": np.float32,
                     "labels_": np.int32}
_MINIBATCH_SCALARS = {"inertia_": float, "n_iter_": int, "n_steps_": int,
                      "n_features_in_": int}


def minibatch_from_numpy(attrs, device=None, params=None):
    """A fitted port ``MiniBatchQKMeans`` (a ``MiniBatchKMeans`` when
    ``params`` has no ``delta``, as that class's ``get_params()`` has
    not) from a JAX one's fitted state: ``cluster_centers_`` and
    ``counts_`` (required), ``labels_``, ``inertia_``, ``n_iter_``,
    ``n_steps_`` and ``n_features_in_``. ``predict``, ``transform``,
    ``score`` and further ``partial_fit`` calls go on from that state."""
    missing = [a for a in ("cluster_centers_", "counts_") if a not in attrs]
    if missing:
        raise ValueError(f"attrs must hold the fitted {', '.join(missing)}")
    est = _unfitted(MiniBatchQKMeans if params is None or "delta" in params
                    else MiniBatchKMeans, params, device)
    _set_attrs(est, attrs, _MINIBATCH_ARRAYS, _MINIBATCH_SCALARS)
    centers, counts = est.cluster_centers_, est.counts_
    if centers.ndim != 2 or counts.shape != (centers.shape[0],):
        raise ValueError(f"cluster_centers_ (k, m) and counts_ (k,) do not "
                         f"match: {centers.shape} and {counts.shape}")
    est.n_clusters = centers.shape[0]
    _check_width(est, centers.shape[1], "cluster_centers_")
    return est


_SVD_ARRAYS = {"components_": np.float32, "singular_values_": np.float32,
               "explained_variance_": np.float32,
               "explained_variance_ratio_": np.float32}


def truncated_svd_from_numpy(attrs, device=None, params=None):
    """A fitted port ``TruncatedSVD`` from a JAX one's fitted state:
    ``components_`` (required), ``singular_values_``,
    ``explained_variance_(ratio_)`` and ``n_features_in_``."""
    if "components_" not in attrs:
        raise ValueError("attrs must hold the fitted components_")
    est = _unfitted(TruncatedSVD, params, device)
    _set_attrs(est, attrs, _SVD_ARRAYS, {"n_features_in_": int})
    comps = est.components_
    if comps.ndim != 2:
        raise ValueError(f"components_ must be 2-D, got shape "
                         f"{comps.shape}")
    est.n_components = comps.shape[0]
    _check_width(est, comps.shape[1], "components_")
    return est


#: each scaler's fitted arrays, the required one (which sets the width)
#: first; a Normalizer carries only its width
_SCALER_ARRAYS = {
    "StandardScaler": ("scale_", "mean_", "var_"),
    "MinMaxScaler": ("scale_", "min_", "data_min_", "data_max_"),
    "Normalizer": (),
}


def scaler_from_numpy(attrs, scaler="StandardScaler", device=None,
                      params=None):
    """A fitted port scaler from a JAX scaler's fitted state; ``scaler``
    names its class (``type(est).__name__``): ``"StandardScaler"``
    (``mean_``, ``scale_``, ``var_``, ``n_samples_seen_``),
    ``"MinMaxScaler"`` (``data_min_``, ``data_max_``, ``scale_``,
    ``min_``) or ``"Normalizer"`` (``n_features_in_``). Arrays keep their
    dtype; ``transform`` then computes on ``device``."""
    if scaler not in _SCALER_ARRAYS:
        raise ValueError(f"scaler must be one of {sorted(_SCALER_ARRAYS)}, "
                         f"got {scaler!r}")
    arrays = _SCALER_ARRAYS[scaler]
    required = arrays[0] if arrays else "n_features_in_"
    if required not in attrs:
        raise ValueError(f"attrs must hold the fitted {required}")
    est = _unfitted(getattr(preprocessing, scaler), params, device)
    for name in arrays:
        value = attrs.get(name)
        setattr(est, name, None if value is None else np.array(value))
    _set_attrs(est, attrs, {}, {"n_samples_seen_": int,
                                "n_features_in_": int})
    _check_width(est, len(est.scale_) if arrays else est.n_features_in_,
                 required)
    return est
