"""Carry fitted state from the JAX package into the port.

:func:`qkmeans_from_numpy` takes a fitted JAX ``QKMeans``'s attributes as
numpy arrays and returns a fitted port :class:`~.models.QKMeans` whose
``predict``, ``transform`` and ``score`` compute what the JAX ones do;
:func:`kneighbors_from_numpy` does the same for ``KNeighborsClassifier``,
:func:`qpca_from_numpy` for ``QPCA`` (classical and quantum transforms,
the runtime model) and :func:`qlssvc_from_numpy` for ``QLSSVC``.
The port imports nothing of the JAX package: the caller reads the
attributes (``vars(est)``) and hands them over.
"""

import numpy as np
import torch

from ._config import resolve_device
from .models.neighbors import KNeighborsClassifier
from .models.qkmeans import QKMeans
from .models.qlssvc import QLSSVC
from .models.qpca import QPCA
from .ops.linalg import row_norms

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
    names = set(QKMeans._get_param_names())
    kw = {k: v for k, v in (params or {}).items() if k in names}
    kw["n_clusters"] = centers.shape[0]
    kw["device"] = device
    est = QKMeans(**kw)
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
    names = set(KNeighborsClassifier._get_param_names())
    kw = {k: v for k, v in (params or {}).items() if k in names}
    kw["device"] = device
    est = KNeighborsClassifier(**kw)
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
    names = set(QPCA._get_param_names())
    kw = {k: v for k, v in (params or {}).items() if k in names}
    kw["device"] = device
    est = QPCA(**kw)
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
    names = set(QLSSVC._get_param_names())
    kw = {k: v for k, v in (params or {}).items() if k in names}
    kw["device"] = device
    est = QLSSVC(**kw)
    est.X_ = torch.tensor(X, device=resolve_device(device))
    for name, dtype in _QLSSVC_ARRAYS.items():
        if attrs.get(name) is not None:
            setattr(est, name, np.asarray(attrs[name], dtype))
    for name, cast in _QLSSVC_SCALARS.items():
        if attrs.get(name) is not None:
            setattr(est, name, cast(attrs[name]))
    est.n_features_in_ = X.shape[1]
    return est
