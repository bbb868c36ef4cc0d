"""Linear algebra on tensors (counterpart of ``sq_learn_tpu/ops/linalg.py``,
the slice the q-means path reads).

Plain products stay ``torch.matmul``, as the JAX package leaves them to
XLA. On a CUDA device :func:`~sq_learn_tpu_torch._config.resolve_device`
turns TF32 off, so float32 products run in full float32 like the
reference's.
"""

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def row_norms(X, squared=False):
    """Row-wise L2 norms (reference ``extmath.py:49``)."""
    norms = torch.sum(X * X, dim=-1)
    return norms if squared else torch.sqrt(norms)


def check_compute_dtype(value):
    """Validate a ``compute_dtype`` hyperparameter to a dtype name (or
    None). Only float formats make sense: the point is the GEMM precision."""
    if value is None:
        return None
    if isinstance(value, torch.dtype):
        name = str(value).removeprefix("torch.")
    elif isinstance(value, str):
        name = value
    else:
        name = np.dtype(value).name
    if name not in _DTYPES:
        raise ValueError(
            f"compute_dtype must be None or a float dtype "
            f"(bfloat16/float16/float32), got {value!r}")
    return name


def is_reduced(compute_dtype, dtype):
    """True when ``compute_dtype`` actually lowers precision relative to
    ``dtype`` (None or the same dtype is a no-op)."""
    return (compute_dtype is not None
            and _DTYPES[check_compute_dtype(compute_dtype)] != dtype)


def inner_product(X, C, compute_dtype=None):
    """X·Cᵀ (C may carry leading batch dimensions), optionally with both
    operands rounded to a reduced ``compute_dtype`` while the products
    accumulate in X's dtype — the ``preferred_element_type`` contract of
    the reference. The rounded values are exact in X's dtype, so the
    product runs there."""
    if is_reduced(compute_dtype, X.dtype):
        cdt = _DTYPES[check_compute_dtype(compute_dtype)]
        X = X.to(cdt).to(X.dtype)
        C = C.to(cdt).to(X.dtype)
    return torch.matmul(X, C.transpose(-1, -2))


def pairwise_sq_distances(X, C, x_sq_norms=None, compute_dtype=None):
    """Squared Euclidean distances ‖x‖² + ‖c‖² − 2·X·Cᵀ, clipped at 0.

    ``C`` may be (k, m) or a batch (R, k, m); the result is (n, k) or
    (R, n, k). ``compute_dtype`` runs the GEMM in reduced precision (see
    :func:`inner_product`); norms and additions stay in X's dtype.
    """
    if x_sq_norms is None:
        x_sq_norms = row_norms(X, squared=True)
    c_sq = row_norms(C, squared=True)
    d2 = (x_sq_norms[:, None] + c_sq[..., None, :]
          - 2.0 * inner_product(X, C, compute_dtype))
    return torch.clamp(d2, min=0.0)


def smallest_singular_value(X):
    """σ_min via a Gram eigendecomposition (reference ``linalg.py:225``)."""
    n, m = X.shape
    G = X.T @ X if n >= m else X @ X.T
    evals = torch.linalg.eigvalsh(G)
    return torch.sqrt(torch.clamp(evals[0], min=0.0))
