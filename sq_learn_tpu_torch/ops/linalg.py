"""Linear algebra on tensors (counterpart of ``sq_learn_tpu/ops/linalg.py``).

Plain products stay ``torch.matmul``, as the JAX package leaves them to
XLA. On a CUDA device :func:`~sq_learn_tpu_torch._config.resolve_device`
turns TF32 off, so float32 products run in full float32 like the
reference's. Tall-skinny SVDs go through the m×m Gram eigendecomposition
(``torch.linalg.eigh``); randomized SVD follows Halko et al. as in the
reference's ``extmath.py:161-392``.
"""

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def row_norms(X, squared=False):
    """Row-wise L2 norms (reference ``extmath.py:49``)."""
    norms = torch.sum(X * X, dim=-1)
    return norms if squared else torch.sqrt(norms)


def svd_flip(u, v):
    """Sign correction for deterministic SVD output (reference
    ``extmath.py:522``): the largest-|.|-entry of each column of u is made
    positive."""
    max_abs_cols = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u[max_abs_cols, torch.arange(u.shape[1],
                                                    device=u.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs, v * signs[:, None]


def svd_flip_v(u, v):
    """Sign correction from V's rows (sklearn's ``u_based_decision=False``):
    the largest-|.|-entry of each right singular vector is made positive.
    ``u`` may be None or a partial (n, k ≤ r) block; only its first
    ``len(signs)`` columns are flipped."""
    max_abs_rows = torch.argmax(torch.abs(v), dim=1)
    signs = torch.sign(v[torch.arange(v.shape[0], device=v.device),
                         max_abs_rows])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    if u is not None:
        u = u * signs[: u.shape[1]]
    return u, v * signs[:, None]


def symmetric_eigh(G, eigenvectors=True):
    """Ascending eigenvalues (and eigenvectors) of a symmetric matrix, in
    G's dtype. A float32 G is decomposed in float64 and the results
    rounded back: cuSOLVER's float32 ``syevd`` loses the small eigenvalues
    on an H100, which set every spectrum's tail and condition number. On
    the MNIST-shaped surrogate: the 784 × 784 Gram's spectrum 4.1e-4
    relative error against 8.8e-6 in float64 (LAPACK's float32, the JAX
    package's on a CPU: 5.1e-5, ``python tests/test_torch_qpca.py``), its
    κ 1.2e-2 against 4.2e-4 (JAX: 7.5e-3), and QLSSVC's 8 001² saddle
    matrix put a 500-row fit's ``b_`` 3.7e-4 off the CPU's
    (``chip_profile.py``, ``chip_smoke.py``). The products stay in G's
    dtype."""
    Gd = G.to(torch.float64) if G.dtype == torch.float32 else G
    if not eigenvectors:
        return torch.linalg.eigvalsh(Gd).to(G.dtype)
    evals, V = torch.linalg.eigh(Gd)
    return evals.to(G.dtype), V.to(G.dtype)


def gram_spectrum(G):
    """Descending singular spectrum from a Gram matrix: eigh (in float64
    for a float32 Gram, :func:`symmetric_eigh`) → flip → clamped sqrt.
    Returns (S, V, safe) with ``safe`` the zero-guarded divisor for
    recovering the paired factor."""
    evals, V = symmetric_eigh(G)  # ascending
    evals = torch.flip(evals, (0,))
    V = torch.flip(V, (1,))
    S = torch.sqrt(torch.clamp(evals, min=0.0))
    return S, V, torch.where(S > 0, S, torch.ones_like(S))


def thin_svd(X, method="auto"):
    """Thin SVD X = U·diag(S)·Vt with U (n,r), S (r,), Vt (r,m),
    r = min(n,m). 'gram' squares the shorter side, 'direct' calls
    ``torch.linalg.svd``, 'auto' picks 'gram' at an aspect ratio ≥ 8."""
    n, m = X.shape
    if method == "auto":
        method = "gram" if max(n, m) >= 8 * min(n, m) else "direct"
    if method == "direct":
        U, S, Vt = torch.linalg.svd(X, full_matrices=False)
        return U, S, Vt
    if n >= m:
        S, V, safe = gram_spectrum(X.T @ X)
        return (X @ V) / safe[None, :], S, V.T
    S, U, safe = gram_spectrum(X @ X.T)
    return U, S, (U.T @ X) / safe[:, None]


def centered_svd(X, method="auto"):
    """Column-center X and return (mean, U, S, Vt) with V-based signs
    (:func:`svd_flip_v`, the convention every PCA path shares)."""
    mean = torch.mean(X, dim=0)
    U, S, Vt = thin_svd(X - mean, method=method)
    U, Vt = svd_flip_v(U, Vt)
    return mean, U, S, Vt


def centered_svd_topk(X, n_left, compute_dtype=None):
    """Centered Gram-route SVD of a TALL matrix materializing only the
    first ``n_left`` columns of U (the qPCA fit keeps the full spectrum and
    Vt but only U[:, :n_components]). Returns (mean, U block, S, Vt)."""
    mean = torch.mean(X, dim=0)
    Xc = X - mean
    G = inner_product(Xc.T, Xc.T, compute_dtype)  # (m, m)
    S, V, safe = gram_spectrum(G)
    _, Vt = svd_flip_v(None, V.T)
    Uk = inner_product(Xc, Vt[:n_left], compute_dtype) / safe[None, :n_left]
    return mean, Uk, S, Vt


def randomized_svd(generator, X, n_components, n_oversamples=10, n_iter=4,
                   flip=True):
    """Randomized truncated SVD (Halko et al.; reference
    ``extmath.py:246-392``): Gaussian range finder drawn from
    ``generator``, QR-normalized subspace power iterations, exact SVD of
    the small projected matrix."""
    n, m = X.shape
    size = min(n_components + n_oversamples, min(n, m))
    transpose = n < m
    A = X.T if transpose else X  # ensure tall
    Q = torch.randn((A.shape[1], size), generator=generator, dtype=X.dtype,
                    device=X.device)
    Q = A @ Q
    for _ in range(n_iter):
        Q, _ = torch.linalg.qr(A.T @ Q)
        Q = A @ Q
    Q, _ = torch.linalg.qr(Q)
    B = Q.T @ A  # (size, min_dim)
    Uhat, S, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Uhat
    if transpose:
        U, S, Vt = Vt.T, S, U.T
    if flip:
        U, Vt = svd_flip_v(U, Vt)
    return U[:, :n_components], S[:n_components], Vt[:n_components]


def stable_cumsum(arr, axis=None):
    """Cumulative sum accumulated in float64 and cast back to the input
    dtype (reference ``extmath.py:829``); ``axis`` None flattens."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    return torch.cumsum(arr.to(torch.float64), dim=axis).to(arr.dtype)


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


def smallest_eigenvalue(G):
    """λ_min of a symmetric matrix, in G's dtype (:func:`symmetric_eigh`:
    float64 for a float32 G)."""
    return symmetric_eigh(G, eigenvectors=False)[0]


def smallest_singular_value(X):
    """σ_min via a Gram eigendecomposition (reference ``linalg.py:225``):
    the Gram is formed in X's dtype, its λ_min found by
    :func:`smallest_eigenvalue`."""
    n, m = X.shape
    G = X.T @ X if n >= m else X @ X.T
    return torch.sqrt(torch.clamp(smallest_eigenvalue(G), min=0.0))
