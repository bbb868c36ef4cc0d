"""Clustering and classification scores (counterpart of
``sq_learn_tpu/metrics/scores.py``).

Label metrics are integer bookkeeping on the host, in numpy with exact
int64 counts. The metrics over data (``inertia``, ``silhouette_score``,
``explained_variance_ratio``) run in torch, on the device of a tensor
argument or, for array input, on the configured device (the card unless
the caller asks for the CPU). Each takes numpy arrays, lists or tensors.
"""

import numpy as np
import torch

from .._config import resolve_device
from ..utils.validation import to_numpy as _host


def _tensor(a, device=None):
    """``a`` as a float tensor: a tensor stays where it is (or moves to
    ``device``), anything else becomes float32 on ``device``, by default
    the configured one."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=resolve_device(device))


def accuracy_score(y_true, y_pred):
    """Fraction of exact label matches, in float32."""
    hits = _host(y_true) == _host(y_pred)
    return float(np.mean(hits.astype(np.float32), dtype=np.float32))


def _contingency(labels_true, labels_pred):
    """Dense contingency table — exact int64 bincount (a float32 count
    stops being exact at 2^24)."""
    _, ti = np.unique(_host(labels_true), return_inverse=True)
    _, pi = np.unique(_host(labels_pred), return_inverse=True)
    ti, pi = ti.ravel(), pi.ravel()
    n_t = int(ti.max()) + 1
    n_p = int(pi.max()) + 1
    return np.bincount(n_p * ti + pi, minlength=n_t * n_p).reshape(n_t, n_p)


def adjusted_rand_score(labels_true, labels_pred):
    """Adjusted Rand Index (reference ``metrics/cluster/_supervised.py:302``):
    ARI = (RI − E[RI]) / (max(RI) − E[RI]) from the contingency table's
    pair counts, in float64."""
    c = _contingency(labels_true, labels_pred).astype(np.float64)
    n = c.sum()
    sum_comb_c = np.sum(c * (c - 1)) / 2.0
    a, b = c.sum(axis=1), c.sum(axis=0)
    sum_comb_a = np.sum(a * (a - 1)) / 2.0
    sum_comb_b = np.sum(b * (b - 1)) / 2.0
    total = n * (n - 1) / 2.0
    expected = sum_comb_a * sum_comb_b / total if total > 0 else 0.0
    denom = (sum_comb_a + sum_comb_b) / 2.0 - expected
    return 1.0 if denom == 0 else float((sum_comb_c - expected) / denom)


def inertia(X, centers, labels):
    """Sum of squared distances of samples to their assigned center."""
    X = _tensor(X)
    centers = _tensor(centers, X.device)
    labels = torch.as_tensor(_host(labels), dtype=torch.int64,
                             device=X.device)
    diffs = X - centers[labels]
    return float(torch.sum(diffs * diffs))


def explained_variance_ratio(singular_values, n_samples, total_variance=None):
    """Per-component explained-variance ratios from singular values
    (reference ``_qPCA.py:589-591``); a tensor for tensor input, else a
    numpy array."""
    sv = _tensor(singular_values)
    ev = sv ** 2 / (n_samples - 1)
    total = torch.sum(ev) if total_variance is None else total_variance
    out = ev / total
    return (out if isinstance(singular_values, torch.Tensor)
            else out.cpu().numpy())


def normalized_mutual_info_score(labels_true, labels_pred):
    """NMI with arithmetic-mean normalization, host-side float64."""
    c = _contingency(labels_true, labels_pred).astype(np.float64)
    n = c.sum()
    pi = c.sum(axis=1)
    pj = c.sum(axis=0)
    outer = pi[:, None] * pj[None, :]
    nz = c > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        mi = np.sum(np.where(nz, (c / n) * np.log((c * n)
                                                  / np.where(nz, outer, 1.0)),
                             0.0))

    def entropy(p):
        p = p[p > 0] / n
        return -np.sum(p * np.log(p))

    denom = (entropy(pi) + entropy(pj)) / 2
    return float(mi / denom) if denom > 0 else 1.0


def _joint_classes(y_true, y_pred):
    """(classes, encoded y_true, encoded y_pred) over the sorted union of
    the observed labels."""
    y_true, y_pred = _host(y_true).ravel(), _host(y_pred).ravel()
    classes, inv = np.unique(np.concatenate([y_true, y_pred]),
                             return_inverse=True)
    inv = inv.ravel()
    return classes, inv[:len(y_true)], inv[len(y_true):]


def confusion_matrix(y_true, y_pred):
    """Dense confusion matrix over the sorted union of observed labels
    (sklearn semantics — negative labels included), exact int64 counts."""
    classes, yt, yp = _joint_classes(y_true, y_pred)
    k = len(classes)
    return np.bincount(k * yt + yp, minlength=k * k).reshape(k, k)


def f1_score(y_true, y_pred, average="binary", pos_label=1):
    """F1 = 2·P·R/(P+R); ``average`` ∈ {'binary', 'macro', 'micro',
    'weighted'}. Binary mode scores ``pos_label``; 'weighted' weights the
    per-class F1 by true-class support (sklearn semantics)."""
    classes, yt, yp = _joint_classes(y_true, y_pred)
    k = len(classes)
    C = np.bincount(k * yt + yp, minlength=k * k).reshape(k, k).astype(
        np.float64)
    tp = np.diag(C)
    fp = C.sum(axis=0) - tp
    fn = C.sum(axis=1) - tp
    if average == "micro":
        p = tp.sum() / max(tp.sum() + fp.sum(), 1e-12)
        r = tp.sum() / max(tp.sum() + fn.sum(), 1e-12)
        return float(2 * p * r / max(p + r, 1e-12))
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        r = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(p + r > 0, 2 * p * r / (p + r), 0.0)
    if average == "macro":
        return float(f1.mean())
    if average == "weighted":
        support = C.sum(axis=1)
        total = support.sum()
        return 0.0 if total == 0 else float((f1 * support).sum() / total)
    if average == "binary":
        where = np.flatnonzero(classes == pos_label)
        if len(where) == 0:
            raise ValueError(
                f"pos_label={pos_label!r} is not a valid label; observed "
                f"labels are {classes.tolist()}")
        return float(f1[where[0]])
    raise ValueError(f"unknown average {average!r}")


def silhouette_score(X, labels, sample_size=None, random_state=0):
    """Mean silhouette coefficient over the full (or subsampled) pairwise
    distance matrix."""
    from .pairwise import euclidean_distances

    labels = _host(labels)
    if sample_size is not None and sample_size < len(labels):
        rng = np.random.default_rng(random_state)
        idx = rng.choice(len(labels), sample_size, replace=False)
        if isinstance(X, torch.Tensor):
            X = X[torch.as_tensor(idx, device=X.device)]
        else:
            X = np.asarray(X)[idx]
        labels = labels[idx]
    X = _tensor(X)
    classes, y = np.unique(labels, return_inverse=True)
    if len(classes) < 2 or len(classes) >= X.shape[0]:
        raise ValueError(
            "silhouette requires 2 <= n_labels <= n_samples - 1")
    D = euclidean_distances(X, X)
    y = torch.as_tensor(y.ravel(), device=X.device)
    onehot = torch.nn.functional.one_hot(y, len(classes)).to(D.dtype)
    counts = onehot.sum(dim=0)                       # (k,)
    sums = D @ onehot                                # (n, k)
    own = counts[y]
    rows = torch.arange(len(y), device=X.device)
    # a: mean intra-cluster distance excluding self; singletons get a=0
    a = torch.where(own > 1, sums[rows, y] / torch.clamp(own - 1, min=1),
                    torch.zeros_like(own))
    other = torch.where(onehot > 0, torch.full_like(sums, torch.inf),
                        sums / counts[None, :])
    b = other.min(dim=1).values
    s = torch.where(own > 1, (b - a) / torch.clamp(torch.maximum(a, b),
                                                   min=1e-12),
                    torch.zeros_like(own))
    return float(torch.mean(s))
