"""The comparisons that decide ``correct``, in float64, in blocks of rows.

q-means (one fitted estimator: labels, centers, inertia, at window δ):

- ``rows_missing``: rows without a label in 0..k-1, plus rows the labels
  lack or add. Exact: limit 0.
- ``labels_outside``: rows whose label lies farther than its nearest
  center plus δ by more than a thousandth of the mean squared norm of the
  centered rows: a gross violation of the δ-window, which no rounding
  explains. Exact: limit 0.
- ``window_excess``: the largest amount by which a row's label lies
  farther than its nearest center plus δ, in squared distance, over the
  mean squared norm of the centered rows (the scale the float32 products
  round at).
- ``inertia_gap``: |reported inertia − I| / I, where I is, in float64, Σ
  nearest squared distance at the reported centers or, with ``settled``
  (a fit at the smallest δ of its mix, which should have converged), after
  one exact Lloyd step from them: so it also reads how far the centers
  are from a fixed point.
- ``optimum_gap`` (with ``reference_inertia``, which ``readings.py`` asks
  for; no run compares it): (I − I_ref) / I_ref, with I the float64 Σ
  nearest squared distance at the reported centers and I_ref that of the
  plain float64 reference's best of as many restarts, fitted at the same
  δ: how far the fit's optimum lies above an independent fit's.

k-NN (one predict: the labels, and the neighbour lists the search gave):

- ``rows_missing``: queries without a label, or labels the answer adds.
- ``neighbor_gap``: the largest excess of a returned neighbour's exact
  squared distance over the exact j-th smallest, rank by rank, over the
  mean squared norm of the training rows; inf for an index out of range
  or repeated.
- ``vote_mismatch``: labels that differ from the uniform vote of the
  returned neighbours (ties to the lowest class).
"""

import numpy as np
import torch

#: rows of a block, so that a float64 block stays a few hundred MB
BLOCK_ROWS = 1 << 17


def data_scales(X):
    """(mean squared norm of the centered rows, column means) of X, in
    float64."""
    n = X.shape[0]
    mean = torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    for r0 in range(0, n, BLOCK_ROWS):
        mean += X[r0:r0 + BLOCK_ROWS].double().sum(dim=0)
    mean /= n
    ss = torch.zeros_like(mean)
    for r0 in range(0, n, BLOCK_ROWS):
        d = X[r0:r0 + BLOCK_ROWS].double() - mean
        ss += (d * d).sum(dim=0)
    return float(ss.sum()) / n, mean


def _qkmeans_pass(X, labels, Cc, mean, delta, sq_norm):
    """One float64 pass over the rows at centered centers ``Cc``: (largest
    window excess, gross window violations, Σ nearest squared distance,
    per-cluster sums and counts of the rows by their nearest center)."""
    n = X.shape[0]
    k = Cc.shape[0]
    csq = (Cc * Cc).sum(dim=1)
    excess, outside, inertia = 0.0, 0, 0.0
    sums = torch.zeros_like(Cc)
    counts = torch.zeros(k, dtype=torch.float64, device=X.device)
    for r0 in range(0, n, BLOCK_ROWS):
        x = X[r0:r0 + BLOCK_ROWS].double() - mean
        d2 = (x * x).sum(dim=1, keepdim=True) + csq - 2.0 * (x @ Cc.T)
        nearest, near_idx = d2.min(dim=1)
        if labels is not None:
            lab = labels[r0:r0 + BLOCK_ROWS]
            over = d2.gather(1, lab[:, None])[:, 0] - nearest - delta
            excess = max(excess, float(over.max()))
            outside += int((over > 1e-3 * sq_norm).sum())
        inertia += float(nearest.sum())
        sums.index_add_(0, near_idx, x)
        counts += torch.bincount(near_idx, minlength=k).double()
    return excess, outside, inertia, sums, counts


def qkmeans(X, fit, delta, scales, settled=False, reference_inertia=None):
    """The q-means numbers of one fit (see the module docstring). ``fit``
    = {"labels": (n,) ints, "centers": (k, m), "inertia": float};
    ``scales`` = :func:`data_scales` of X."""
    n, m = X.shape
    sq_norm, mean = scales
    labels = torch.as_tensor(np.asarray(fit["labels"]), device=X.device)
    C = torch.as_tensor(np.asarray(fit["centers"]), device=X.device).double()
    k = C.shape[0]
    failed = {"labels_outside": np.inf, "window_excess": np.inf,
              "inertia_gap": np.inf}
    bad = abs(n - labels.shape[0]) if labels.ndim == 1 else n
    if labels.ndim != 1 or C.ndim != 2 or C.shape[1] != m \
            or labels.shape[0] == 0:
        return {"rows_missing": float(max(bad, 1)), **failed}
    labels = labels[:n].long()
    bad += int(((labels < 0) | (labels >= k)).sum())
    if bad:
        return {"rows_missing": float(bad), **failed}
    Cc = C - mean
    excess, outside, inertia, sums, counts = _qkmeans_pass(
        X, labels, Cc, mean, delta, sq_norm)
    extra = {}
    if reference_inertia is not None:
        extra["optimum_gap"] = (inertia - reference_inertia) \
            / reference_inertia
    if settled:
        filled = (counts > 0)[:, None]
        stepped = torch.where(filled, sums / counts.clamp(min=1)[:, None],
                              Cc)
        inertia = _qkmeans_pass(X, None, stepped, mean, delta, sq_norm)[2]
    return {"rows_missing": 0.0, "labels_outside": float(outside),
            "window_excess": max(excess, 0.0) / sq_norm,
            "inertia_gap": abs(float(fit["inertia"]) - inertia) / inertia,
            **extra}


def _exact_sq(Q, T, idx):
    """Exact squared distances (float64) of each query to its listed train
    rows: (nq, L)."""
    out = torch.empty(idx.shape, dtype=torch.float64, device=Q.device)
    step = max(1, BLOCK_ROWS // max(idx.shape[1], 1) // 8)
    for r0 in range(0, Q.shape[0], step):
        q = Q[r0:r0 + step].double()[:, None, :]
        t = T[idx[r0:r0 + step]].double()
        out[r0:r0 + step] = ((q - t) ** 2).sum(dim=2)
    return out


def knn_truth(T, Q, k, extra=32):
    """The exact k smallest squared distances (float64, ascending) from
    each query to the train rows. A float32 pass shortlists k + ``extra``
    candidates per query, their distances are recomputed exactly, and the
    shortlist is checked to be safe: the exact distance of its last
    candidate clears the k-th by more than twice a bound on the float32
    score's error, or the query is searched again in float64."""
    nq = Q.shape[0]
    L = min(k + extra, T.shape[0])
    tsq = (T * T).sum(dim=1)
    cand = torch.empty((nq, L), dtype=torch.int64, device=Q.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        step = max(1, (1 << 27) // T.shape[0])
        for r0 in range(0, nq, step):
            score = tsq[None, :] - 2.0 * (Q[r0:r0 + step] @ T.T)
            cand[r0:r0 + step] = torch.topk(score, L, dim=1,
                                            largest=False).indices
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d = torch.sort(_exact_sq(Q, T, cand), dim=1).values
    # |float32 score error| ≤ m·2^-23·(‖t‖² + 2‖q‖‖t‖), generously
    m = T.shape[1]
    qn = (Q.double() ** 2).sum(dim=1).sqrt()
    tn = float(tsq.max().sqrt())
    err = m * 2.0 ** -23 * (tn * tn + 2.0 * qn * tn)
    unsafe = torch.nonzero(d[:, L - 1] - d[:, k - 1] <= 2.0 * err).flatten()
    for i in unsafe.tolist():
        full = ((T.double() - Q[i].double()) ** 2).sum(dim=1)
        d[i, :k] = torch.sort(full).values[:k]
    return d[:, :k]


def vote(y_train, idx, n_classes):
    """Uniform vote of each query's neighbours, ties to the lowest class
    (numpy)."""
    votes = y_train[idx]
    n = votes.shape[0]
    counts = np.zeros((n, n_classes), dtype=np.int64)
    np.add.at(counts, (np.repeat(np.arange(n), votes.shape[1]),
                       votes.ravel()), 1)
    return np.argmax(counts, axis=1)


def knn(T, Q, y_train, n_classes, truth, answer, k, sq_norm):
    """The three k-NN numbers of one predict (see the module docstring).
    ``answer`` = {"labels": (nq,), "idx": (nq, k) or None}; ``truth`` =
    :func:`knn_truth` of these queries; ``sq_norm`` = mean squared norm of
    the train rows."""
    nq, nt = Q.shape[0], T.shape[0]
    labels = np.asarray(answer["labels"]).ravel()
    missing = abs(nq - labels.shape[0])
    idx = answer.get("idx")
    out = {"rows_missing": float(missing), "neighbor_gap": np.inf,
           "vote_mismatch": np.inf}
    if idx is None:
        return out
    idx = torch.as_tensor(np.asarray(idx.cpu() if torch.is_tensor(idx)
                                     else idx)).long()
    if idx.shape != (nq, k) or int(idx.min()) < 0 or int(idx.max()) >= nt:
        return out
    srt = torch.sort(idx, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        return out
    idx_dev = idx.to(Q.device)
    got = torch.sort(_exact_sq(Q, T, idx_dev), dim=1).values
    out["neighbor_gap"] = float((got - truth).max()) / sq_norm
    if not missing:
        voted = vote(y_train, idx.numpy(), n_classes)
        out["vote_mismatch"] = float((voted != labels).sum())
    return out
