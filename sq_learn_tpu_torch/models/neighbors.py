"""K-nearest-neighbors classification, brute force (counterpart of
``sq_learn_tpu/models/neighbors.py``).

The exact float32 search is :func:`~sq_learn_tpu_torch.ops.kernels.argkmin`:
on the card the hand-written kernel of ``csrc/argkmin.cu``, on the CPU its
plain torch version. A reduced ``compute_dtype`` runs :func:`knn_indices`,
a shortlist in reduced precision refined exactly, in plain torch ops, as
the JAX package leaves it to XLA. Voting is on the host in numpy, after
one copy of the (n, k) neighbor lists.

A float64 fit (``default_dtype='float64'``) searches in plain float64
torch ops, off the kernel, as the JAX package keeps float64 on its XLA
search. Host queries larger than the tile cap stream
(:func:`~sq_learn_tpu_torch.streaming.stream_map_rows`): each tile is
searched on the device, the next uploading meanwhile, and only the
(rows, k) lists are kept.

Every search is one ``knn.search`` span and one classical (zero quantum
queries) ledger entry under an obs run, each naming the engine that
served it: the kernel (``argkmin_kernel``), its plain version
(``argkmin_reference``), the reduced-precision shortlist
(``shortlist``), the float64 search (``plain``) or the streamed search
(``streamed-device``).

Not ported: ``use_pallas`` (the device of the data decides), the host fast
path, the tiny-predict host routing and the memo of rejected kernels (the
device a model was fitted on computes every search). ``mesh`` raises
``NotImplementedError`` naming its item.
"""

import numbers
import time

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, ClassifierMixin, check_is_fitted,
                    check_n_features)
from ..ops.kernels import argkmin
from ..ops.linalg import (check_compute_dtype, is_reduced,
                          pairwise_sq_distances, row_norms)
from ..streaming import stream_map_rows
from ..utils.validation import check_X_y, host_ingest

_MESH = ("mesh is not ported yet: ROADMAP.md §1 item 6, multi-GPU")

#: distance-matrix entries one query block of :func:`knn_indices` may hold
_BLOCK_ELEMENTS = 1 << 24


def _smallest(d, k):
    """(values, indices) of the k smallest entries of each row of ``d``,
    ascending, ties to the lowest index — the order ``lax.top_k(-d, k)``
    gives."""
    vals, order = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], order[:, :k]


def _shortlists(X_train, k, compute_dtype):
    """Whether :func:`knn_indices` searches approximate-then-exact: a
    reduced ``compute_dtype`` whose 4k+16 shortlist is smaller than the
    training set. Otherwise the exact search serves it."""
    return (is_reduced(compute_dtype, X_train.dtype)
            and _shortlist_len(k) < X_train.shape[0])


def _shortlist_len(k):
    """Candidates the reduced-precision pass of :func:`knn_indices`
    keeps per query."""
    return 4 * k + 16


def knn_indices(X_train, X_query, k, block=4096, compute_dtype=None):
    """Indices (int32) and squared distances of the k nearest training rows
    per query, ascending, ties to the lowest index.

    Counterpart of the JAX ``knn_indices``. The exact search (float32 data,
    ``compute_dtype`` None or float32) is the fused search
    :func:`~sq_learn_tpu_torch.ops.kernels.argkmin` on every device: the
    kernel on the card, its plain version on the CPU. It ranks by
    ‖t‖²−2·q·t, as the JAX package's Pallas search does.

    A reduced ``compute_dtype`` makes the search approximate-then-exact:
    the distance GEMM runs in reduced precision to shortlist 4k+16
    candidates, whose distances are then recomputed exactly in the
    difference form, and the k nearest of them are returned. Its queries
    are taken in blocks of at most ``block`` rows (fewer when a block's
    distance matrix would pass ``_BLOCK_ELEMENTS``). When the shortlist
    would hold the whole training set the reduced dtype is dropped.
    """
    nq, nt, kc = X_query.shape[0], X_train.shape[0], _shortlist_len(k)
    block = max(1, min(block, _BLOCK_ELEMENTS // nt))
    if X_train.dtype != torch.float32:
        return _plain_search(X_train, X_query, k, block)
    if not _shortlists(X_train, k, compute_dtype):
        X_train = X_train.contiguous()
        return argkmin(X_train, row_norms(X_train, squared=True),
                       X_query.contiguous(), k)
    idx = torch.empty((nq, k), dtype=torch.int32, device=X_query.device)
    d2 = torch.empty((nq, k), dtype=X_query.dtype, device=X_query.device)
    for q0 in range(0, nq, block):
        q = X_query[q0:q0 + block]
        d = pairwise_sq_distances(q, X_train, compute_dtype=compute_dtype)
        # shortlist in reduced precision, refine exactly: the difference
        # form is non-negative by construction
        _, cand = _smallest(d, kc)
        exact = torch.sum((q[:, None, :] - X_train[cand]) ** 2, dim=-1)
        vals, within = _smallest(exact, k)
        order = torch.gather(cand, 1, within)
        idx[q0:q0 + block] = order.to(torch.int32)
        d2[q0:q0 + block] = vals
    return idx, d2


def _plain_search(X_train, X_query, k, block):
    """The exact search in plain torch ops, in the data's dtype: the JAX
    package keeps float64 fits off its kernel, on the XLA search, which
    ranks by max(‖q‖²+‖t‖²−2·q·t, 0) (``sq_learn_tpu/ops/linalg.py:
    209-211``), ties to the lowest index; queries in blocks of at most
    ``block`` rows."""
    nq = X_query.shape[0]
    idx = torch.empty((nq, k), dtype=torch.int32, device=X_query.device)
    d2 = torch.empty((nq, k), dtype=X_query.dtype, device=X_query.device)
    for q0 in range(0, nq, block):
        vals, order = _smallest(
            pairwise_sq_distances(X_query[q0:q0 + block], X_train), k)
        idx[q0:q0 + block] = order.to(torch.int32)
        d2[q0:q0 + block] = vals
    return idx, d2


class KNeighborsClassifier(ClassifierMixin, BaseEstimator):
    """Brute-force k-NN classifier (API surface of the reference's
    ``neighbors/_classification.py`` used by the MNIST pipeline).

    ``weights`` ∈ {'uniform', 'distance'}; ``algorithm``, ``p`` and
    ``n_jobs`` are accepted for compatibility (the search is always the
    brute-force Euclidean one). ``device`` (None = the configured one,
    ``'cuda'`` by default) is where ``fit`` keeps the training rows and
    where every search runs.
    """

    def __init__(self, n_neighbors=5, *, weights="uniform",
                 algorithm="brute", p=2, n_jobs=None, compute_dtype=None,
                 mesh=None, device=None):
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.algorithm = algorithm
        self.p = p
        self.n_jobs = n_jobs
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        self.device = device

    def fit(self, X, y):
        """Keep the training rows and their squared norms on the device,
        and the encoded labels on the host."""
        if self.mesh is not None:
            raise NotImplementedError(_MESH)
        check_compute_dtype(self.compute_dtype)
        X, y = check_X_y(X, y, device=resolve_device(self.device))
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.X_fit_ = X
        self.y_fit_ = y_enc.ravel().astype(np.int32)
        self.n_samples_fit_ = X.shape[0]
        self.n_features_in_ = X.shape[1]
        self._x_sq_fit = row_norms(X, squared=True)
        return self

    def _search(self, X, k):
        """(idx, d2) on the device of the training rows: the fused search
        at exact precision, :func:`knn_indices` for a reduced
        ``compute_dtype``. One span and one ledger entry per search."""
        t0 = time.perf_counter()
        with _obs.span("knn.search", n_queries=X.shape[0], k=k,
                       n_train=self.n_samples_fit_) as sp:
            out, engine = self._search_impl(X, k)
            sp.set(engine=engine)
        _obs.ledger.record("knn", "search",
                           wall_s=time.perf_counter() - t0, queries={},
                           budget={}, engine=engine,
                           n_queries=X.shape[0], k=k)
        return out

    def _search_impl(self, X, k):
        """((idx, d2), engine): the engine that served the search. Host
        queries above the tile cap stream (``"streamed-device"``): each
        tile is searched on the device as a resident query set is, and
        only its (rows, k) lists are kept."""
        if not isinstance(X, torch.Tensor):
            return stream_map_rows(
                X, lambda tile: self._device_search(tile, k)[0],
                device=self._train_rows().device,
                validate=True), "streamed-device"
        return self._device_search(X, k)

    def _device_search(self, X, k):
        """((idx, d2), engine) of queries resident on the device."""
        X_train = self._train_rows()
        if X_train.dtype != torch.float32:
            return knn_indices(X_train, X.to(X_train.dtype), k), "plain"
        if _shortlists(X_train, k, self.compute_dtype):
            return knn_indices(X_train, X, k,
                               compute_dtype=self.compute_dtype), "shortlist"
        return argkmin(X_train, self._x_sq_fit, X, k), (
            "argkmin_kernel" if X.device.type == "cuda"
            else "argkmin_reference")

    def _train_rows(self):
        """The training rows on the device, and their squared norms. A
        model loaded from a checkpoint holds numpy rows and no norms (a
        private cache is not saved): both are placed here, once."""
        if not isinstance(self.X_fit_, torch.Tensor):
            self.X_fit_ = torch.as_tensor(np.asarray(self.X_fit_),
                                          device=resolve_device(self.device))
        if getattr(self, "_x_sq_fit", None) is None:
            self._x_sq_fit = row_norms(self.X_fit_, squared=True)
        return self.X_fit_

    def _check_k(self, k):
        """Validate a neighbor count: 1 ≤ k ≤ n_samples_fit (sklearn's
        ``kneighbors`` contract and messages)."""
        if k is None:
            k = self.n_neighbors
        if not isinstance(k, numbers.Integral) or k <= 0:
            raise ValueError(
                f"n_neighbors must be a positive integer, got {k!r}")
        if k > self.n_samples_fit_:
            raise ValueError(
                f"Expected n_neighbors <= n_samples_fit, but "
                f"n_neighbors = {k}, n_samples_fit = {self.n_samples_fit_}")
        return int(k)

    def _query(self, X):
        """Validated queries: a tensor on the training rows' device, or,
        for host queries above the tile cap, the host array the search
        streams (its values are checked on the device, tile by tile)."""
        check_is_fitted(self, "n_samples_fit_")
        Xh, over_cap = host_ingest(X)
        if over_cap:
            return check_n_features(self, Xh)
        return check_n_features(
            self, self._validated_X(X, self._train_rows().device))

    def kneighbors(self, X, n_neighbors=None, return_distance=True):
        """(distances, indices) of the nearest training rows, ascending;
        only the indices with ``return_distance=False``."""
        X = self._query(X)
        k = self._check_k(n_neighbors)
        idx, d2 = self._search(X, k)
        if return_distance:
            return np.sqrt(d2.cpu().numpy()), idx.cpu().numpy()
        return idx.cpu().numpy()

    def predict_proba(self, X):
        """Class probabilities by (weighted) votes of the neighbors."""
        X = self._query(X)
        k = self._check_k(self.n_neighbors)
        n_classes = len(self.classes_)
        idx, d2 = self._search(X, k)
        idx, d2 = idx.cpu().numpy(), d2.cpu().numpy()
        votes = self.y_fit_[idx]                                # (n, k)
        if self.weights == "distance":
            wts = 1.0 / np.maximum(np.sqrt(d2), 1e-12)
        else:
            wts = np.ones_like(d2)
        n = len(votes)
        rows = np.repeat(np.arange(n), k)
        counts = np.bincount(
            rows * n_classes + votes.ravel(), weights=wts.ravel(),
            minlength=n * n_classes).reshape(n, n_classes)
        return counts / counts.sum(axis=1, keepdims=True)

    def predict(self, X):
        proba = self.predict_proba(X)
        return self.classes_[np.argmax(proba, axis=1)]
