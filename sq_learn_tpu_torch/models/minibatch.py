"""Mini-batch q-means (counterpart of ``sq_learn_tpu/models/minibatch.py``).

Streaming Lloyd after the reference's ``MiniBatchKMeans`` subclass of
``qMeans_`` (``_dmeans.py:1587-2243``), in its documented intent:

- the E-step on each batch runs the same quantum error model as full
  q-means (:func:`~sq_learn_tpu_torch.models.qkmeans.e_step`: classic,
  δ-window picks or IPE-estimated distances);
- each center moves toward the batch mean of its rows with step
  1/count, the Sculley update;
- every ``10 + min(counts)`` steps, centers whose accumulated weight fell
  below ``reassignment_ratio · max(counts)`` jump to uniformly drawn
  batch rows (:func:`reassign_picks` draws them, :func:`reassign_apply`
  applies them);
- ``partial_fit`` advances the same state by one batch.

X is uploaded once per fit. Each epoch permutes the row positions, padded
to whole batches, on the device and runs the steps in order; the host
reads the epoch's batch inertias once, for the EWA stop rule. The JAX
package runs the step in XLA (``minibatch.py:249-284``), not in its
Pallas kernel, so the port runs it in plain torch ops. Its host engines
(``_host_*``, the CPU route) and its tiny-fit routing are not ported: a
fit runs on the device it is given.

A shard store (:class:`~sq_learn_tpu_torch.oocore.ShardStore`, or any row
source) fits out of core, as in the JAX package: ``fit`` runs the
resumable multi-epoch engine (:func:`~sq_learn_tpu_torch.oocore.fit.
minibatch_epoch_fit`, ``max_iter`` epochs of the deterministic
shard-shuffled batch walk, checkpointed under ``SQ_STREAM_CKPT_DIR``) and
labels the store through the Lloyd kernel; ``partial_fit`` walks one
epoch per call. The JAX package runs those steps on the host; the port
runs them on the estimator's device. The classic and δ-means error
models are supported (IPE raises), a ``sample_weight`` raises, and the
init is k-means++ on a keyed subsample or an explicit array. The keyed
draws take an integer seed: an integral ``random_state`` is it, anything
else derives it from the port's generator (``initial_seed()`` of
:func:`~sq_learn_tpu_torch.utils.random.as_generator`), where the JAX
package derives it from its key's data.

Under an obs run ``fit`` and ``partial_fit`` are spans
(``minibatch.fit``, ``minibatch.partial_fit``, and
``minibatch.fit_store``, ``minibatch.partial_fit_store`` from a store);
the steps record no guarantee draws, as the JAX package's ``jit``'d steps
record none.
"""

import numbers
import warnings

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, ClusterMixin, TransformerMixin,
                    check_is_fitted, check_n_features)
from ..ops.linalg import pairwise_sq_distances, row_norms
from ..parallel.init import kmeans_plusplus_batched
from ..utils.random import as_generator, gumbel
from ..utils.validation import check_sample_weight
from .qkmeans import _cluster_partials, e_step, tolerance
from ..streaming import is_row_source


def reassign_picks(generator, wb, n_pick):
    """``n_pick`` distinct batch rows drawn uniformly among the
    positive-weight ones (Gumbel top-k, as ``jax.random.choice`` without
    replacement draws them); weight-0 rows rank last."""
    noise = gumbel(wb.shape, generator, wb.device).to(wb.dtype)
    keys = torch.where(wb > 0, noise, torch.full_like(noise, -torch.inf))
    return torch.sort(keys, descending=True, stable=True).indices[:n_pick]


def reassign_apply(Xb, wb, centers, counts, step_idx, reassignment_ratio,
                   picks):
    """Low-count center reassignment (reference ``_mini_batch_step``,
    ``_dmeans.py:1590-1618``) onto the batch rows ``picks``: when
    ``(step_idx + 1) % (10 + floor(min(counts))) == 0``, centers whose
    count is below ``reassignment_ratio · max(counts)`` — at most half the
    batch, the highest-count ones kept — take the picked rows in order,
    and their counts reset to the smallest count not reassigned. A pick
    of a weight-0 row serves nobody. All on the device, no host read."""
    k, b = centers.shape[0], Xb.shape[0]
    n_pick = picks.shape[0]
    period = 10 + torch.floor(torch.min(counts)).to(torch.int64)
    due = (step_idx + 1) % period == 0
    low = counts < reassignment_ratio * torch.max(counts)
    rank = torch.empty(k, dtype=torch.int64, device=counts.device)
    rank[torch.sort(counts, stable=True).indices] = torch.arange(
        k, device=counts.device)
    low = low & (rank < int(0.5 * b)) & due
    order = torch.cumsum(low.to(torch.int64), dim=0) - 1
    sel = picks[torch.clamp(order, 0, n_pick - 1)]
    served = low & (order < n_pick) & (wb[sel] > 0)
    keep_min = torch.min(torch.where(low, torch.full_like(counts, torch.inf),
                                     counts))
    keep_min = torch.where(torch.isfinite(keep_min), keep_min,
                           torch.max(counts))
    centers = torch.where(served[:, None], Xb[sel], centers)
    counts = torch.where(served, keep_min, counts)
    return centers, counts


def minibatch_step(generator, Xb, wb, centers, counts, step_idx=0, *, delta,
                   mode, ipe_q=5, reassignment_ratio=0.0, picks=None):
    """One streaming update from batch ``Xb`` (weights ``wb``, 0 on padded
    rows). Returns (new centers, new counts, batch inertia) as device
    tensors. ``picks`` feeds :func:`reassign_apply` the rows
    :func:`reassign_picks` would draw."""
    k = centers.shape[0]
    xsq = row_norms(Xb, squared=True)
    labels, inertia, _ = e_step(generator, Xb, wb, centers, xsq, delta=delta,
                                mode=mode, ipe_q=ipe_q)
    batch_sums, batch_counts = _cluster_partials(Xb, wb, labels, k)
    new_counts = counts + batch_counts
    # Sculley: c ← c + (Σ_batch x − n_batch·c)/count, the running mean
    safe = torch.where(new_counts > 0, new_counts,
                       torch.ones_like(new_counts))
    step = (batch_sums - batch_counts[:, None] * centers) / safe[:, None]
    new_centers = torch.where((batch_counts > 0)[:, None], centers + step,
                              centers)
    if reassignment_ratio > 0:
        if picks is None:
            picks = reassign_picks(generator, wb, min(k, Xb.shape[0]))
        new_centers, new_counts = reassign_apply(
            Xb, wb, new_centers, new_counts, step_idx, reassignment_ratio,
            picks)
    return new_centers, new_counts, inertia


def minibatch_epoch(generator, X, wp, centers, counts, step0, *, batch,
                    delta, mode, ipe_q=5, reassignment_ratio=0.0):
    """One epoch: a permutation of the ``len(wp)`` row positions on the
    device, cut into batches of ``batch`` rows, then the steps in order.
    ``wp`` holds X's weights padded with zeros to whole batches; position
    p gathers row ``p % n``, so a padding position repeats a real row at
    weight 0 and contributes nothing wherever it lands. Returns (centers,
    counts, next step index, the batch inertias as one tensor)."""
    perm = torch.randperm(wp.shape[0], generator=generator,
                          device=X.device)
    n_batches = wp.shape[0] // batch
    batches = X[perm % X.shape[0]].reshape(n_batches, batch, X.shape[1])
    weights = wp[perm].reshape(n_batches, batch)
    inertias = []
    for i in range(n_batches):
        centers, counts, inertia = minibatch_step(
            generator, batches[i], weights[i], centers, counts, step0 + i,
            delta=delta, mode=mode, ipe_q=ipe_q,
            reassignment_ratio=reassignment_ratio)
        inertias.append(inertia)
    return centers, counts, step0 + n_batches, torch.stack(inertias)


class MiniBatchQKMeans(TransformerMixin, ClusterMixin, BaseEstimator):
    """Mini-batch q-means (reference ``MiniBatchKMeans``,
    ``_dmeans.py:1587``) with working ``fit``/``partial_fit``/``predict``.

    ``delta`` selects the quantum error model as in
    :class:`~sq_learn_tpu_torch.models.qkmeans.QKMeans`; δ=0 is classical
    mini-batch k-means (Sculley 2010). Parameters are the JAX
    ``MiniBatchQKMeans``'s, plus ``device`` (None = the configured one).
    After ``fit``: ``cluster_centers_``, ``counts_``, ``n_iter_`` (epochs),
    ``n_steps_`` (batches) and, with ``compute_labels``, ``labels_`` and
    ``inertia_`` under the final centers.
    """

    def __init__(self, n_clusters=8, *, init="k-means++", max_iter=100,
                 batch_size=1024, verbose=0, compute_labels=True, tol=0.0,
                 max_no_improvement=10, init_size=None, n_init=3,
                 random_state=None, reassignment_ratio=0.01, delta=None,
                 true_distance_estimate=False, ipe_q=5, device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.batch_size = batch_size
        self.verbose = verbose
        self.compute_labels = compute_labels
        self.tol = tol
        self.max_no_improvement = max_no_improvement
        self.init_size = init_size
        self.n_init = n_init
        self.random_state = random_state
        self.reassignment_ratio = reassignment_ratio
        self.delta = delta
        self.true_distance_estimate = true_distance_estimate
        self.ipe_q = ipe_q
        self.device = device

    def _mode(self, delta):
        if delta == 0:
            return "classic"
        return "ipe" if self.true_distance_estimate else "delta"

    def _delta(self):
        return 0.0 if self.delta is None else float(self.delta)

    def _step_kw(self, delta, reassignment=True):
        return {"delta": delta, "mode": self._mode(delta),
                "ipe_q": self.ipe_q,
                "reassignment_ratio": (float(self.reassignment_ratio)
                                       if reassignment else 0.0)}

    def _resolved_n_init(self):
        """sklearn 1.4's n_init='auto': 1 for k-means++ and array inits, 3
        otherwise."""
        if self.n_init == "auto":
            return 1 if (isinstance(self.init, str)
                         and self.init == "k-means++"
                         or hasattr(self.init, "__array__")) else 3
        if isinstance(self.n_init, numbers.Integral) and self.n_init > 0:
            return int(self.n_init)
        raise ValueError(
            f"n_init should be 'auto' or > 0, got {self.n_init} instead.")

    # -- streaming state ---------------------------------------------------

    def _init_state(self, generator, Xd, w, n):
        """Initial centers and zero counts from the ``n`` rows ``Xd`` with
        weights ``w``: the weighted k-means++ never picks a row of weight
        0, and 'random' draws uniformly from the rows."""
        k = self.n_clusters
        if isinstance(self.init, str) and self.init == "k-means++":
            centers = kmeans_plusplus_batched(
                generator, Xd, row_norms(Xd, squared=True), k,
                weights=w)[0][0]
        elif isinstance(self.init, str) and self.init == "random":
            idx = torch.randperm(n, generator=generator,
                                 device=Xd.device)[:k]
            centers = Xd[idx]
        else:
            centers = torch.as_tensor(np.asarray(self.init), dtype=Xd.dtype,
                                      device=Xd.device)
            if centers.shape != (k, Xd.shape[1]):
                raise ValueError(
                    f"init centers shape {tuple(centers.shape)} != "
                    f"({k}, {Xd.shape[1]})")
        return centers, torch.zeros(k, dtype=Xd.dtype, device=Xd.device)

    def _padded_weights(self, X, sample_weight):
        """(wp, b): the weights padded with zeros on the device to a whole
        number of batches of b rows. The rows are not copied: an epoch
        gathers a padding position's row modulo n."""
        n = X.shape[0]
        b = min(self.batch_size, n)
        pad = -(-n // b) * b - n
        if not pad:
            return sample_weight, b
        return torch.cat([sample_weight, torch.zeros(
            pad, dtype=X.dtype, device=X.device)]), b

    def _resolve_init_size(self, b, n):
        """Upstream init_size resolution: 3·batch_size by default; a value
        below n_clusters warns and becomes 3·n_clusters; clamped to
        [n_clusters, n]."""
        init_size = self.init_size
        if init_size is None:
            init_size = 3 * b
        elif init_size < self.n_clusters:
            warnings.warn(
                f"init_size={init_size} should be larger than "
                f"n_clusters={self.n_clusters}; setting it to "
                f"min(3*n_clusters, n_samples)", RuntimeWarning)
            init_size = 3 * self.n_clusters
        return int(min(max(init_size, self.n_clusters), n))

    def _select_init(self, generator, X, w, b, n_init, delta):
        """Upstream init selection: each of ``n_init`` candidates is
        initialized on an ``init_size`` row sample and scored by one step
        on a validation sample (rows drawn with replacement); the first of
        the lowest inertias wins, with zero counts. One candidate is
        initialized on all rows and not scored. ``w`` holds X's own
        weights, unpadded."""
        if hasattr(self.init, "__array__") and n_init > 1:
            warnings.warn(
                "Explicit initial center position passed: performing only "
                "one init of the restart loop.", RuntimeWarning)
            n_init = 1
        n = X.shape[0]
        if n_init == 1:
            return self._init_state(generator, X, w, n)
        init_size = self._resolve_init_size(b, n)
        dev = X.device
        vidx = torch.randint(0, n, (init_size,), generator=generator,
                             device=dev)
        Xv, wv = X[vidx], w[vidx]
        candidates, inertias = [], []
        for _ in range(n_init):
            sidx = torch.randint(0, n, (init_size,), generator=generator,
                                 device=dev)
            centers, counts = self._init_state(generator, X[sidx],
                                               w[sidx], init_size)
            _, _, inertia = minibatch_step(
                generator, Xv, wv, centers, counts, 0,
                **self._step_kw(delta, reassignment=False))
            candidates.append((centers, counts))
            inertias.append(inertia)
            if self.verbose:
                print(f"init candidate inertia {float(inertia):.3f}")
        # torch.argmin returns the first of equal minima
        best = torch.argmin(torch.stack(inertias))
        return (torch.stack([c for c, _ in candidates])[best],
                torch.stack([c for _, c in candidates])[best])

    def _fit_loop(self, generator, X, wp, b, centers, counts, delta, tol_):
        """Epochs of mini-batch steps with the EWA-inertia stop rule (the
        reference's ``_mini_batch_convergence``, on the host): one read of
        the epoch's batch inertias, and of the center shift when
        ``tol_`` > 0."""
        ewa = None
        alpha = 2.0 * b / (X.shape[0] + 1)
        no_improve = 0
        best_ewa = np.inf
        prev_centers = None
        it = step = 0
        for epoch in range(self.max_iter):
            centers, counts, step, inertias = minibatch_epoch(
                generator, X, wp, centers, counts, step, batch=b,
                **self._step_kw(delta))
            it = epoch + 1
            for bi in inertias.cpu().numpy():
                ewa = bi if ewa is None else ewa * (1 - alpha) + bi * alpha
                if ewa < best_ewa - 1e-12:
                    best_ewa = ewa
                    no_improve = 0
                else:
                    no_improve += 1
            if self.verbose:
                print(f"MiniBatch epoch {it}: ewa inertia {float(ewa):.3f}")
            if (self.max_no_improvement is not None
                    and no_improve >= self.max_no_improvement):
                break
            if prev_centers is not None and tol_ > 0:
                if float(torch.sum((centers - prev_centers) ** 2)) <= tol_:
                    break
            prev_centers = centers
        return centers, counts, it, step

    # -- API ---------------------------------------------------------------

    def _input(self, X):
        if is_row_source(X):
            raise ValueError(
                "predict, transform and score take arrays; label a shard "
                "store with sq_learn_tpu_torch.oocore.assign_labels")
        return self._validated_X(X, resolve_device(self.device))

    def fit(self, X, y=None, sample_weight=None):
        """Mini-batch q-means on the estimator's device (out of core from
        a shard store)."""
        if is_row_source(X):
            return self._fit_store(X, sample_weight)
        X = self._input(X)
        self.n_features_in_ = X.shape[1]
        if X.shape[0] < self.n_clusters:
            raise ValueError(
                f"n_samples={X.shape[0]} should be >= n_clusters="
                f"{self.n_clusters}.")
        with _obs.span("minibatch.fit", n_samples=X.shape[0],
                       n_features=X.shape[1],
                       n_clusters=self.n_clusters) as sp, \
                _obs.guarantees.no_audit():
            self._fit_impl(X, sample_weight)
            sp.set(backend=X.device.type, n_steps=self.n_steps_)
        return self

    def _fit_impl(self, X, sample_weight):
        sample_weight = check_sample_weight(sample_weight, X)
        delta = self._delta()
        if delta == 0:
            warnings.warn("Attention! You are running the classic version of "
                          "mini-batch k-means (delta=0).")
        n_init = self._resolved_n_init()
        generator = as_generator(self.random_state, X.device)
        tol_ = tolerance(X, self.tol)
        wp, b = self._padded_weights(X, sample_weight)
        centers, counts = self._select_init(generator, X, sample_weight, b,
                                            n_init, delta)
        centers, counts, n_iter, n_steps = self._fit_loop(
            generator, X, wp, b, centers, counts, delta, tol_)
        self.cluster_centers_ = centers.cpu().numpy()
        self.counts_ = counts.cpu().numpy()
        # n_iter_ counts epochs, n_steps_ batches (sklearn's semantics); the
        # step count carries partial_fit's reassignment cadence on
        self.n_iter_ = int(n_iter)
        self.n_steps_ = int(n_steps)
        if self.compute_labels:
            self.labels_, self.inertia_ = self._full_assign(X, sample_weight)

    def partial_fit(self, X, y=None, sample_weight=None):
        """Update the state from one batch (reference ``_dmeans.py:2139``).
        The first call initializes the centers on the batch; a width
        different from the fitted one is rejected before any state moves.
        The draws of successive calls come from one generator, seeded from
        ``random_state`` at the first call. A shard store advances the
        state by one epoch of its batch walk."""
        if is_row_source(X):
            if sample_weight is not None:
                raise ValueError(
                    "store-backed partial_fit takes no per-row "
                    "sample_weight (no aligned resident weight array)")
            return self._partial_fit_store(X)
        X = check_n_features(self, self._input(X))
        self.n_features_in_ = X.shape[1]
        with _obs.span("minibatch.partial_fit", batch=X.shape[0]) as sp, \
                _obs.guarantees.no_audit():
            self._partial_fit_impl(X, sample_weight)
            sp.set(backend=X.device.type)
        return self

    def _partial_fit_impl(self, X, sample_weight):
        sample_weight = check_sample_weight(sample_weight, X)
        delta = self._delta()
        gen = getattr(self, "_pf_generator", None)
        if gen is None or gen.device.type != X.device.type:
            gen = self._pf_generator = as_generator(self.random_state,
                                                    X.device)
        if not hasattr(self, "cluster_centers_"):
            centers, counts = self._init_state(gen, X, sample_weight,
                                               X.shape[0])
            self.n_steps_ = 0
        else:
            centers = self._centers_tensor(X)
            counts = torch.as_tensor(self.counts_, dtype=X.dtype,
                                     device=X.device)
        centers, counts, _ = minibatch_step(
            gen, X, sample_weight, centers, counts,
            getattr(self, "n_steps_", 0), **self._step_kw(delta))
        self.cluster_centers_ = centers.cpu().numpy()
        self.counts_ = counts.cpu().numpy()
        self.n_steps_ = getattr(self, "n_steps_", 0) + 1
        if self.compute_labels:
            # the batch's labels and inertia under the updated centers
            self.labels_, self.inertia_ = self._full_assign(X, sample_weight)

    # -- out of core ---------------------------------------------------------

    def _store_mode(self):
        """The δ-window of a store-backed fit: the classic (0) and
        δ-means error models; IPE needs a resident array."""
        delta = self._delta()
        mode = self._mode(delta)
        if mode not in ("classic", "delta"):
            raise ValueError(
                "store-backed fits support the classic (delta=0) and "
                "delta-means error models; true_distance_estimate/IPE "
                "needs a resident array")
        if delta == 0:
            warnings.warn("Attention! You are running the classic version "
                          "of mini-batch k-means (delta=0).")
        return delta if mode == "delta" else 0.0

    def _store_seed(self):
        """Integer seed of the epoch engine's keyed draws: an integral
        ``random_state`` as it is, anything else the initial seed of the
        port's generator for it."""
        if isinstance(self.random_state, numbers.Integral):
            return int(self.random_state)
        return int(as_generator(self.random_state, "cpu").initial_seed())

    def _store_init(self):
        if isinstance(self.init, str) and self.init == "random":
            raise ValueError(
                "store-backed fits init with 'k-means++' (subsampled) or "
                "an explicit center array")
        return (np.asarray(self.init) if hasattr(self.init, "__array__")
                else None)

    def _label_store(self, store, device):
        from ..oocore.fit import assign_labels

        labels, inertia = assign_labels(
            store, self.cluster_centers_,
            batch_rows=max(self.batch_size, 1024), device=device)
        self.labels_ = labels
        self.inertia_ = float(inertia)

    def _fit_store(self, store, sample_weight):
        """Multi-epoch fit over a shard store on the estimator's device
        (``max_iter`` epochs), resumable bit for bit from its mid-epoch
        checkpoints (``SQ_STREAM_CKPT_DIR``)."""
        from ..oocore.fit import minibatch_epoch_fit

        if sample_weight is not None:
            raise ValueError(
                "store-backed fits take no per-row sample_weight (the "
                "store has no aligned resident weight array); materialize "
                "the data to use weights")
        n, m = store.shape
        self.n_features_in_ = m
        if n < self.n_clusters:
            raise ValueError(
                f"n_samples={n} should be >= n_clusters={self.n_clusters}.")
        window = self._store_mode()
        device = resolve_device(self.device)
        # tol's scale from the manifest's build-time column stats
        tol_ = 0.0 if self.tol == 0 else float(self.tol) * store.var_mean()
        init = self._store_init()
        with _obs.span("minibatch.fit_store", n_samples=n, n_features=m,
                       n_clusters=self.n_clusters) as sp:
            out = minibatch_epoch_fit(
                store, n_clusters=self.n_clusters,
                batch_rows=self.batch_size, max_epochs=self.max_iter,
                seed=self._store_seed(), window=window,
                reassignment_ratio=float(self.reassignment_ratio),
                tol=tol_, max_no_improvement=self.max_no_improvement,
                init=init, verbose=self.verbose, device=device)
            sp.set(backend=device.type, n_steps=out["n_steps"],
                   resumed_from=out["resumed_from"] or None)
        self.cluster_centers_ = out["centers"]
        self.counts_ = out["counts"]
        self.n_iter_ = int(out["n_epochs"])
        self.n_steps_ = int(out["n_steps"])
        if self.compute_labels:
            self._label_store(store, device)
        return self

    def _partial_fit_store(self, store):
        """One epoch over the store: each call walks the next epoch's
        deterministic shuffle (its index is the number of store epochs
        this estimator has consumed) and advances the same centers and
        counts ``partial_fit`` batches do."""
        from ..oocore import EpochPlan
        from ..oocore.fit import _BatchUploader, _init_centers, batch_step

        n, m = store.shape
        if hasattr(self, "n_features_in_") and m != self.n_features_in_:
            raise ValueError(
                f"X has {m} features, but {type(self).__name__} is "
                f"expecting {self.n_features_in_} features as input.")
        self.n_features_in_ = m
        window = self._store_mode()
        seed = self._store_seed()
        device = resolve_device(self.device)
        b = min(self.batch_size, n)
        epoch = int(getattr(self, "_store_epochs_", 0))
        if not hasattr(self, "cluster_centers_"):
            centers = _init_centers(store, self.n_clusters, b, seed,
                                    self._store_init(), device)
            counts = torch.zeros(self.n_clusters, dtype=torch.float32,
                                 device=device)
            self.n_steps_ = 0
        else:
            centers = torch.as_tensor(
                np.asarray(self.cluster_centers_, np.float32), device=device)
            counts = torch.as_tensor(np.asarray(self.counts_, np.float32),
                                     device=device)
        plan = EpochPlan(seed=seed, batch_rows=b)
        upload = _BatchUploader(device, b * m * 4)
        try:
            with _obs.span("minibatch.partial_fit_store", epoch=epoch,
                           n_samples=n) as sp, _obs.guarantees.no_audit():
                for bi, Xb in plan.iter_batches(store, epoch):
                    centers, counts, _ = batch_step(
                        device, Xb, centers, counts,
                        int(getattr(self, "n_steps_", 0)), seed=seed,
                        epoch=epoch, batch=bi, window=window,
                        reassignment_ratio=self.reassignment_ratio,
                        upload=upload)
                    self.n_steps_ = int(getattr(self, "n_steps_", 0)) + 1
                sp.set(backend=device.type, n_steps=self.n_steps_)
        finally:
            upload.close()
        self._store_epochs_ = epoch + 1
        self.cluster_centers_ = centers.cpu().numpy()
        self.counts_ = counts.cpu().numpy()
        if self.compute_labels:
            self._label_store(store, device)
        return self

    def _centers_tensor(self, X):
        return torch.as_tensor(np.asarray(self.cluster_centers_),
                               dtype=X.dtype, device=X.device)

    def _full_assign(self, X, sample_weight):
        """Nearest-center labels (numpy) and the weighted inertia."""
        d2 = pairwise_sq_distances(X, self._centers_tensor(X))
        min_d2, labels = torch.min(d2, dim=1)
        return (labels.to(torch.int32).cpu().numpy(),
                float(torch.sum(min_d2 * sample_weight)))

    def _inference_input(self, X):
        check_is_fitted(self, "cluster_centers_")
        return check_n_features(self, self._input(X))

    def predict(self, X, sample_weight=None):
        X = self._inference_input(X)
        d2 = pairwise_sq_distances(X, self._centers_tensor(X))
        return torch.argmin(d2, dim=1).to(torch.int32).cpu().numpy()

    def transform(self, X):
        """Distances to the cluster centers."""
        from ..metrics import euclidean_distances

        X = self._inference_input(X)
        return euclidean_distances(X, self._centers_tensor(X)).cpu().numpy()

    def fit_transform(self, X, y=None, sample_weight=None):
        """``fit`` then ``transform`` under one validate-once scope."""
        from ..utils.validation import validation_scope

        with validation_scope(self):
            return self.fit(X, sample_weight=sample_weight).transform(X)

    def score(self, X, y=None, sample_weight=None):
        """Negative inertia of X under the fitted centers."""
        X = self._inference_input(X)
        return -self._full_assign(X, check_sample_weight(sample_weight,
                                                         X))[1]


class MiniBatchKMeans(MiniBatchQKMeans):
    """Classical mini-batch k-means: the δ=0 path of
    :class:`MiniBatchQKMeans`."""

    def __init__(self, n_clusters=8, *, init="k-means++", max_iter=100,
                 batch_size=1024, verbose=0, compute_labels=True, tol=0.0,
                 max_no_improvement=10, init_size=None, n_init=3,
                 random_state=None, reassignment_ratio=0.01, device=None):
        super().__init__(
            n_clusters=n_clusters, init=init, max_iter=max_iter,
            batch_size=batch_size, verbose=verbose,
            compute_labels=compute_labels, tol=tol,
            max_no_improvement=max_no_improvement, init_size=init_size,
            n_init=n_init, random_state=random_state,
            reassignment_ratio=reassignment_ratio, delta=None, device=device)

    def fit(self, X, y=None, sample_weight=None):
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Attention! You are running the classic")
            return super().fit(X, sample_weight=sample_weight)


__all__ = ["MiniBatchKMeans", "MiniBatchQKMeans", "minibatch_epoch",
           "minibatch_step", "reassign_apply", "reassign_picks"]
