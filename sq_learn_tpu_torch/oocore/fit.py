"""Crash-resumable multi-epoch mini-batch fit over a row source, on the
card (counterpart of ``sq_learn_tpu/oocore/fit.py``).

The JAX package runs this loop on the host (its native Lloyd twin); the
port runs every step on the estimator's device. Each batch of an
:class:`~.epochs.EpochPlan` is read on the host (shard reads, CRC checks
and the within-shard shuffle, read ahead by the prefetcher), uploaded
through a pinned two-slot ring under the transfer supervisor, and moved
by the port's :func:`~sq_learn_tpu_torch.models.minibatch.minibatch_step`
(the Sculley update and the low-count reassignment). Three properties:

- **bounded residency**: a batch is assembled from the shards its rows
  span; the dataset never materializes, on the host or the card.
- **keyed draws**: every batch's draws (δ-window picks, reassignment
  picks) come from a fresh generator seeded by a fixed mix of ``(seed,
  epoch, batch)`` (:func:`keyed_generator`), never from a sequential
  stream, so any suffix of the fit replays from any batch boundary.
- **mid-epoch checkpoints**: with a checkpoint configured
  (``SQ_STREAM_CKPT_DIR`` or explicit) the loop state (centers, counts,
  the EWA stop state, the epoch and batch cursor) is snapshotted every
  ``SQ_STREAM_CKPT_EVERY`` batches by an
  :class:`~sq_learn_tpu_torch.utils.checkpoint.AsyncStreamCheckpointer`
  (a device copy queued before the next step; ``SQ_OOC_ASYNC_CKPT=0``
  writes synchronously), keyed on the store's content-complete
  fingerprint. A killed fit rerun with the same arguments resumes at the
  last snapshot and finishes with the bits of an uninterrupted run. The
  tag ``oocore-mbfit-torch-v1`` keeps a JAX snapshot, whose draws differ,
  from ever resuming a port fit.

The host reads no per-batch value: the batch inertias stay on the device
until an epoch ends or a snapshot is taken, and the EWA recurrence then
folds them in float64 in batch order, as the JAX package folds them
batch by batch.

:func:`assign_labels` labels a store in natural row order through the
fused Lloyd kernel (:func:`~sq_learn_tpu_torch.ops.kernels.lloyd_step` at
one restart, window 0), one launch per ``batch_rows`` tile of the
streaming engine; the JAX package runs the host twin of that kernel.
"""

import functools
import os
import zlib

import numpy as np
import torch

from .. import _knobs
from .. import obs as _obs
from .._config import resolve_device
from ..resilience import faults as _faults
from ..resilience import supervisor as _sup
from .epochs import EpochPlan

__all__ = ["assign_labels", "keyed_generator", "minibatch_epoch_fit"]

_FMT = "oocore-mbfit-torch-v1"

#: salts of the keyed draws (the JAX package's: the k-means++ init and
#: each batch's step)
_INIT_SALT, _BATCH_SALT = 0x1A17, 0xBA7C

_SITE = "oocore.minibatch_fit"


def keyed_generator(device, *key):
    """A fresh torch generator on ``device`` seeded by a fixed 64-bit mix
    of the integer tuple ``key`` (numpy's ``SeedSequence``, which also
    seeds ``default_rng(key)``)."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _init_centers(source, k, batch_rows, seed, init, device):
    """k-means++ on a keyed row subsample (or the caller's array). The
    subsample is the JAX package's numpy draw, so both packages read the
    same rows; k-means++ then runs on the device with a keyed generator."""
    from ..ops.linalg import row_norms
    from ..parallel.init import kmeans_plusplus_batched

    n, m = source.shape
    if init is not None:
        centers = np.ascontiguousarray(init, np.float32)
        if centers.shape != (k, m):
            raise ValueError(
                f"init centers shape {centers.shape} != ({k}, {m})")
        return torch.from_numpy(centers.copy()).to(device)
    rng = np.random.default_rng((int(seed), _INIT_SALT))
    isize = min(n, max(3 * int(batch_rows), 3 * int(k)))
    idx = np.unique(rng.integers(0, n, isize))
    Xs = torch.from_numpy(
        np.ascontiguousarray(source.take(idx), np.float32)).to(device)
    gen = keyed_generator(device, seed, _INIT_SALT)
    return kmeans_plusplus_batched(gen, Xs, row_norms(Xs, squared=True),
                                   k)[0][0]


def _fingerprint(source, k, b, max_epochs, seed, window, ratio, tol,
                 max_no_improvement, init):
    """Checkpoint identity: the configuration and the source's
    content-complete fingerprint."""
    init_tag = "kpp"
    if init is not None:
        init_tag = f"arr:{zlib.crc32(np.ascontiguousarray(init)):08x}"
    return (f"{_FMT}|data={source.fingerprint}|shape={tuple(source.shape)}"
            f"|dtype={source.dtype}|k={k}|b={b}|epochs={max_epochs}"
            f"|seed={seed}|window={window}|ratio={ratio}|tol={tol}"
            f"|mni={max_no_improvement}|init={init_tag}")


def _state_template(k, m):
    """The checkpointed loop state with host leaves (the structure
    :func:`~sq_learn_tpu_torch.utils.checkpoint.load_stream_state`
    fills)."""
    return {
        "batch": np.zeros((), np.int64),
        "best_ewa": np.asarray(np.inf, np.float64),
        "centers": np.zeros((k, m), np.float32),
        "counts": np.zeros((k,), np.float32),
        "epoch": np.zeros((), np.int64),
        "ewa": np.asarray(np.nan, np.float64),
        "no_improve": np.zeros((), np.int64),
        "prev_centers": np.full((k, m), np.nan, np.float32),
        "step": np.zeros((), np.int64),
    }


class _BatchUploader:
    """Host batch → device tensor under the transfer supervisor: on a CUDA
    device through the streaming engine's pinned two-slot ring on its copy
    stream (the consumer's stream waits on the copy's event), on the CPU
    a view of the batch."""

    def __init__(self, device, slot_bytes):
        from ..streaming import _CudaStager

        self.stager = (_CudaStager(device, slot_bytes)
                       if device.type == "cuda" else None)

    def __call__(self, Xb, index):
        if self.stager is None:
            return _sup.put(torch.from_numpy, Xb, index, site=_SITE)
        place = functools.partial(self.stager, rows=Xb.shape[0])
        tile, event = _sup.put(place, Xb, index, site=_SITE)
        self.stager.consumer.wait_event(event)
        return tile

    def close(self):
        if self.stager is not None:
            self.stager.close()


class _EwaFold:
    """The EWA-inertia stop rule over batch inertias that stay on the
    device until :meth:`fold` reads them, in batch order, in float64."""

    def __init__(self, state, alpha):
        self.state = state
        self.alpha = alpha
        self.pending = []

    def add(self, inertia):
        self.pending.append(inertia)

    def fold(self):
        if not self.pending:
            return
        values = torch.stack(self.pending).double().cpu().numpy()
        self.pending = []
        st = self.state
        for inertia in values.tolist():
            ewa = (inertia if np.isnan(st["ewa"])
                   else float(st["ewa"]) * (1 - self.alpha)
                   + inertia * self.alpha)
            st["ewa"] = np.asarray(ewa, np.float64)
            if ewa < float(st["best_ewa"]) - 1e-12:
                st["best_ewa"] = np.asarray(ewa, np.float64)
                st["no_improve"] = np.zeros((), np.int64)
            else:
                st["no_improve"] = st["no_improve"] + 1


def batch_step(device, Xb, centers, counts, step_idx, *, seed, epoch,
               batch, window, reassignment_ratio, upload):
    """One batch of the fit on ``device``: upload, then the port's
    mini-batch step with the batch's keyed generator. Returns (centers,
    counts, batch inertia) as device tensors."""
    from ..models.minibatch import minibatch_step

    Xd = upload(np.ascontiguousarray(Xb, np.float32), step_idx)
    wb = torch.ones(Xd.shape[0], dtype=Xd.dtype, device=device)
    gen = keyed_generator(device, seed, epoch, batch, _BATCH_SALT)
    return minibatch_step(
        gen, Xd, wb, centers, counts, step_idx, delta=float(window),
        mode="delta" if window > 0 else "classic",
        reassignment_ratio=float(reassignment_ratio))


def minibatch_epoch_fit(source, *, n_clusters, batch_rows=1024,
                        max_epochs=10, seed=0, window=0.0,
                        reassignment_ratio=0.01, tol=0.0,
                        max_no_improvement=10, init=None, checkpoint=None,
                        verbose=0, device=None):
    """Run the resumable multi-epoch fit on ``device`` (None = the
    configured one); returns a dict with ``centers`` (k, m) float32 and
    ``counts`` (k,) float32 numpy arrays, ``n_epochs`` (epochs entered),
    ``n_steps`` (batches consumed), ``ewa`` and ``resumed_from`` (the
    batch cursor a checkpoint restored, 0 for a fresh run).

    ``window`` > 0 runs δ-means at that window, 0 the classic step.
    ``tol`` is the ABSOLUTE center-shift threshold (the estimator scales
    its ``tol`` by the store's variance first). Early stop follows the
    in-RAM loop: the EWA-inertia no-improvement count and the epoch's
    center shift, both checked at epoch ends."""
    from ..streaming import _resolve_checkpoint
    from ..utils.checkpoint import (AsyncStreamCheckpointer,
                                    load_stream_state, save_stream_state)

    dev = resolve_device(device)
    n, m = source.shape
    k = int(n_clusters)
    if n < k:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
    b = min(int(batch_rows), n)
    plan = EpochPlan(seed=seed, batch_rows=b)
    n_batches = plan.n_batches(n)
    seed = int(seed)

    state = _state_template(k, m)
    ckpt = _resolve_checkpoint(checkpoint, _SITE)
    fingerprint = _fingerprint(source, k, b, int(max_epochs), seed,
                               float(window), float(reassignment_ratio),
                               float(tol), max_no_improvement, init)
    resumed_from = 0
    loaded = None
    if ckpt is not None:
        loaded = load_stream_state(ckpt.path, state, fingerprint)
    if loaded is not None:
        state = loaded[0]
        resumed_from = int(loaded[1])
        for name in ("centers", "counts", "prev_centers"):
            state[name] = torch.from_numpy(
                np.ascontiguousarray(state[name])).to(dev)
        _obs.gauge("resilience.resume_cursor", resumed_from, site=_SITE)
        _obs.counter_add("resilience.resumed_passes", 1)
    else:
        state["centers"] = _init_centers(source, k, b, seed, init, dev)
        state["counts"] = torch.zeros(k, dtype=torch.float32, device=dev)
        state["prev_centers"] = torch.full((k, m), float("nan"),
                                           dtype=torch.float32, device=dev)
    ewa = _EwaFold(state, 2.0 * b / (n + 1))

    every = ckpt.every if ckpt is not None else 0
    writer = None
    if every and _knobs.get_bool("SQ_OOC_ASYNC_CKPT"):
        writer = AsyncStreamCheckpointer(ckpt.path)
    upload = _BatchUploader(dev, b * m * 4)
    stop = False
    try:
        with _obs.span("oocore.minibatch_fit", n=n, m=m, k=k,
                       n_batches=n_batches, device=dev.type,
                       resumed_from=resumed_from or None), \
                _obs.guarantees.no_audit():
            for epoch in range(int(state["epoch"]), int(max_epochs)):
                with _obs.span("oocore.epoch", epoch=epoch):
                    for bi, Xb in plan.iter_batches(source, epoch,
                                                    int(state["batch"])):
                        if _faults._active is not None:
                            # the batch-boundary interrupt hook
                            _faults._active.on_tile(int(state["step"]))
                        centers, counts, inertia = batch_step(
                            dev, Xb, state["centers"], state["counts"],
                            int(state["step"]), seed=seed, epoch=epoch,
                            batch=bi, window=window,
                            reassignment_ratio=reassignment_ratio,
                            upload=upload)
                        state["centers"], state["counts"] = centers, counts
                        ewa.add(inertia)
                        state["step"] = state["step"] + 1
                        state["batch"] = np.asarray(bi + 1, np.int64)
                        if (every and int(state["step"]) % every == 0
                                and not (epoch == int(max_epochs) - 1
                                         and bi + 1 >= n_batches)):
                            ewa.fold()
                            if writer is not None:
                                writer.submit(state, int(state["step"]),
                                              fingerprint)
                            else:
                                save_stream_state(ckpt.path, state,
                                                  int(state["step"]),
                                                  fingerprint)
                ewa.fold()
                if verbose:
                    print(f"oocore epoch {epoch + 1}: "
                          f"ewa inertia {float(state['ewa']):.3f}")
                if (max_no_improvement is not None
                        and int(state["no_improve"]) >= max_no_improvement):
                    stop = True
                prev = state["prev_centers"]
                if tol > 0 and not bool(torch.isnan(prev).all()):
                    shift = float(torch.sum((state["centers"] - prev) ** 2))
                    if shift <= tol:
                        stop = True
                state["prev_centers"] = state["centers"]
                state["epoch"] = np.asarray(epoch + 1, np.int64)
                state["batch"] = np.zeros((), np.int64)
                if stop:
                    break
    except BaseException:
        upload.close()
        if writer is not None:
            # drain so the interrupt leaves its newest snapshot behind,
            # without letting a writer error mask the real failure
            try:
                writer.close()
            except Exception:
                pass
        raise
    upload.close()
    if writer is not None:
        writer.close()  # drain BEFORE deletion: no resurrecting write
        _obs.counter_add("oocore.async_ckpt_writes", writer.writes)
        _obs.counter_add("oocore.async_ckpt_dropped", writer.dropped)
    if ckpt is not None:
        # a finished fit leaves no snapshot a rerun could resume
        for path in (ckpt.path, str(ckpt.path) + ".prev"):
            if os.path.exists(path):
                os.remove(path)
    return {
        "centers": state["centers"].cpu().numpy(),
        "counts": state["counts"].cpu().numpy(),
        "n_epochs": int(state["epoch"]),
        "n_steps": int(state["step"]),
        "ewa": float(state["ewa"]),
        "resumed_from": resumed_from,
    }


def assign_labels(source, centers, *, batch_rows=8192, device=None):
    """Label every row of ``source`` in natural order under ``centers``:
    ``(labels (n,) int32, inertia float)``. The rows stream through the
    streaming engine in tiles of ``batch_rows`` rows (read ahead, checked,
    uploaded through the pinned ring) and each tile is one launch of the
    fused Lloyd kernel at one restart and window 0; the tail tile is
    padded to its bucket at weight 0. Nothing stays resident beyond the
    tiles in flight, the (n,) labels and the per-tile inertias, which the
    host reads once at the end and sums in tile order."""
    from ..ops.kernels import lloyd_step
    from ..streaming import stream_tiles

    dev = resolve_device(device)
    n, m = source.shape
    rows = min(int(batch_rows), n)
    C = torch.as_tensor(np.ascontiguousarray(centers, np.float32),
                        device=dev)[None]
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    inertias = []
    ids = torch.arange(rows, device=dev)
    with _obs.span("oocore.assign_labels", n=n, m=m, device=dev.type):
        for tile, n_valid, start in stream_tiles(
                source, rows * (source.nbytes // max(1, n)), dev,
                site="oocore.assign_labels"):
            tile = tile.float()
            w = (ids[:tile.shape[0]] < n_valid).float()
            xsq = torch.sum(tile * tile, dim=1)
            lab, _, _, _, inertia = lloyd_step(tile, w, xsq, C)
            labels[start:start + n_valid] = lab[0, :n_valid]
            inertias.append(inertia[0])
        total = 0.0
        for value in torch.stack(inertias).cpu().numpy().tolist():
            total += value
    return labels.cpu().numpy(), total
