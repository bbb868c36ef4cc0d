"""Streaming tiled-ingestion engine: double-buffered host→device row tiles
with on-device accumulation (counterpart of ``sq_learn_tpu/streaming.py``).

Host data is walked in row tiles of at most :func:`stream_tile_bytes`
bytes, so no single upload exceeds the cap, and the consumers accumulate
on the device tile by tile:

- **fixed-byte row tiles**: the tile plan (:func:`plan_row_tiles`) and the
  zero-padded tail buckets (:func:`bucket_rows`) are the JAX package's.
  Eager torch compiles nothing per shape, but the plan fixes the tile
  boundaries, so the accumulation order is the JAX package's and a
  stream-state checkpoint's cursor means the same tile in both packages.
- **double buffering through pinned memory** (on a CUDA device): each tile
  is copied into one slot of a small ring of pinned host buffers, kept per
  process and sized to the tile cap, by a few threads at once (one
  thread's memcpy is slower than the DMA), and uploaded with
  ``copy_(…, non_blocking=True)`` on a dedicated copy stream; a tail
  tile's padding rows are zeroed on the card. Tile *i+1*
  is staged before tile *i* is yielded; the consumer's stream waits on
  tile *i*'s copy event, never on the whole device, and the host waits
  on a slot's previous copy event before it writes the slot again. The
  tile tensor is allocated on the copy stream and marked used on the
  consumer's stream (``record_stream``), so the caching allocator cannot
  hand its memory out again before the consumer has read it.
- **no host sync between tiles**: accumulators update in place on the
  device; :func:`stream_map_rows` keeps each tile's result on the device
  and the caller fetches once.

Every tile's upload runs under the transfer supervisor
(:mod:`sq_learn_tpu_torch.resilience.supervisor`: retries with keyed
backoff, per-tile deadline, breaker accounting), and armed fault
injectors (``SQ_FAULTS``) hook the tile boundary and the put. Fold passes
are **resumable**: with a checkpoint configured (``SQ_STREAM_CKPT_DIR``,
or an explicit :class:`StreamCheckpoint`), the accumulator and the tile
cursor are saved every ``SQ_STREAM_CKPT_EVERY`` tiles by an
:class:`~sq_learn_tpu_torch.utils.checkpoint.AsyncStreamCheckpointer`,
and a rerun of the same pass resumes at the cursor, bit-identical to an
uninterrupted pass. ``SQ_RESILIENCE_STRICT=1`` syncs and checks the
accumulator after every tile and raises
:class:`~sq_learn_tpu_torch.resilience.supervisor.NonFiniteAccumulatorError`
with the tile's provenance.

Validation: the estimators' streamed routes check the shape and dtype of
host input on the host and pass ``validate=True``, which checks every
tile's values on the card and raises ``ValueError("Input contains NaN or
infinity.")`` after the pass (one sync, at its end).

Row sources: every consumer here also takes an out-of-core row source
(:func:`is_row_source`, a :class:`~sq_learn_tpu_torch.oocore.ShardStore`):
each tile is then read from disk by ``read_rows`` (supervised,
CRC-checked shard reads) through the store's bounded readahead view
(``prefetched()``), which starts at the first row asked for, so a
resumed pass never reads the shards before its cursor. A store-backed
fold's checkpoint is keyed on the store's content-complete fingerprint.

The mesh variant, each tile's rows split over a mesh's shards, is
:mod:`sq_learn_tpu_torch.parallel.streaming`. Not ported: the per-kernel
compile budgets and XLA cost records (an eager program compiles
nothing).
"""

import functools
import math
import os
import threading

import numpy as np
import torch

from . import _knobs
from . import obs as _obs
from ._config import resolve_device
from .resilience import faults as _faults
from .resilience import supervisor as _sup
from .oocore.store import is_source
from .utils.checkpoint import tree_leaves, tree_map
from .utils.validation import host_array

__all__ = [
    "StreamCheckpoint",
    "bucket_rows",
    "is_row_source",
    "padded_rows",
    "plan_row_tiles",
    "stream_fold",
    "stream_map_rows",
    "stream_tile_bytes",
    "stream_tiles",
    "streamed_centered_gram",
    "streamed_centered_svd_topk",
    "streamed_kmeans_plusplus",
    "streamed_prestats",
    "streamed_randomized_svd",
    "streamed_resident_put",
    "streamed_spectral_stats",
    "worth_streaming",
]

_TORCH_DTYPES = {np.dtype(d): torch.from_numpy(np.zeros(0, d)).dtype
                 for d in (np.float32, np.float64, np.float16, np.int64,
                           np.int32, np.int16, np.int8, np.uint8, np.bool_)}


def stream_tile_bytes():
    """Per-tile transfer cap in bytes: ``SQ_STREAM_TILE_BYTES`` when set,
    else ``SQ_TRANSFER_CHUNK_BYTES`` (128 MiB)."""
    env = _knobs.get_raw("SQ_STREAM_TILE_BYTES")
    if env is not None:
        return int(env)
    return _knobs.get_int("SQ_TRANSFER_CHUNK_BYTES")


#: True for out-of-core row sources (the shard-store protocol:
#: ``shape``/``dtype``/``nbytes``/``fingerprint``/``read_rows``)
is_row_source = is_source


def worth_streaming(X, max_bytes=None):
    """True when ``X`` is host data larger than the per-tile transfer cap —
    the 'auto' engagement rule every streamed consumer shares. A tensor is
    already placed (the JAX package's ``jax.Array`` rule: the estimators
    hand host input over as numpy); a shard-store source always
    streams."""
    if isinstance(X, torch.Tensor):
        return False
    if is_row_source(X):
        return True
    nbytes = getattr(X, "nbytes", None)
    if nbytes is None:
        return False
    return nbytes > (stream_tile_bytes() if max_bytes is None else max_bytes)


def _bucket_rows(n, full_rows, multiple=1, min_rows=None):
    """Bucketed row count for a tile holding ``n`` valid rows: the full
    tile size for full tiles, else the smallest power of two ≥ n (floored
    at ``min_rows``, default ``SQ_STREAM_MIN_BUCKET_ROWS``, capped at the
    full tile size), rounded up to a ``multiple``."""
    if n >= full_rows:
        return full_rows
    b = (_knobs.get_int("SQ_STREAM_MIN_BUCKET_ROWS") if min_rows is None
         else int(min_rows))
    while b < n:
        b <<= 1
    b = -(-b // multiple) * multiple
    return min(b, full_rows)


def bucket_rows(n, full_rows, multiple=1, min_rows=None):
    """The padded row count a tile of ``n`` valid rows is staged at;
    ``min_rows`` floors the tail buckets per call."""
    return _bucket_rows(int(n), int(full_rows), multiple, min_rows)


def plan_row_tiles(n_rows, row_bytes, max_bytes=None, multiple=1):
    """(rows_per_tile, n_tiles) for streaming ``n_rows`` rows of
    ``row_bytes`` each under the per-tile byte cap."""
    if max_bytes is None:
        max_bytes = stream_tile_bytes()
    rows = max(1, int(max_bytes) // max(1, int(row_bytes)))
    rows = min(rows, int(n_rows))
    rows = max(multiple, rows // multiple * multiple)
    n_tiles = -(-int(n_rows) // rows)
    return rows, n_tiles


def padded_rows(n_rows, row_bytes, max_bytes=None, multiple=1):
    """Total row count including the tail tile's bucket padding — the size
    of a row-output buffer the tail tile's write must fit in."""
    rows, _ = plan_row_tiles(n_rows, row_bytes, max_bytes, multiple)
    tail = n_rows % rows
    if not tail:
        return n_rows
    return n_rows + (_bucket_rows(tail, rows, multiple) - tail)


def _row_bytes(X):
    n = X.shape[0]
    return X.nbytes // max(1, n)


def _source_dtype(X):
    """The host dtype tiles of row source ``X`` are staged in: the
    source's own, a 64-bit one narrowed as :func:`host_array` narrows
    host arrays."""
    if X.dtype.kind != "f":
        return np.dtype(X.dtype)
    return host_array(np.zeros(0, X.dtype)).dtype


def _rows_input(X):
    """``X`` as the streaming engine walks it: a row source as it is,
    anything else as a canonical host array."""
    return X if is_row_source(X) else host_array(X)


def _torch_dtype(X):
    """The torch dtype of the tiles of ``X`` (a host array or a row
    source)."""
    dtype = _source_dtype(X) if is_row_source(X) else X.dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


# ---------------------------------------------------------------------------
# The pinned staging ring
# ---------------------------------------------------------------------------


class _PinnedRing:
    """Two pinned host slots and, per slot, the event of the last copy out
    of it."""

    SLOTS = 2

    def __init__(self, nbytes):
        # a failed pinned allocation raises here, before any tile moves
        self.buffers = [torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
                        for _ in range(self.SLOTS)]
        self.events = [None] * self.SLOTS
        self.nbytes = nbytes


_ring_lock = threading.Lock()
_free_rings = []
_copy_streams = {}


def _acquire_ring(nbytes):
    """A free pinned ring of at least ``nbytes`` per slot (the process keeps
    released rings for the next pass)."""
    with _ring_lock:
        for i, ring in enumerate(_free_rings):
            if ring.nbytes >= nbytes:
                return _free_rings.pop(i)
        # a larger cap replaces the smaller rings kept so far
        _free_rings.clear()
    return _PinnedRing(nbytes)


def _release_ring(ring):
    with _ring_lock:
        _free_rings.append(ring)


def _copy_stream(device):
    """The dedicated host→device copy stream of ``device``."""
    with _ring_lock:
        stream = _copy_streams.get(device)
        if stream is None:
            stream = _copy_streams[device] = torch.cuda.Stream(device)
        return stream


_stage_pool = None

#: a host copy into a pinned slot is split over threads in chunks of at
#: least this many bytes
_STAGE_CHUNK_BYTES = 4 << 20


def _staging_copy(dst, src):
    """``dst[...] = src`` for row-major arrays, split by rows over a
    process-wide thread pool (numpy releases the GIL while it copies): one
    thread's memcpy into pinned memory does not keep up with the DMA."""
    global _stage_pool
    workers = min(8, os.cpu_count() or 1)
    parts = min(workers, max(1, src.nbytes // _STAGE_CHUNK_BYTES))
    if parts == 1:
        np.copyto(dst, src)
        return
    with _ring_lock:
        if _stage_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _stage_pool = ThreadPoolExecutor(workers,
                                             thread_name_prefix="sq-stage")
    step = -(-src.shape[0] // parts)
    for done in [_stage_pool.submit(np.copyto, dst[i:i + step],
                                    src[i:i + step])
                 for i in range(0, src.shape[0], step)]:
        done.result()


class _CudaStager:
    """The default put on a CUDA device: host tile → pinned slot →
    non-blocking copy on the copy stream, the bucket's padding rows zeroed
    on the card. Returns the device tile and the copy's event."""

    def __init__(self, device, slot_bytes):
        self.device = device
        self.ring = _acquire_ring(slot_bytes)
        self.stream = _copy_stream(device)
        self.consumer = torch.cuda.current_stream(device)
        self.slot = 0

    def __call__(self, tile, rows):
        """Stage the host rows ``tile`` as a device tile of ``rows`` rows
        (its bucket)."""
        ring, j = self.ring, self.slot
        self.slot = (j + 1) % ring.SLOTS
        prev = ring.events[j]
        if prev is not None:
            prev.synchronize()  # the copy out of this slot has finished
        src = ring.buffers[j][:tile.nbytes].view(
            _TORCH_DTYPES[tile.dtype]).view(tile.shape)
        _staging_copy(src.numpy(), tile)  # the host write into the slot
        valid = tile.shape[0]
        with torch.cuda.stream(self.stream):
            dev_tile = torch.empty((rows,) + tile.shape[1:],
                                   dtype=src.dtype, device=self.device)
            dev_tile[:valid].copy_(src, non_blocking=True)
            if rows > valid:
                dev_tile[valid:].zero_()
            event = torch.cuda.Event()
            event.record(self.stream)
        ring.events[j] = event
        dev_tile.record_stream(self.consumer)
        return dev_tile, event

    def close(self):
        _release_ring(self.ring)


def _cpu_put(tile):
    """The default put on the CPU: the host tile as a tensor."""
    return torch.from_numpy(tile if tile.flags.writeable else tile.copy())


def stream_tiles(X, max_bytes=None, device=None, put=None, multiple=1,
                 site=None, start_tile=0):
    """Yield ``(dev_tile, n_valid, start)`` over the row tiles of host
    array ``X``, double-buffered: tile *i+1* is staged before tile *i* is
    yielded, and nothing blocks between tiles. ``X`` may be a row source:
    its tiles are read by ``read_rows`` through its ``prefetched()`` view
    when it has one.

    Tiles are zero-padded to bucketed row counts; ``n_valid`` is the true
    row count of each tile and ``start`` its row offset in ``X``. ``put``
    overrides the placement callable (``put(host_tile) → tensor``); the
    default stages through the pinned ring on a CUDA device and wraps the
    host tile on the CPU. Each placement runs under the transfer
    supervisor, and armed fault injectors hook the tile boundary.
    ``start_tile`` skips the leading tiles without staging them (resume).
    With obs on, each tile's bytes feed the ``streaming.transfer_bytes``
    and ``streaming.tiles`` counters.
    """
    source = is_row_source(X)
    view = None
    if source:
        canonical = _source_dtype(X)
        if hasattr(X, "prefetched"):
            # disk-backed stores read their shards ahead on worker
            # threads; the view starts at the first row asked for, so a
            # resume's skipped tiles never read their shards
            wrapped = X.prefetched()
            if wrapped is not X:
                X = view = wrapped
    else:
        X = host_array(X)
    dev = resolve_device(device)
    n = X.shape[0]
    rows, n_tiles = plan_row_tiles(n, _row_bytes(X), max_bytes, multiple)
    stager = None
    if put is None:
        if dev.type == "cuda":
            stager = put = _CudaStager(dev, rows * _row_bytes(X))
        else:
            put = _cpu_put
    observing = _obs.enabled()

    def staged(i):
        if _faults._active is not None:
            _faults._active.on_tile(i)  # mid-pass abort injection point
        start = i * rows
        stop = min(start + rows, n)
        valid = stop - start
        bucket = _bucket_rows(valid, rows, multiple)
        if source:
            tile = X.read_rows(start, stop)
            if tile.dtype != canonical:
                tile = tile.astype(canonical)
        else:
            tile = X[start:stop]
        if stager is not None:
            # the stager pads on the card: no host copy of the tail
            place = functools.partial(stager, rows=bucket)
        else:
            place = put
            if valid < bucket:
                pad = np.zeros((bucket - valid,) + tuple(X.shape[1:]),
                               tile.dtype)
                tile = np.concatenate([tile, pad], axis=0)
        if observing:
            _obs.counter_add("streaming.transfer_bytes",
                             bucket * _row_bytes(X))
            _obs.counter_add("streaming.tiles", 1)
        return _sup.put(place, tile, i, site=site), valid, start

    def ready(placed):
        if stager is None:
            return placed
        dev_tile, event = placed
        stager.consumer.wait_event(event)
        return dev_tile

    try:
        if start_tile >= n_tiles:
            return
        nxt = staged(start_tile)
        for i in range(start_tile, n_tiles):
            placed, valid, start = nxt
            if i + 1 < n_tiles:
                # stage tile i+1 before the consumer queues tile i's work:
                # its upload rides under that work
                nxt = staged(i + 1)
            yield ready(placed), valid, start
    finally:
        if stager is not None:
            stager.close()
        if view is not None:
            view.close()  # joins the readahead workers, closes its span


class StreamCheckpoint:
    """Where and how often a fold pass checkpoints: ``path`` is the npz
    file, ``every`` the tile period between snapshots. Passing one to
    :func:`stream_fold` overrides the env-derived default
    (``SQ_STREAM_CKPT_DIR``/``SQ_STREAM_CKPT_EVERY``)."""

    __slots__ = ("path", "every")

    def __init__(self, path, every=None):
        self.path = str(path)
        self.every = int(_knobs.get_int("SQ_STREAM_CKPT_EVERY")
                         if every is None else every)
        if self.every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")


def _data_digest(Xn, max_rows=64):
    """CRC32 over an evenly strided sample of up to ``max_rows`` rows
    (first and last included) — the JAX package's fingerprint of a pass's
    input, so a checkpoint resumes only a rerun over the same data."""
    import zlib

    n = Xn.shape[0]
    idx = np.unique(np.linspace(0, max(n - 1, 0), num=min(n, max_rows),
                                dtype=np.int64))
    return zlib.crc32(np.ascontiguousarray(Xn[idx]).tobytes())


def _resolve_checkpoint(checkpoint, site):
    """An explicit ``checkpoint`` wins; else ``SQ_STREAM_CKPT_DIR`` plus a
    ``site`` derives ``<dir>/<site with dots → underscores>.npz``; else
    off. ``checkpoint=False`` opts out even of the env default."""
    if checkpoint is False:
        return None
    if checkpoint is not None:
        if isinstance(checkpoint, StreamCheckpoint):
            return checkpoint
        return StreamCheckpoint(checkpoint)
    ckpt_dir = _knobs.get_raw("SQ_STREAM_CKPT_DIR")
    if not ckpt_dir or site is None:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    return StreamCheckpoint(
        os.path.join(ckpt_dir, site.replace(".", "_") + ".npz"))


def _check_finite(acc, site, tile_index, start, n_valid):
    """Sync the accumulator and raise with tile provenance on the first
    non-finite value (``SQ_RESILIENCE_STRICT=1`` only)."""
    for j, leaf in enumerate(tree_leaves(acc)):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise _sup.NonFiniteAccumulatorError(
                f"non-finite accumulator leaf {j} after tile {tile_index} "
                f"(rows {start}..{start + n_valid}) of pass "
                f"{site or '<unnamed>'}")


class _FiniteCheck:
    """The streamed routes' input validation: one device flag ANDed over
    every tile, read once at the end of the pass."""

    def __init__(self):
        self.ok = None

    def add(self, tile):
        if tile.is_floating_point():
            flag = torch.isfinite(tile).all()
            self.ok = flag if self.ok is None else self.ok & flag

    def raise_if_bad(self):
        if self.ok is not None and not bool(self.ok):
            raise ValueError("Input contains NaN or infinity.")


def _restore_leaf(host, like):
    """A checkpointed host leaf placed like its ``init`` counterpart."""
    return torch.from_numpy(np.ascontiguousarray(host)).to(
        device=like.device, dtype=like.dtype)


def stream_fold(X, step, init, *, max_bytes=None, device=None, put=None,
                multiple=1, with_offsets=False, site=None, checkpoint=None,
                pass_tag=None, validate=False):
    """Fold an accumulator over the row tiles of ``X`` (a host array or a
    row source).

    ``step(acc, tile)`` (or ``step(acc, tile, n_valid, start)`` with
    ``with_offsets=True``) returns the new accumulator and may update it in
    place. Tiles arrive zero-padded to bucket shapes: steps that sum over
    rows need no masking, steps that need the true count take
    ``with_offsets``. ``init`` is a tree (tuples, lists, dicts) of tensors
    moved to ``device``.

    With a checkpoint configured (explicit ``checkpoint=`` or
    ``SQ_STREAM_CKPT_DIR`` + ``site``) the pass is **resumable**: every
    ``every`` tiles the accumulator is snapshotted (a device copy, written
    by a worker thread) with the tile cursor; a rerun of the same pass —
    same site, data digest, dtype, tile plan and ``pass_tag`` — resumes at
    the cursor, skipping the folded uploads. A mismatched checkpoint is
    ignored. Consumers that run several folds over the same site and data
    pass a distinct ``pass_tag`` per fold. ``checkpoint=False`` opts out
    of the env default (folds whose accumulator holds a dataset-sized
    buffer). A completed pass deletes its checkpoint. ``validate`` checks
    every tile's values (see the module docstring). A row source's pass is
    keyed on the source's content-complete fingerprint instead of the
    sampled digest of a host array.
    """
    Xn = _rows_input(X)
    dev = resolve_device(device)
    acc = tree_map(lambda a: a.to(dev), init)
    strict = _knobs.get_bool("SQ_RESILIENCE_STRICT")
    ckpt = _resolve_checkpoint(checkpoint, site)
    finite = _FiniteCheck() if validate else None
    start_tile = 0
    n_tiles = fingerprint = writer = None
    if ckpt is not None:
        from .utils.checkpoint import AsyncStreamCheckpointer, \
            load_stream_state

        n = Xn.shape[0]
        rows, n_tiles = plan_row_tiles(n, _row_bytes(Xn), max_bytes,
                                       multiple)
        data = (f"store:{Xn.fingerprint}" if is_row_source(Xn)
                else f"{_data_digest(Xn):08x}")
        fingerprint = (f"v2|{site}|tag={pass_tag}|shape={tuple(Xn.shape)}"
                       f"|dtype={Xn.dtype}|rows={rows}|multiple={multiple}"
                       f"|data={data}")
        loaded = load_stream_state(ckpt.path, acc, fingerprint)
        if loaded is not None:
            host_acc, start_tile = loaded
            it = iter(tree_leaves(host_acc))
            acc = tree_map(lambda like: _restore_leaf(next(it), like), acc)
            _obs.gauge("resilience.resume_cursor", start_tile, site=site)
            _obs.counter_add("resilience.resumed_passes", 1)
        writer = AsyncStreamCheckpointer(ckpt.path)
    try:
        with _obs.span("streaming.stream_fold", site=site,
                       resumed_from=start_tile or None):
            i = start_tile
            for tile, n_valid, start in stream_tiles(
                    Xn, max_bytes, dev, put, multiple, site=site,
                    start_tile=start_tile):
                if finite is not None:
                    finite.add(tile)
                if with_offsets:
                    acc = step(acc, tile, n_valid, start)
                else:
                    acc = step(acc, tile)
                i += 1
                if strict:
                    _check_finite(acc, site, i - 1, start, n_valid)
                if writer is not None and i < n_tiles \
                        and i % ckpt.every == 0:
                    writer.submit(acc, i, fingerprint)
    finally:
        if writer is not None:
            writer.close()  # drains: an interrupted pass keeps its file
    if finite is not None:
        finite.raise_if_bad()
    if ckpt is not None:
        # a finished pass must not leave a snapshot a later same-tagged
        # pass could resume, the fallback copy included
        for stale in (ckpt.path, str(ckpt.path) + ".prev"):
            if os.path.exists(stale):
                os.remove(stale)
    return acc


def stream_map_rows(X, fn, *, max_bytes=None, device=None, put=None,
                    multiple=1, with_offsets=False, site=None,
                    validate=False):
    """Apply a row-wise ``fn(tile)`` to every tile and assemble the
    row-aligned outputs on the device — the streamed-inference primitive
    (labels, neighbor lists): tile *i+1* uploads while ``fn`` runs on tile
    *i*; each tile's output stays on the device and is cut to its valid
    rows, and the caller fetches the whole once. ``fn`` may return a tensor
    or a tuple of tensors whose leading axis is the tile's rows; with
    ``with_offsets`` it is called as ``fn(tile, start)``."""
    finite = _FiniteCheck() if validate else None
    outs = []
    with _obs.span("streaming.stream_map_rows", site=site):
        for tile, n_valid, start in stream_tiles(X, max_bytes, device, put,
                                                 multiple, site=site):
            if finite is not None:
                finite.add(tile)
            out = fn(tile, start) if with_offsets else fn(tile)
            if isinstance(out, tuple):
                outs.append(tuple(o[:n_valid] for o in out))
            else:
                outs.append(out[:n_valid])
    if finite is not None:
        finite.raise_if_bad()
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[j] for o in outs])
                     for j in range(len(outs[0])))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# Accumulation steps (in place on the accumulator)
# ---------------------------------------------------------------------------


def _gram_colsum_step(acc, tile):
    """acc = (G, colsum) ← (G + tileᵀ·tile, colsum + Σrows). Zero-padded
    rows contribute nothing to either sum."""
    G, colsum = acc
    G.addmm_(tile.T, tile)
    colsum.add_(torch.sum(tile, dim=0))
    return acc


def _colsum_step(acc, tile):
    """acc ← acc + Σrows (the randomized SVD's centering pass)."""
    return acc.add_(torch.sum(tile, dim=0))


def _ingest_step(acc, tile, n_valid, start):
    """Resident assembly plus column sums / square-sums: the tile's rows
    are written into the device buffer in place."""
    buf, colsum, sqsum = acc
    buf[start:start + tile.shape[0]].copy_(tile)
    colsum.add_(torch.sum(tile, dim=0))
    sqsum.add_(torch.sum(tile * tile, dim=0))
    return acc


def _assemble_step(acc, tile, n_valid, start):
    """Pure resident assembly: the tile written into the device buffer."""
    acc[start:start + tile.shape[0]].copy_(tile)
    return acc


def _kpp_score_step(acc, tile, n_valid, start, cand, closest, weights):
    """One tile of a streamed k-means++ scoring round: distances of the
    trial candidates ``cand`` (T, m) to the tile's rows, the would-be
    closest-D² update against ``closest``, and the per-trial weighted
    potential partials (padding rows carry weight 0)."""
    buf, pots = acc
    rows = tile.shape[0]
    xsq = torch.sum(tile * tile, dim=1)
    c_sq = torch.sum(cand * cand, dim=1)
    d2 = torch.clamp(xsq[None, :] + c_sq[:, None] - 2.0 * (cand @ tile.T),
                     min=0.0)
    nc = torch.minimum(closest[start:start + rows][None, :], d2)
    buf[:, start:start + rows] = nc
    pots.add_(torch.sum(nc * weights[start:start + rows][None, :], dim=1))
    return acc


def _sketch_cheap_step(acc, tile):
    """One tile of the sketch's cheap pass: running max row sq-norm (η),
    column square-sum partials and max |entry|."""
    eta, colsq, amax = acc
    sq = tile * tile
    return (torch.maximum(eta, torch.max(torch.sum(sq, dim=1))),
            colsq.add_(torch.sum(sq, dim=0)),
            torch.maximum(amax, torch.max(torch.abs(tile))))


def _matmul_accum_step(acc, tile, Q):
    """acc ← acc + tileᵀ·(tile·Q) — one power-iteration pass of the
    Gram-based range finder."""
    return acc.addmm_(tile.T, tile @ Q)


def _project_rows_step(acc, tile, n_valid, start, Q):
    """acc[start:start+rows] ← tile·Q."""
    torch.matmul(tile, Q, out=acc[start:start + tile.shape[0]])
    return acc


def _qtb_step(acc, tile, n_valid, start, Qn):
    """acc ← acc + Qn[start:start+rows]ᵀ·tile — the B = Qᵀ·A pass; the
    zero-padded tile rows pair with zero-padded rows of Qn."""
    return acc.addmm_(Qn[start:start + tile.shape[0]].T, tile)


# ---------------------------------------------------------------------------
# Consumers
# ---------------------------------------------------------------------------


def streamed_centered_gram(X, *, max_bytes=None, device=None,
                           checkpoint=None, validate=False):
    """(mean, G_centered, n) of host data, built tile by tile: one pass
    accumulates the raw Gram and the column sums, and the centered Gram
    follows from ``Xcᵀ·Xc = XᵀX − n·mean·meanᵀ``. X is never resident on
    the device. ``checkpoint`` (or ``SQ_STREAM_CKPT_DIR``) makes the pass
    resumable. ``X`` may be a row source."""
    X = _rows_input(X)
    n, m = X.shape
    dev = resolve_device(device)
    dtype = _torch_dtype(X)
    init = (torch.zeros((m, m), dtype=dtype, device=dev),
            torch.zeros((m,), dtype=dtype, device=dev))
    with _obs.span("streaming.centered_gram", n=n, m=m):
        G, colsum = stream_fold(X, _gram_colsum_step, init,
                                max_bytes=max_bytes, device=dev,
                                site="streaming.gram_colsum",
                                checkpoint=checkpoint, validate=validate)
        mean = colsum / n
        Gc = G - n * torch.outer(mean, mean)
    return mean, Gc, n


def streamed_centered_svd_topk(X, n_left, *, compute_dtype=None,
                               max_bytes=None, device=None, validate=False):
    """Streamed twin of :func:`~sq_learn_tpu_torch.ops.linalg.
    centered_svd_topk`: (mean, Uk, S, Vt) of a tall host matrix via the
    tiled centered Gram, materializing only the first ``n_left`` columns
    of U. Two passes: (1) Gram + column mean, (2) the (n, k) U block
    assembled into a device buffer. ``compute_dtype`` applies to the U
    block's product (operands rounded, products accumulated in X's dtype);
    the Gram pass accumulates in the input dtype, as in the JAX package.
    ``X`` may be a row source."""
    from .ops.linalg import gram_spectrum, inner_product, svd_flip_v

    X = _rows_input(X)
    n, m = X.shape
    dev = resolve_device(device)
    mean, Gc, _ = streamed_centered_gram(X, max_bytes=max_bytes,
                                         device=dev, validate=validate)
    S, V, safe = gram_spectrum(Gc)
    _, Vt = svd_flip_v(None, V.T)
    k = int(n_left)
    Vk = Vt[:k].contiguous()
    div = safe[None, :k]

    def step(acc, tile, n_valid, start):
        # the padded rows are sliced off: they would project to −mean·V
        tc = tile[:n_valid] - mean
        acc[start:start + n_valid] = inner_product(tc, Vk,
                                                   compute_dtype) / div
        return acc

    n_pad = padded_rows(n, _row_bytes(X), max_bytes)
    Uk = stream_fold(X, step, torch.zeros((n_pad, k), dtype=S.dtype,
                                          device=dev),
                     max_bytes=max_bytes, device=dev, with_offsets=True,
                     site="streaming.topk_u", checkpoint=False)
    return mean, Uk[:n], S, Vt


def streamed_randomized_svd(generator, X, n_components, *, n_oversamples=10,
                            n_iter=4, center=False, max_bytes=None,
                            device=None, flip=True, validate=False):
    """Streamed randomized truncated SVD (Halko et al.) of host data: the
    range finder and the power iterations run as tiled passes — per pass,
    one (m, size) accumulation Σ tileᵀ·(tile·Q) — so X is never resident on
    the device. The Gaussian start is drawn from ``generator``.
    ``center=True`` factors X − mean through the rank-one correction.
    Returns (U, S, Vt) — plus ``mean`` when centering — with U (n, k) on
    the device. ``validate`` checks the tiles of the first pass."""
    from .ops.linalg import svd_flip_v

    X = host_array(X)
    n, m = X.shape
    dev = resolve_device(device)
    dtype = torch.from_numpy(X[:0]).dtype
    size = min(int(n_components) + int(n_oversamples), min(n, m))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    mean = None
    if center:
        mean = stream_fold(X, _colsum_step, zeros(m), max_bytes=max_bytes,
                           device=dev, site="streaming.colsum",
                           validate=validate) / n
        validate = False
    Q = torch.randn((m, size), generator=generator, dtype=dtype, device=dev)
    for it in range(max(1, int(n_iter))):
        # pass_tag: the power iterations are same-site, same-data folds
        F = stream_fold(X, lambda acc, tile: _matmul_accum_step(acc, tile, Q),
                        zeros(m, size), max_bytes=max_bytes, device=dev,
                        site="streaming.matmul_accum",
                        pass_tag=f"power_iter_{it}", validate=validate)
        validate = False
        if center:
            F = F - n * torch.outer(mean, mean @ Q)
        Q, _ = torch.linalg.qr(F)

    n_pad = padded_rows(n, _row_bytes(X), max_bytes)
    Y = stream_fold(
        X, lambda acc, tile, nv, st: _project_rows_step(acc, tile, nv, st, Q),
        zeros(n_pad, size), max_bytes=max_bytes, device=dev,
        with_offsets=True, site="streaming.project_rows", checkpoint=False)
    if center:
        Y = Y - (mean @ Q)[None, :]
    # the zero-padded rows of Y must not enter the QR basis
    if n_pad > n:
        Y[n:] = 0.0
    Qn, _ = torch.linalg.qr(Y)  # (n_pad, size); padded rows stay zero
    B = stream_fold(
        X, lambda acc, tile, nv, st: _qtb_step(acc, tile, nv, st, Qn),
        zeros(size, m), max_bytes=max_bytes, device=dev, with_offsets=True,
        site="streaming.qtb")
    if center:
        B = B - torch.outer(torch.sum(Qn[:n], dim=0), mean)
    Uhat, S, Vt = torch.linalg.svd(B, full_matrices=False)
    U = (Qn @ Uhat)[:n]
    if flip:
        U, Vt = svd_flip_v(U, Vt)
    k = int(n_components)
    out = (U[:, :k], S[:k], Vt[:k])
    return out + (mean,) if center else out


def streamed_kmeans_plusplus(generator, X, n_clusters, *, weights=None,
                             n_local_trials=None, max_bytes=None,
                             device=None):
    """Greedy best-of-trials k-means++ over host data, one streamed pass per
    round: X is never resident on the device, only the (n,) closest-D²
    buffer and the (trials, n) scoring accumulator. Weighted first pick,
    then k−1 rounds of D² sampling keeping the best of ``n_local_trials``
    candidates, every draw from ``generator``. Returns ``(centers (k, m)
    ndarray, indices (k,) ndarray)``."""
    X = host_array(X)
    n, m = X.shape
    dev = resolve_device(device)
    dtype = torch.from_numpy(X[:0]).dtype
    if n_local_trials is None:
        n_local_trials = 2 + int(math.log(n_clusters))
    n_pad = padded_rows(n, _row_bytes(X), max_bytes)
    w = (np.ones(n, X.dtype) if weights is None
         else np.asarray(weights, X.dtype))
    w_dev = torch.from_numpy(np.pad(w, (0, n_pad - n))).to(dev)
    with _obs.span("streaming.kmeans_plusplus", n=n, m=m,
                   n_clusters=int(n_clusters)):
        first = int(torch.multinomial(w_dev[:n], 1, generator=generator))
        indices = [first]
        centers = [np.ascontiguousarray(X[first])]
        closest = torch.full((n_pad,), torch.inf, dtype=dtype, device=dev)

        def score_pass(cand_rows, closest, tag):
            cand = torch.from_numpy(np.ascontiguousarray(cand_rows)).to(dev)
            init = (torch.zeros((cand.shape[0], n_pad), dtype=dtype,
                                device=dev),
                    torch.zeros((cand.shape[0],), dtype=dtype, device=dev))
            return stream_fold(
                X, lambda acc, tile, nv, st: _kpp_score_step(
                    acc, tile, nv, st, cand, closest, w_dev),
                init, max_bytes=max_bytes, device=dev, with_offsets=True,
                site="streaming.kpp_score", checkpoint=False, pass_tag=tag)

        # the seeding pass replicates the first center across the trial
        # axis, so every round scores (trials, n) as the JAX package does
        buf, _ = score_pass(np.broadcast_to(centers[0], (n_local_trials, m)),
                            closest, "round_0")
        closest = buf[0]
        for c in range(1, int(n_clusters)):
            pot = closest * w_dev
            cum = torch.cumsum(pot, dim=0)
            draws = torch.rand((n_local_trials,), generator=generator,
                               dtype=dtype, device=dev) * cum[-1]
            cand_idx = torch.clamp(torch.searchsorted(cum, draws), 0,
                                   n - 1).cpu().numpy()
            cand_rows = np.ascontiguousarray(X[cand_idx])
            buf, pots = score_pass(cand_rows, closest, f"round_{c}")
            best = int(torch.argmin(pots))
            closest = buf[best]
            indices.append(int(cand_idx[best]))
            centers.append(cand_rows[best])
    return np.stack(centers), np.asarray(indices, np.int64)


def streamed_prestats(X, *, quantum=False, mu_grid=(), sketch_idx=None,
                      max_bytes=None, device=None, validate=False):
    """Streamed twin of :func:`~sq_learn_tpu_torch.models.qkmeans.
    fit_prestats`: the device copy assembles tile by tile into one buffer
    (bounded transfers, the upload overlapped with the running column sums
    and square sums), then mean, centering, row norms and the tolerance
    scale finalize on the device. q-means needs the data resident (the
    Lloyd loop sweeps it every iteration): streaming buys the bounded,
    pinned, overlapped uploads. Returns the dict ``fit_prestats`` returns
    (``var_mean`` from the accumulated sums, as in the JAX package).

    ``sketch_idx`` ((s,) sampled row indices, ``quantum`` only) swaps the
    exact σ_min Gram and μ sweep for the sketched components on the
    resident buffer."""
    from .ops.linalg import row_norms, smallest_singular_value
    from .ops.quantum.norms import _mu_grid
    from .sketch.engine import sketch_components

    X = host_array(X)
    n, m = X.shape
    dev = resolve_device(device)
    dtype = torch.from_numpy(X[:0]).dtype
    n_pad = padded_rows(n, _row_bytes(X), max_bytes)
    init = (torch.empty((n_pad, m), dtype=dtype, device=dev),
            torch.zeros((m,), dtype=dtype, device=dev),
            torch.zeros((m,), dtype=dtype, device=dev))
    # checkpoint=False: the accumulator IS the dataset-sized buffer
    buf, colsum, sqsum = stream_fold(X, _ingest_step, init,
                                     max_bytes=max_bytes, device=dev,
                                     with_offsets=True,
                                     site="streaming.ingest",
                                     checkpoint=False, validate=validate)
    Xr = buf[:n]
    out = {}
    if quantum and sketch_idx is not None:
        out["sketch"] = sketch_components(Xr, sketch_idx, mu_grid)
    elif quantum:
        out["eta"] = torch.max(row_norms(Xr, squared=True))
        out["mu_vals"] = _mu_grid(Xr, mu_grid)
        out["frob"] = torch.linalg.norm(Xr)
        out["sigma_min"] = smallest_singular_value(Xr)
    mean = colsum / n
    Xc = Xr - mean
    del buf, Xr
    out.update({
        "mean": mean, "Xc": Xc, "xsq": row_norms(Xc, squared=True),
        "var_mean": torch.mean(torch.clamp(sqsum / n - mean * mean,
                                           min=0.0))})
    return out


def streamed_resident_put(x, device=None, max_bytes=None):
    """Whole-array host→device placement through the streaming engine:
    bounded tiles under the transfer supervisor, staged through the pinned
    ring on the copy stream and written in place into one device buffer.
    Bit-equal to ``torch.from_numpy(x).to(device)`` (floats in the
    configured dtype)."""
    Xn = host_array(x)
    n = Xn.shape[0]
    dev = resolve_device(device)
    n_pad = padded_rows(n, _row_bytes(Xn), max_bytes)
    init = torch.empty((n_pad,) + Xn.shape[1:],
                       dtype=torch.from_numpy(Xn[:0]).dtype, device=dev)
    buf = stream_fold(Xn, _assemble_step, init, max_bytes=max_bytes,
                      device=dev, with_offsets=True,
                      site="streaming.assemble", checkpoint=False)
    return buf[:n] if n_pad > n else buf


def streamed_spectral_stats(X, mu_grid, *, delta_stat=None, sketch="auto",
                            rng=None, max_bytes=None, device=None,
                            audit=False):
    """Out-of-core sketched spectral statistics: only the (s, m) sampled
    rows and the (m,)-sized cheap-pass accumulators live on the device; X
    streams through the ``streaming.sketch_cheap`` pass. A zero budget or a
    shape the sketch does not engage on takes the exact statistics (which
    need X resident). Returns a
    :class:`~sq_learn_tpu_torch.sketch.engine.SpectralStats`."""
    from .sketch import engine as _sk

    X = host_array(X)
    n, m = X.shape
    dev = resolve_device(device)
    if delta_stat is None:
        delta_stat = _sk.sketch_delta_stat()
    rows = _sk.resolve_sketch_rows(n, m, sketch) if delta_stat > 0 else 0
    if not rows:
        return _sk.exact_spectral_stats(torch.from_numpy(X).to(dev),
                                        mu_grid)
    if rng is None:
        rng = np.random.default_rng(0)
    dtype = torch.from_numpy(X[:0]).dtype
    idx = _sk.sample_indices(rng, n, rows)
    with _obs.span("sketch.streamed_stats", n=n, m=m, rows=rows):
        Xs = torch.from_numpy(np.ascontiguousarray(X[idx])).to(dev)
        flat = _sk.sample_kernel(Xs, n / rows, mu_grid=tuple(mu_grid))
        init = (torch.zeros((), dtype=dtype, device=dev),
                torch.zeros((m,), dtype=dtype, device=dev),
                torch.zeros((), dtype=dtype, device=dev))
        eta, colsq, amax = stream_fold(
            X, _sketch_cheap_step, init, max_bytes=max_bytes, device=dev,
            site="streaming.sketch_cheap")
        colsq = colsq.double().cpu().numpy()
        flat = flat.double().cpu().numpy()
        nq = (len(flat) - 1) // 2
        comp = {"eta": float(eta), "frob": float(np.sqrt(colsq.sum())),
                "amax": float(amax), "colsq_max": float(colsq.max()),
                "lam_min": flat[0], "row_fac": flat[1:1 + nq],
                "col_fac": flat[1 + nq:]}
        stats = _sk.finalize_components(comp, n=n, m=m, s=rows,
                                        mu_grid=tuple(mu_grid),
                                        delta_stat=delta_stat)
        _sk.record_sketch_obs(stats)
        if audit:
            _sk.audit_sketch(stats, torch.from_numpy(X).to(dev))
    return stats
