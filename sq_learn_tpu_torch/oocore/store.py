"""Disk-backed shard store: the out-of-core dataset substrate (counterpart
of ``sq_learn_tpu/oocore/store.py``; the on-disk format is the JAX
package's, so a store written by either package opens in the other).

- **shards**: the dataset lives as row-contiguous ``.npy`` files (codec
  ``none``) or codec payloads (codec ``lz4``) of bounded size
  (``SQ_OOC_SHARD_BYTES``, default 8 MiB), materialized one at a time.
- **manifest**: ``manifest.json`` (format ``sq-learn-tpu-oocore-v1``)
  carries shape, dtype, per-shard row counts and CRC-32s, the build-time
  column sums and square sums, and a content-complete fingerprint (a CRC
  over shape, dtype and the ordered per-shard CRCs), so a checkpoint
  keyed on it never resumes over changed data.
- **integrity**: every shard read is CRC-checked against the manifest
  (``SQ_OOC_VERIFY``: ``all``, ``touch`` or ``off``) over the STORED
  bytes, before a compressed payload is decoded; a mismatch quarantines
  the shard and re-reads it up to ``SQ_OOC_REREAD_MAX`` times before
  :class:`ShardCorruptionError` names the shard. Reads run under the
  transfer supervisor
  (:func:`~sq_learn_tpu_torch.resilience.supervisor.supervised_read`:
  retries, backoff, deadline, breaker) and the read fault injectors
  (``SQ_FAULTS``: ``read_fail``, ``read_stall``, ``corrupt_shard``,
  ``cold_tier``).
- **compression** (``SQ_OOC_CODEC=lz4``, default ``none``): per shard the
  best of plain and byte-shuffled LZ4, raw when incompressible
  (:mod:`._codec`); the manifest carries both sizes.
- **generators**: :func:`create_synthetic_store` writes the
  ``synthetic_surrogate`` geometry (``kind="gaussian"``) or MNIST-like
  quantized pixel rows (``kind="pixels"``) shard by shard from an RNG
  keyed on ``(seed, shard)``, on a small thread pool, in bounded RAM.

``SQ_OOC_RAM_BUDGET_BYTES`` (0 = off) bounds every single
materialization: a read larger than the budget raises
:class:`RamBudgetError` instead of paging.

Dtypes follow the JAX package's default canonicalization: a 64-bit input
is written at 32 bits (float64 as float32, int64 as int32) unless the
port is configured for float64 (``set_config(default_dtype="float64")``);
an opened store reads at whatever width its manifest records.

Everything here is host code (numpy and the standard library): it never
touches torch, so the prefetcher's worker threads may run it.
"""

import json
import os
import zlib

import numpy as np

from .. import _knobs
from ._codec import compress_array, crc32, decompress_array

__all__ = [
    "ArraySource",
    "RamBudgetError",
    "ShardCorruptionError",
    "ShardStore",
    "create_synthetic_store",
    "is_source",
    "open_store",
    "store_from_array",
]

MANIFEST = "manifest.json"
FORMAT = "sq-learn-tpu-oocore-v1"

#: 64-bit dtypes and the 32-bit ones the JAX package's canonicalization
#: writes them as (unless the port is configured for float64)
_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.complex128): np.dtype(np.complex64)}


class ShardCorruptionError(RuntimeError):
    """A shard's bytes disagree with its manifest CRC after the bounded
    re-read budget, or a compressed payload fails to decode; the message
    names the shard (index, file, expected and observed CRC)."""


class RamBudgetError(MemoryError):
    """A single materialization would exceed ``SQ_OOC_RAM_BUDGET_BYTES``:
    the out-of-core contract is bounded residency, so a read that needs
    more than the budget in one piece fails instead of paging."""


def shard_bytes_default():
    """Target shard size in bytes (``SQ_OOC_SHARD_BYTES``, 8 MiB)."""
    return _knobs.get_int("SQ_OOC_SHARD_BYTES")


def ram_budget_bytes():
    """Budget of one materialization (``SQ_OOC_RAM_BUDGET_BYTES``; 0 =
    unenforced)."""
    return _knobs.get_int("SQ_OOC_RAM_BUDGET_BYTES")


def verify_mode():
    """CRC policy of shard reads (``SQ_OOC_VERIFY``): ``all`` (every read),
    ``touch`` (first read of each shard in this process) or ``off``."""
    mode = _knobs.get_str("SQ_OOC_VERIFY")
    if mode not in ("all", "touch", "off"):
        raise ValueError(f"SQ_OOC_VERIFY must be all|touch|off, got {mode!r}")
    return mode


def reread_max():
    """Re-reads allowed after a CRC mismatch (``SQ_OOC_REREAD_MAX``, 2)."""
    return _knobs.get_int("SQ_OOC_REREAD_MAX")


def codec_default():
    """Codec of NEW store builds (``SQ_OOC_CODEC``: ``lz4`` or ``none``,
    the default). An opened store always follows its manifest."""
    codec = _knobs.get_str("SQ_OOC_CODEC")
    if codec not in ("lz4", "none"):
        raise ValueError(f"SQ_OOC_CODEC must be lz4|none, got {codec!r}")
    return codec


def canonical_dtype(dtype):
    """The dtype an array of ``dtype`` is stored at: 64-bit types narrow
    to 32 bits unless the configured default dtype is float64 (the JAX
    package's canonicalization without x64)."""
    dtype = np.dtype(dtype)
    if dtype not in _NARROW:
        return dtype
    from .._config import get_config

    if get_config()["default_dtype"] == "float64":
        return dtype
    return _NARROW[dtype]


def _budget_check(nbytes, what):
    budget = ram_budget_bytes()
    if budget and nbytes > budget:
        raise RamBudgetError(
            f"{what} needs {int(nbytes)} bytes in one piece; "
            f"SQ_OOC_RAM_BUDGET_BYTES={budget}")


def _crc(arr):
    """CRC-32 of an array's contiguous bytes (``zlib.crc32`` values).
    Every verified shard read pays one pass of it over the stored
    bytes."""
    return crc32(np.ascontiguousarray(arr))


def _fingerprint(shape, dtype, crcs):
    """Content-complete fingerprint: a CRC over shape, dtype and the
    ordered per-shard CRCs, so any change to any shard's bytes changes
    it."""
    head = f"{FORMAT}|{tuple(shape)}|{dtype}|".encode()
    body = b"".join(int(c).to_bytes(4, "little") for c in crcs)
    return f"{zlib.crc32(head + body) & 0xFFFFFFFF:08x}"


def is_source(obj):
    """True for row sources the streaming engine walks out of core: the
    protocol is ``shape``/``dtype``/``nbytes``/``fingerprint``/
    ``read_rows`` (:class:`ShardStore`, :class:`ArraySource`, or any
    object that has them)."""
    return all(hasattr(obj, a) for a in
               ("shape", "dtype", "nbytes", "fingerprint", "read_rows"))


def _plan_shards(n_rows, row_bytes, shard_bytes=None):
    """(rows_per_shard, n_shards) under the shard byte target."""
    if shard_bytes is None:
        shard_bytes = shard_bytes_default()
    rows = max(1, int(shard_bytes) // max(1, int(row_bytes)))
    rows = min(rows, int(n_rows))
    return rows, -(-int(n_rows) // rows)


def _atomic_json(path, doc):
    """Durable atomic JSON write (temp file, fsync, rename): a killed
    build leaves either no manifest or a complete one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _shard_span(offsets, start):
    """Index of the shard holding row ``start``."""
    return int(np.searchsorted(offsets, start, side="right")) - 1


def _copy_rows(shard_of, offsets, start, stop, out):
    """Fill ``out`` with rows ``[start, stop)``, shard by shard, from
    ``shard_of(i)`` (the materialized shard ``i``)."""
    i = _shard_span(offsets, start)
    pos = start
    while pos < stop:
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        take = min(stop, hi)
        out[pos - start:take - start] = shard_of(i)[pos - lo:take - lo]
        pos = take
        i += 1
    return out


class ShardStore:
    """An opened shard store directory (see the module docstring).

    The row-source protocol (``shape``/``dtype``/``nbytes``/``size``/
    ``fingerprint``/``read_rows``) plus shard-granular access for the
    epoch planner (``n_shards``/``shard_sizes``/``read_shard``). Opening
    reads only the manifest.
    """

    #: disk-backed reads are worth reading ahead (oocore.prefetch);
    #: ArraySource slices are not
    prefetchable = True

    def __init__(self, path, manifest):
        self.path = str(path)
        self.manifest = manifest
        self.shape = (int(manifest["n_rows"]), int(manifest["n_features"]))
        self.dtype = np.dtype(manifest["dtype"])
        self.shard_sizes = [int(s["rows"]) for s in manifest["shards"]]
        self._offsets = np.concatenate(
            [[0], np.cumsum(self.shard_sizes)]).astype(np.int64)
        self.fingerprint = manifest["fingerprint"]
        #: shard codec ("none" for manifests without a codec field)
        self.codec = manifest.get("codec", "none")
        row_bytes = self.shape[1] * self.dtype.itemsize
        #: bytes each shard occupies on disk (the raw bytes for "none")
        self.shard_stored_sizes = [
            int(s.get("stored_bytes", int(s["rows"]) * row_bytes))
            for s in manifest["shards"]]
        #: shards failing their CRC (cleared when a re-read recovers)
        self.quarantined = set()
        self._verified = set()
        self._cache = (None, None)  # (shard index, materialized array)

    # -- row-source protocol -------------------------------------------------

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    @property
    def stored_nbytes(self):
        """Bytes on disk (:attr:`nbytes` for codec ``none``)."""
        return sum(self.shard_stored_sizes)

    @property
    def n_shards(self):
        return len(self.shard_sizes)

    def __len__(self):
        return self.shape[0]

    def _shard_path(self, i):
        return os.path.join(self.path, self.manifest["shards"][i]["file"])

    def _materialize(self, i, timing=None):
        """One supervised, fault-injectable read of shard ``i``, its CRC
        unchecked: the shard array for codec ``none``, the stored payload
        as uint8 otherwise. The armed ``cold_tier`` model sleeps inside
        the timed attempt, so a slow cold read counts toward the deadline
        like a ``read_stall``. ``timing`` is the storage ledger's latency
        dict (None when the ledger is off: no clock is read)."""
        from ..obs import storage as _storage
        from ..resilience import faults as _faults
        from ..resilience import supervisor as _sup

        stored = self.shard_stored_sizes[i]

        def attempt():
            plan = _faults._active
            if plan is not None:
                if timing is None:
                    plan.on_cold(i, stored)
                else:
                    t0 = _storage._now()
                    plan.on_cold(i, stored)
                    timing["cold_s"] += _storage._now() - t0
            t0 = None if timing is None else _storage._now()
            if self.codec == "none":
                mm = np.load(self._shard_path(i), mmap_mode="r")
                arr = np.array(mm)  # materialize, then drop the mapping
                del mm
            else:
                with open(self._shard_path(i), "rb") as fh:
                    arr = np.frombuffer(fh.read(), np.uint8)
            if timing is not None:
                timing["read_s"] += _storage._now() - t0
            return arr

        arr = _sup.supervised_read(attempt, i, site="oocore.read_shard")
        plan = _faults._active
        if plan is not None:
            arr = plan.corrupt_read(arr, i)
        return arr

    def _decode(self, i, payload, meta):
        """Stored payload → shard array. A decode failure after a clean
        (or skipped) CRC pass surfaces with the shard's provenance."""
        from .. import obs as _obs

        rows = int(meta["rows"])
        try:
            arr = decompress_array(payload, self.dtype, (rows, self.shape[1]))
        except ValueError as exc:
            raise ShardCorruptionError(
                f"shard {i} ({meta['file']}) of {self.path} failed "
                f"{self.codec} decode: {exc}") from exc
        _obs.counter_add("oocore.codec_bytes_in", int(payload.nbytes))
        _obs.counter_add("oocore.codec_bytes_out", int(arr.nbytes))
        return arr

    def read_shard(self, i):
        """Materialize shard ``i``: supervised read, CRC check per
        ``SQ_OOC_VERIFY`` over the stored bytes, quarantine and bounded
        re-read on a mismatch, then the decode of a codec shard. With the
        storage ledger on (:mod:`~sq_learn_tpu_torch.obs.storage`) the
        access lands as one update of this shard's aggregate, whichever
        thread ran it."""
        from .. import obs as _obs
        from ..obs import storage as _storage

        led = _storage.active()
        timing = (None if led is None else
                  {"read_s": 0.0, "crc_s": 0.0, "decode_s": 0.0,
                   "cold_s": 0.0})
        meta = self.manifest["shards"][i]
        raw_nbytes = int(meta["rows"]) * self.shape[1] * self.dtype.itemsize
        stored = self.shard_stored_sizes[i]
        # a codec shard's payload and decoded array are resident together
        _budget_check(raw_nbytes + (stored if self.codec != "none" else 0),
                      f"shard {i} of {self.path}")
        arr = self._materialize(i, timing)
        mode = verify_mode()
        rereads = 0
        was_quarantined = 0
        if mode == "all" or (mode == "touch" and i not in self._verified):
            want = int(meta["crc32"])
            while True:
                if timing is None:
                    got = _crc(arr)
                else:
                    t0 = _storage._now()
                    got = _crc(arr)
                    timing["crc_s"] += _storage._now() - t0
                if got == want:
                    break
                self.quarantined.add(i)
                was_quarantined = 1
                _obs.counter_add("oocore.crc_failures", 1)
                if rereads >= reread_max():
                    raise ShardCorruptionError(
                        f"shard {i} ({meta['file']}) of {self.path} failed "
                        f"CRC {rereads + 1}x after quarantine: expected "
                        f"{want:08x}, got {got:08x}")
                rereads += 1
                _obs.counter_add("oocore.rereads", 1)
                arr = self._materialize(i, timing)
            self.quarantined.discard(i)
            self._verified.add(i)
        if self.codec != "none":
            if timing is None:
                arr = self._decode(i, arr, meta)
            else:
                t0 = _storage._now()
                arr = self._decode(i, arr, meta)
                timing["decode_s"] += _storage._now() - t0
        _obs.counter_add("oocore.shard_reads", 1)
        _obs.counter_add("oocore.shard_read_bytes", int(arr.nbytes))
        if led is not None:
            led.record_read(
                "oocore", self.fingerprint, i, stored_bytes=stored,
                raw_bytes=int(arr.nbytes), read_s=timing["read_s"],
                crc_s=timing["crc_s"], decode_s=timing["decode_s"],
                cold_s=timing["cold_s"], retries=rereads,
                quarantined=was_quarantined, codec=self.codec)
        return arr

    def _shard_cached(self, i):
        """One-entry shard cache: consecutive tiles of a pass share their
        boundary shard, which is read and checked once."""
        idx, arr = self._cache
        if idx != i:
            arr = self.read_shard(i)
            self._cache = (i, arr)
        return arr

    def read_rows(self, start, stop):
        """Rows ``[start, stop)`` as one array (the streaming engine's
        tile read); verification happens per shard."""
        start, stop = int(start), int(stop)
        n, m = self.shape
        if not 0 <= start <= stop <= n:
            raise IndexError(f"rows [{start}, {stop}) out of [0, {n})")
        _budget_check((stop - start) * m * self.dtype.itemsize,
                      f"row read [{start}, {stop}) of {self.path}")
        out = np.empty((stop - start, m), self.dtype)
        return _copy_rows(self._shard_cached, self._offsets, start, stop, out)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step == 1:
                return self.read_rows(start, stop)
        raise TypeError("ShardStore supports contiguous row slices only; "
                        "use read_rows/read_shard (or take) for gathers")

    def take(self, rows):
        """Gather arbitrary rows (the init subsample), shard by shard, so
        each touched shard is read once."""
        rows = np.asarray(rows, np.int64)
        _budget_check(rows.size * self.shape[1] * self.dtype.itemsize,
                      f"row gather ({rows.size} rows) of {self.path}")
        out = np.empty((rows.size, self.shape[1]), self.dtype)
        shard_of = np.searchsorted(self._offsets, rows, side="right") - 1
        for i in np.unique(shard_of):
            sel = shard_of == i
            arr = self._shard_cached(int(i))
            out[sel] = arr[rows[sel] - int(self._offsets[i])]
        return out

    def col_stats(self):
        """(colsum, sqsum) the writer recorded at build time."""
        return (np.asarray(self.manifest["colsum"], np.float64),
                np.asarray(self.manifest["sqsum"], np.float64))

    def var_mean(self):
        """Mean per-feature variance (the scale of q-means' ``tol``) from
        the manifest's column stats."""
        colsum, sqsum = self.col_stats()
        n = self.shape[0]
        return float(np.mean(np.maximum(sqsum / n - (colsum / n) ** 2, 0.0)))

    def prefetched(self, *, depth=None, threads=None):
        """A sequential-walk view of this store with bounded shard
        readahead (:class:`~.prefetch.PrefetchingSource`), or the store
        itself when the depth is 0 or there is one shard."""
        from .prefetch import PrefetchingSource, prefetch_depth

        d = prefetch_depth() if depth is None else int(depth)
        if d <= 0 or self.n_shards <= 1:
            return self
        return PrefetchingSource(self, depth=d, threads=threads)


def open_store(path):
    """Open an existing store directory (reads the manifest only)."""
    with open(os.path.join(path, MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"not an oocore shard store: {path}")
    codec = manifest.get("codec", "none")
    if codec not in ("lz4", "none"):
        raise ValueError(
            f"store {path} uses unknown codec {codec!r} — refusing to "
            f"misread its shard payloads")
    return ShardStore(path, manifest)


class _StoreWriter:
    """Shard-by-shard store writer: per-shard CRCs and the running column
    stats of the manifest.

    :meth:`write_shard` (file write, CRC, the shard's column stats)
    touches no shared state and may run on a worker thread;
    :meth:`commit` folds a shard's stats into the manifest state and runs
    in shard order, so the float sums, and the manifest, are those of a
    serial build. :meth:`append` is the two in turn.
    """

    def __init__(self, path, n_rows, n_features, dtype, codec=None):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.n_rows, self.n_features = int(n_rows), int(n_features)
        self.dtype = np.dtype(dtype)
        self.codec = codec_default() if codec is None else str(codec)
        if self.codec not in ("lz4", "none"):
            raise ValueError(f"codec must be lz4|none, got {self.codec!r}")
        self.shards = []
        self.colsum = np.zeros(self.n_features, np.float64)
        self.sqsum = np.zeros(self.n_features, np.float64)
        self._written = 0

    def write_shard(self, i, block):
        """Write shard ``i`` (fsynced); returns ``(meta, colsum_i,
        sqsum_i)`` for :meth:`commit`. Codec ``none`` writes ``.npy``
        files; a codec writes the :func:`._codec.compress_array` payload
        with its CRC over the stored bytes."""
        block = np.ascontiguousarray(block, self.dtype)
        if self.codec == "none":
            fname = f"shard_{i:05d}.npy"
            with open(os.path.join(self.path, fname), "wb") as fh:
                np.save(fh, block)
                fh.flush()
                os.fsync(fh.fileno())
            meta = {"file": fname, "rows": int(block.shape[0]),
                    "crc32": _crc(block), "nbytes": int(block.nbytes)}
        else:
            payload = compress_array(block)
            fname = f"shard_{i:05d}.{self.codec}"
            with open(os.path.join(self.path, fname), "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            meta = {"file": fname, "rows": int(block.shape[0]),
                    "crc32": _crc(np.frombuffer(payload, np.uint8)),
                    "nbytes": int(block.nbytes),
                    "stored_bytes": len(payload)}
        return (meta, block.sum(axis=0, dtype=np.float64),
                (block.astype(np.float64) ** 2).sum(axis=0))

    def commit(self, meta, colsum_i, sqsum_i):
        self.shards.append(meta)
        self.colsum += colsum_i
        self.sqsum += sqsum_i
        self._written += int(meta["rows"])

    def append(self, block):
        self.commit(*self.write_shard(len(self.shards), block))

    def finish(self, provenance):
        if self._written != self.n_rows:
            raise ValueError(
                f"wrote {self._written} rows, declared {self.n_rows}")
        manifest = {
            "format": FORMAT,
            "n_rows": self.n_rows,
            "n_features": self.n_features,
            "dtype": self.dtype.name,
            "shards": self.shards,
            "fingerprint": _fingerprint(
                (self.n_rows, self.n_features), self.dtype.name,
                [s["crc32"] for s in self.shards]),
            "colsum": [float(v) for v in self.colsum],
            "sqsum": [float(v) for v in self.sqsum],
            "provenance": provenance,
        }
        if self.codec != "none":
            manifest["codec"] = self.codec
        _atomic_json(os.path.join(self.path, MANIFEST), manifest)
        return ShardStore(self.path, manifest)


def _parallel_build(writer, gen, n_shards, shard_nbytes, **span_attrs):
    """Build a store shard by shard on a thread pool: workers run
    ``writer.write_shard(i, gen(i))`` while the caller folds the stats in
    shard order, so the manifest is byte-identical to a serial build's.
    The in-flight window is one shard per worker plus one, shrunk under an
    armed ``SQ_OOC_RAM_BUDGET_BYTES`` (a building shard with its float64
    stats temporary takes about three times its bytes)."""
    from .. import obs as _obs
    from .prefetch import prefetch_threads

    threads = max(1, min(prefetch_threads(), n_shards))
    window = threads + 1
    budget = ram_budget_bytes()
    if budget:
        window = max(1, min(window, budget // max(1, 3 * shard_nbytes)))
    with _obs.span("oocore.create_store", shards=n_shards,
                   codec=writer.codec,
                   threads=threads if window > 1 else 1, **span_attrs):
        if window <= 1 or n_shards <= 1:
            for i in range(n_shards):
                writer.append(gen(i))
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    threads, thread_name_prefix="sq-ooc-build") as ex:
                pending, nxt = {}, 0
                for i in range(n_shards):
                    while nxt < n_shards and nxt - i < window:
                        pending[nxt] = ex.submit(
                            lambda j: writer.write_shard(j, gen(j)), nxt)
                        nxt += 1
                    writer.commit(*pending.pop(i).result())


def create_synthetic_store(path, n_samples, n_features, *, n_classes=10,
                           seed=0, cluster_std=4.0, shard_bytes=None,
                           dtype=np.float32, codec=None, kind="gaussian"):
    """Write a deterministic synthetic dataset straight to a shard store.

    ``kind="gaussian"`` is the ``synthetic_surrogate`` geometry
    (per-class Gaussian centroids, per-feature scale decay);
    ``kind="pixels"`` writes MNIST-like rows (per-class blob templates on
    a √m-side grid, intensity jitter and noise, clipped, thresholded,
    quantized to 256 levels), which compress. Shard ``i``'s rows come
    from an RNG keyed on ``(seed, i)`` — its labels are the first draw,
    ``default_rng((seed, i)).integers(0, n_classes, size=rows_i)`` — so a
    rebuild with the same arguments is bit-identical, in either package.
    Returns the opened :class:`ShardStore`."""
    dtype = canonical_dtype(dtype)
    rows, n_shards = _plan_shards(
        n_samples, int(n_features) * dtype.itemsize, shard_bytes)
    shard_nbytes = rows * int(n_features) * dtype.itemsize
    _budget_check(shard_nbytes, f"synthetic shard build of {path}")
    rng0 = np.random.default_rng(seed)
    if kind == "gaussian":
        centers = rng0.normal(scale=10.0, size=(n_classes, n_features))
        scales = np.geomspace(1.0, 0.05, n_features)

        def gen(i):
            r = min(rows, int(n_samples) - i * rows)
            rng = np.random.default_rng((int(seed), i))
            y = rng.integers(0, n_classes, size=r)
            return (centers[y] + rng.normal(
                scale=cluster_std, size=(r, n_features)) * scales)
    elif kind == "pixels":
        side = max(2, int(np.sqrt(n_features)))
        yy, xx = np.mgrid[0:side, 0:side]
        templates = np.zeros((n_classes, side * side))
        for c in range(n_classes):
            acc = np.zeros((side, side))
            for _ in range(4):
                cx, cy = rng0.uniform(2.0, side - 2.0, 2)
                s = rng0.uniform(1.5, 3.5)
                acc += rng0.uniform(0.5, 1.0) * np.exp(
                    -((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * s * s))
            templates[c] = acc.reshape(-1)
        # tile or truncate the grid to the requested feature count
        reps = -(-int(n_features) // templates.shape[1])
        templates = np.tile(templates, (1, reps))[:, :int(n_features)]

        def gen(i):
            r = min(rows, int(n_samples) - i * rows)
            rng = np.random.default_rng((int(seed), i))
            y = rng.integers(0, n_classes, size=r)
            block = (templates[y] * rng.uniform(0.7, 1.0, size=(r, 1))
                     + rng.normal(scale=0.08, size=(r, int(n_features))))
            block = np.clip(block, 0.0, 1.0)
            block = np.where(block < 0.15, 0.0, block)
            return np.round(block * 255.0) / 255.0
    else:
        raise ValueError(f"kind must be gaussian|pixels, got {kind!r}")

    writer = _StoreWriter(path, n_samples, n_features, dtype, codec=codec)
    _parallel_build(writer, gen, n_shards, shard_nbytes,
                    n=int(n_samples), m=int(n_features))
    return writer.finish({"kind": f"synthetic-{kind}", "seed": int(seed),
                          "n_classes": int(n_classes),
                          "cluster_std": float(cluster_std)})


def store_from_array(path, X, *, shard_bytes=None, codec=None):
    """Shard an in-RAM array to disk (on the same thread pool as
    :func:`create_synthetic_store`; the manifest is a serial build's).
    Returns the opened store."""
    X = np.asarray(X)
    canonical = canonical_dtype(X.dtype)
    if X.dtype != canonical:
        X = X.astype(canonical)
    n, m = X.shape
    rows, n_shards = _plan_shards(n, X.nbytes // max(1, n), shard_bytes)
    writer = _StoreWriter(path, n, m, X.dtype, codec=codec)
    _parallel_build(writer, lambda i: X[i * rows:(i + 1) * rows],
                    n_shards, rows * m * X.dtype.itemsize,
                    n=int(n), m=int(m))
    return writer.finish({"kind": "array"})


class ArraySource:
    """In-RAM twin of :class:`ShardStore`: the same row-source protocol and
    a virtual shard split over a resident array, with a content-complete
    fingerprint (a CRC over all its bytes). The epoch engine over
    ``ArraySource(X, shard_rows=R)`` gives the bits of the same run over a
    disk store of ``X`` with that shard split."""

    def __init__(self, X, *, shard_rows=None, shard_bytes=None):
        X = np.asarray(X)
        canonical = canonical_dtype(X.dtype)
        if X.dtype != canonical:
            X = X.astype(canonical)
        self._X = X
        self.shape = X.shape
        self.dtype = X.dtype
        n = X.shape[0]
        if shard_rows is None:
            shard_rows, _ = _plan_shards(n, X.nbytes // max(1, n),
                                         shard_bytes)
        self.shard_sizes = [min(shard_rows, n - s)
                            for s in range(0, n, shard_rows)] or [0]
        self._offsets = np.concatenate(
            [[0], np.cumsum(self.shard_sizes)]).astype(np.int64)
        self.fingerprint = f"{_crc(X):08x}"
        self.quarantined = set()

    size = property(lambda self: self._X.size)
    nbytes = property(lambda self: self._X.nbytes)
    n_shards = property(lambda self: len(self.shard_sizes))

    def __len__(self):
        return self.shape[0]

    def read_shard(self, i):
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._X[lo:hi]

    def read_rows(self, start, stop):
        return self._X[int(start):int(stop)]

    def take(self, rows):
        return self._X[np.asarray(rows, np.int64)]

    def var_mean(self):
        return float(np.mean(np.var(self._X.astype(np.float64), axis=0)))
