"""Digest-keyed transform-result cache for the serving layer
(counterpart of ``sq_learn_tpu/serving/cache.py``; keys, LRU and the disk
spill format are the JAX package's, so either package reads the other's
spill files).

Keys are ``(model fingerprint, op, shape, dtype, content digest)``: the
digest is a CRC32 of the whole payload for requests of up to 64 rows and
the strided-row sampler of :func:`sq_learn_tpu_torch.sketch.cache.
data_digest` beyond. The fingerprint (the checkpoint's ``state_digest``,
or a CRC of the params for an in-memory model, suffixed with the quantize
mode) keys a re-registered tenant out of its predecessor's results.

Only deterministic ops are cached (``transform``, never a δ > 0
predict). Hits and misses are pre-aggregated obs counters
(``serving.cache_hits`` / ``serving.cache_misses``); ``SQ_SERVE_CACHE=0``
kills the cache, ``SQ_SERVE_CACHE_ENTRIES`` (256) bounds the RAM LRU.
Process-global and thread-safe; results are returned as copies.

**Disk spill tier** (``SQ_SERVE_CACHE_DIR``): results evicted from the
RAM LRU land on disk, one file per key: a JSON header line (the full key,
the result's shape and dtype, the stored length and a CRC of the stored
bytes) then the :func:`sq_learn_tpu_torch.oocore._codec.compress_array`
payload. A RAM miss falls through to the disk; a disk hit verifies the
whole key and the CRC before decoding, is promoted back into RAM and
counts as a hit; anything wrong is a miss, never an error. Writes are
atomic (temporary file + rename); ``SQ_SERVE_CACHE_DISK_ENTRIES`` (4096)
bounds the tier, oldest first. Spills and disk hits are counters
(``serving.cache_spills`` / ``serving.cache_disk_hits``) and, under an
active recorder, events of the storage ledger's ``serve_cache`` surface.
This is host code: nothing here touches the card.
"""

import collections
import hashlib
import json
import os
import threading

import numpy as np

from .. import _knobs
from .. import obs as _obs
from ..obs import storage as _storage
from ..oocore import _codec
from ..sketch.cache import data_digest

__all__ = ["cache_dir", "clear", "enabled", "flush_counters", "key_for",
           "lookup", "spill_all", "stats", "store"]


def _max_entries():
    return _knobs.get_int("SQ_SERVE_CACHE_ENTRIES")


def _max_disk_entries():
    return _knobs.get_int("SQ_SERVE_CACHE_DISK_ENTRIES")


def cache_dir():
    """The disk spill directory (``SQ_SERVE_CACHE_DIR``), or None when
    the tier is off."""
    return _knobs.get_raw("SQ_SERVE_CACHE_DIR") or None


_lock = threading.Lock()
_store = collections.OrderedDict()

#: hit/miss tallies are PRE-AGGREGATED and flushed to the obs counters
#: every ``_FLUSH_EVERY`` events (and on :func:`flush_counters`, which
#: the dispatcher calls at close): at serving rates a JSONL counter line
#: per lookup would flood the run artifact
_FLUSH_EVERY = 256
_hits = 0
_misses = 0
_disk_hits = 0
_spills = 0
_pending = {"hits": 0, "misses": 0, "disk_hits": 0, "spills": 0}

#: obs counter name per pending tally key
_COUNTERS = {"hits": "serving.cache_hits",
             "misses": "serving.cache_misses",
             "disk_hits": "serving.cache_disk_hits",
             "spills": "serving.cache_spills"}


def stats():
    """Cumulative process-wide {hits, misses, disk_hits, spills}
    (includes not-yet-flushed events — the fine-grained view tests and
    smokes read). ``hits`` includes the disk hits."""
    with _lock:
        return {"hits": _hits, "misses": _misses, "disk_hits": _disk_hits,
                "spills": _spills}


def _count(kind):
    global _hits, _misses, _disk_hits, _spills
    with _lock:
        if kind == "hits":
            _hits += 1
        elif kind == "misses":
            _misses += 1
        elif kind == "disk_hits":
            _hits += 1  # a disk hit IS a hit — plus its own tier counter
            _disk_hits += 1
        else:
            _spills += 1
        _pending[kind] += 1
        if kind == "disk_hits":
            _pending["hits"] += 1
        if sum(_pending.values()) < _FLUSH_EVERY:
            return
        deltas = dict(_pending)
        for k in _pending:
            _pending[k] = 0
    _flush(deltas)


def _flush(deltas):
    for kind, delta in deltas.items():
        if delta:
            _obs.counter_add(_COUNTERS[kind], delta)


def flush_counters():
    """Push the pending hit/miss/spill deltas into the obs counters (one
    JSONL line per counter, not per event). Dispatchers call this at
    close so bench ``obs`` objects and reports carry exact totals."""
    with _lock:
        deltas = dict(_pending)
        for k in _pending:
            _pending[k] = 0
    _flush(deltas)
    # the serving surfaces' pass-end ledger flush (obs.storage) rides
    # the same dispatcher-close hook as the counter flush
    _storage.flush("pass_end")


def enabled():
    """True unless ``SQ_SERVE_CACHE=0``."""
    return _knobs.get_bool("SQ_SERVE_CACHE")


def _request_digest(X, max_rows=64):
    """The strided-CRC recipe with a serving fast path: payloads of
    ≤``max_rows`` rows (the overwhelming serving case) hash their whole
    contiguous buffer directly — same digest semantics (a full hash),
    none of the index-building overhead the submit path would pay per
    request. Larger payloads fall back to the shared strided sampler."""
    import zlib

    if X.shape[0] <= max_rows and X.flags.c_contiguous:
        return zlib.crc32(X)
    return data_digest(X, max_rows)


def key_for(fingerprint, op, X):
    """Cache key for one request payload under one model, or None when
    caching is disabled (None keys make lookup/store no-ops)."""
    if not enabled():
        return None
    try:
        return (fingerprint, op, X.shape, str(X.dtype),
                _request_digest(X))
    except Exception:
        return None  # exotic payloads: skip the cache, never the request


# -- disk spill tier ---------------------------------------------------------


def _key_json(key):
    """Canonical JSON of a cache key (tuples → lists, stable order) —
    both the spill filename input and the header the hit verifies."""
    fingerprint, op, shape, dtype, digest = key
    return json.dumps([str(fingerprint), str(op),
                       [int(s) for s in shape], str(dtype), int(digest)],
                      separators=(",", ":"))


def _spill_path(root, kj):
    return os.path.join(root, hashlib.sha1(kj.encode()).hexdigest() + ".sqc")


def _spill(key, result):
    """Write one evicted entry to the disk tier: JSON header line (full
    key + result shape/dtype + stored-bytes CRC) then the compressed
    payload. Atomic (tmp + rename); failures are swallowed — a cache
    must never fail the serving path."""
    root = cache_dir()
    if root is None:
        return
    try:
        os.makedirs(root, exist_ok=True)
        kj = _key_json(key)
        payload = _codec.compress_array(result)
        header = json.dumps({
            "key": json.loads(kj),
            "shape": [int(s) for s in result.shape],
            "dtype": str(result.dtype),
            "stored": len(payload),
            "crc": _codec.crc32(payload),
        }, separators=(",", ":"))
        path = _spill_path(root, kj)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(header.encode() + b"\n")
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _count("spills")
        led = _storage.active()
        if led is not None:
            # storage-ledger surface tag (obs.storage): the spill's
            # stored-vs-raw byte pair is the disk tier's codec evidence
            led.record_cache_event(
                "serve_cache", root, "spill", stored_bytes=len(payload),
                raw_bytes=int(result.nbytes))
        _prune(root)
    except OSError:
        return


def _prune(root):
    """Bound the disk tier at ``SQ_SERVE_CACHE_DISK_ENTRIES`` entries,
    oldest mtime first (checked every 64 spills — a scandir per spill
    would dominate small-result writes)."""
    if _spills % 64:
        return
    cap = _max_disk_entries()
    try:
        entries = [e for e in os.scandir(root) if e.name.endswith(".sqc")]
        if len(entries) <= cap:
            return
        entries.sort(key=lambda e: e.stat().st_mtime)
        for e in entries[:len(entries) - cap]:
            os.unlink(e.path)
    except OSError:
        return


def _disk_lookup(key):
    """Disk-tier lookup: parse the header, verify the FULL key (the
    digest-verified claim — a filename-hash collision or stale file can
    never serve wrong rows) and the payload CRC, then decode. Returns
    the result array or None; every failure mode is a miss. With the
    storage ledger active the timed read lands on the ``serve_cache``
    surface (disk_hit with raw bytes, or miss)."""
    root = cache_dir()
    if root is None:
        return None
    led = _storage.active()
    if led is None:
        return _disk_read(root, key)
    t0 = _storage._now()
    out = _disk_read(root, key)
    dur = _storage._now() - t0
    if out is None:
        led.record_cache_event("serve_cache", root, "miss", dur_s=dur)
    else:
        led.record_cache_event("serve_cache", root, "disk_hit",
                               raw_bytes=int(out.nbytes), dur_s=dur)
    return out


def _disk_read(root, key):
    kj = _key_json(key)
    path = _spill_path(root, kj)
    try:
        with open(path, "rb") as fh:
            header = json.loads(fh.readline().decode())
            payload = fh.read()
    except (OSError, ValueError):
        return None
    try:
        if header["key"] != json.loads(kj):
            return None
        if len(payload) != int(header["stored"]):
            return None
        if _codec.crc32(payload) != int(header["crc"]):
            return None
        return _codec.decompress_array(
            payload, np.dtype(header["dtype"]), tuple(header["shape"]))
    except (KeyError, TypeError, ValueError):
        return None


# -- the public lookup/store surface -----------------------------------------


def lookup(key):
    """Cached response rows for ``key`` (LRU-touch on hit; returns a
    copy), tallying the outcome into the pre-aggregated
    ``serving.cache_hits`` / ``serving.cache_misses`` counters. A RAM
    miss falls through to the disk spill tier when armed; a verified
    disk hit is promoted back into the RAM LRU."""
    if key is None:
        return None
    with _lock:
        hit = _store.get(key)
        if hit is not None:
            _store.move_to_end(key)
    if hit is not None:
        _count("hits")
        return np.array(hit, copy=True)
    disk = _disk_lookup(key)
    if disk is not None:
        _insert(key, np.array(disk, copy=True))
        _count("disk_hits")
        led = _storage.active()
        if led is not None:
            led.record_cache_event("serve_cache", cache_dir() or "?",
                                   "promote")
        return np.array(disk, copy=True)
    _count("misses")
    return None


def _insert(key, result):
    """RAM-LRU insert; evictions spill to the disk tier when armed."""
    evicted = []
    with _lock:
        _store[key] = result
        _store.move_to_end(key)
        cap = _max_entries()
        while len(_store) > cap:
            evicted.append(_store.popitem(last=False))
    for k, v in evicted:
        _spill(k, v)


def store(key, result):
    if key is None:
        return
    _insert(key, np.array(result, copy=True))


def spill_all():
    """Flush every RAM-resident entry to the disk tier (no eviction) —
    the warm-shutdown hook for operators who want the whole working set
    to survive a restart, not just the evicted tail. No-op without
    ``SQ_SERVE_CACHE_DIR``."""
    if cache_dir() is None:
        return 0
    with _lock:
        items = list(_store.items())
    for k, v in items:
        _spill(k, v)
    return len(items)


def clear(disk=False):
    """Drop the RAM LRU (and, with ``disk=True``, the spill tier's
    files — the default keeps them: surviving process restarts is the
    tier's whole point)."""
    with _lock:
        _store.clear()
    if disk and cache_dir() is not None:
        try:
            for e in os.scandir(cache_dir()):
                if e.name.endswith(".sqc"):
                    os.unlink(e.path)
        except OSError:
            pass
