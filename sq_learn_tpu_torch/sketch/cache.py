"""Digest-keyed spectral-stats cache (counterpart of
``sq_learn_tpu/sketch/cache.py``).

Repeated :func:`~.engine.mu_stats` and :func:`~.engine.frobenius_squared`
calls over one array compute their statistics once. Keys are
``(shape, dtype, content digest, version, config)``: the digest is a
CRC32 over ≤64 evenly strided rows (first and last included), and a
tensor's version counter, which every in-place change to it or to a view
of it advances, so a re-shuffled, swapped or mutated tensor misses. Two
distinct arrays (or one numpy array changed in place) that differ only in
rows the digest does not sample share a key and are served the first
one's statistics; the fits therefore compute μ(A) afresh and never read
this cache. ``SQ_STATS_CACHE=0`` disables it. Process-global, LRU-bounded
(8 entries), thread-safe.
"""

import collections
import threading
import zlib

import numpy as np
import torch

from .. import _knobs

__all__ = ["clear", "enabled", "key_for", "lookup", "store"]

#: LRU bound — entries are per-dataset stats bundles (a few KB each)
MAX_ENTRIES = 8

_lock = threading.Lock()
_store = collections.OrderedDict()


def enabled():
    """True unless ``SQ_STATS_CACHE=0``."""
    return _knobs.get_bool("SQ_STATS_CACHE")


def data_digest(X, max_rows=64):
    """Content fingerprint: CRC32 over ≤``max_rows`` evenly strided rows
    (first and last included) of a tensor or an array; only those rows are
    fetched from the device."""
    n = X.shape[0]
    idx = np.unique(np.linspace(0, max(n - 1, 0),
                                num=min(n, max_rows), dtype=np.int64))
    if isinstance(X, torch.Tensor):
        rows = X[torch.as_tensor(idx, device=X.device)].cpu().numpy()
    else:
        rows = np.asarray(X[idx])
    return zlib.crc32(np.ascontiguousarray(rows).tobytes())


def key_for(X, *config):
    """Cache key for ``X`` under a stats configuration, or None when
    caching is disabled (None keys make lookup/store no-ops)."""
    if not enabled():
        return None
    version = X._version if isinstance(X, torch.Tensor) else None
    return (tuple(int(v) for v in X.shape), str(X.dtype),
            data_digest(X), version) + tuple(config)


def lookup(key):
    """Cached stats for ``key`` (LRU-touch on hit), or None."""
    if key is None:
        return None
    with _lock:
        hit = _store.get(key)
        if hit is not None:
            _store.move_to_end(key)
    return hit


def store(key, stats):
    if key is None:
        return
    with _lock:
        _store[key] = stats
        _store.move_to_end(key)
        while len(_store) > MAX_ENTRIES:
            _store.popitem(last=False)


def clear():
    with _lock:
        _store.clear()
