"""Bounded shard readahead: disk reads and CRC checks overlapped with the
consumer (counterpart of ``sq_learn_tpu/oocore/prefetch.py``).

While the consumer works on shard *i*, worker threads read and check
shards *i+1..i+d*. The contract, as in the JAX package:

- **bit parity**: a worker calls the store's own
  :meth:`~.store.ShardStore.read_shard` (supervised read, CRC check,
  quarantine, bounded re-read, decode); depth 0
  (``SQ_OOC_PREFETCH_DEPTH=0``) is the serial path, and every depth gives
  the same arrays in the same order.
- **error provenance**: a worker's failure is re-raised on the consumer at
  the position of the shard it belongs to; shards checked ahead of it
  still serve.
- **plan awareness**: only the caller's shard order is read (an epoch
  plan's visit order, or a tile walk from its resume cursor).
- **RAM budget**: with ``SQ_OOC_RAM_BUDGET_BYTES`` armed, read-ahead bytes
  (in flight plus completed and unconsumed) stay under the budget less
  the consumer's own residency (two shards unless stated); a compressed
  shard in flight claims its payload and its decoded bytes. The position
  the consumer waits on always claims, so a small budget degrades to
  serial reads, never to a deadlock.
- **host only**: workers run numpy, ``zlib`` and file reads; they never
  touch torch or the card.
- **observability**: one ``oocore.prefetch`` span per prefetcher and the
  ``oocore.prefetch_hits``/``_stalls``/``_stall_s``/``_occupancy``
  counters; hits and stalls also land on each shard's storage-ledger
  entry.

Knobs: ``SQ_OOC_PREFETCH_DEPTH`` (unset: 2 on a multi-core host, 0 on a
single core), ``SQ_OOC_PREFETCH_THREADS`` (2, also the width of a store
build's pool).
"""

import os
import threading
import time

import numpy as np

from .. import _knobs
from .. import obs as _obs
from ..obs import storage as _storage
from .store import _budget_check, _copy_rows, ram_budget_bytes

__all__ = [
    "PrefetchingSource",
    "ShardPrefetcher",
    "iter_shards",
    "prefetch_depth",
    "prefetch_threads",
]


def prefetch_depth():
    """Shard readahead depth: ``SQ_OOC_PREFETCH_DEPTH`` when set (0 = the
    serial path); else 2 on a multi-core host and 0 on a single core,
    where the workers could only time-slice the consumer's core."""
    env = _knobs.get_raw("SQ_OOC_PREFETCH_DEPTH")
    if env is not None:
        return int(env)
    return 2 if (os.cpu_count() or 1) > 1 else 0


def prefetch_threads():
    """Prefetch worker count (``SQ_OOC_PREFETCH_THREADS``, 2)."""
    return _knobs.get_int("SQ_OOC_PREFETCH_THREADS")


class ShardPrefetcher:
    """Bounded readahead over a known shard visit ``order``.

    Workers claim positions in order and run the source's checked
    ``read_shard``; the consumer drains positions strictly in sequence
    through :meth:`get`. ``resident_bytes`` declares the consumer's own
    residency for the RAM budget (default: two of the largest shards).
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/oocore/
    #: prefetch.py``'s map): worker/consumer state is only written under
    #: ``self._cond``.
    _GUARDED_BY = {"_cond": ("_results", "_claimed", "_consumed", "_held",
                             "_closed", "_hits", "_stalls", "_occupancy",
                             "_stall_s")}

    def __init__(self, source, order, *, depth=None, threads=None,
                 resident_bytes=None):
        self.source = source
        self.order = [int(s) for s in order]
        self.depth = prefetch_depth() if depth is None else max(0, int(depth))
        nthreads = prefetch_threads() if threads is None else int(threads)
        self._threads = max(1, min(nthreads, max(1, self.depth),
                                   max(1, len(self.order))))
        itemsize = np.dtype(source.dtype).itemsize
        row = int(np.prod(source.shape[1:], dtype=np.int64)) * itemsize
        self._sz = [int(source.shard_sizes[s]) * row for s in self.order]
        # a compressed shard in flight holds its payload and its decoded
        # array; once read, only the decoded bytes stay until consumed
        stored = getattr(source, "shard_stored_sizes", None)
        if stored is not None and getattr(source, "codec", "none") != "none":
            self._extra = [int(stored[s]) for s in self.order]
        else:
            self._extra = [0] * len(self.order)
        budget = ram_budget_bytes()
        self._avail = None
        if budget:
            floor = (2 * max(self._sz, default=0) if resident_bytes is None
                     else int(resident_bytes))
            self._avail = max(0, budget - floor)
        self._cond = threading.Condition()
        self._results = {}
        self._claimed = 0    # next position a worker may claim
        self._consumed = 0   # next position get() hands out
        self._held = 0       # bytes in flight + completed-but-unconsumed
        self._closed = False
        self._hits = self._stalls = self._occupancy = 0
        self._stall_s = 0.0
        self._span = _obs.span("oocore.prefetch", shards=len(self.order),
                               depth=self.depth, threads=self._threads)
        self._span.__enter__()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"sq-ooc-prefetch-{i}")
            for i in range(self._threads)]
        for t in self._workers:
            t.start()

    # -- scheduling (the caller holds self._cond) ---------------------------

    def _claimable(self):
        p = self._claimed
        if p >= len(self.order) or p > self._consumed + self.depth:
            return False
        if (p != self._consumed and self._avail is not None
                and self._held + self._sz[p] + self._extra[p]
                > self._avail):
            # readahead would break the budget; the position the consumer
            # waits on always claims (the store's own check guards it)
            return False
        return True

    def _worker(self):
        while True:
            with self._cond:
                while not self._closed and not self._claimable():
                    self._cond.wait()
                if self._closed:
                    return
                p = self._claimed
                self._claimed += 1
                self._held += self._sz[p] + self._extra[p]
            try:
                out = ("ok", self.source.read_shard(self.order[p]))
            except BaseException as exc:  # surfaces on the consumer at p
                out = ("err", exc)
            with self._cond:
                self._results[p] = out
                self._held -= self._extra[p]
                self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

    def get(self, pos):
        """Shard ``order[pos]``; ``pos`` must be the next unconsumed
        position. Blocks until the worker's read lands and re-raises a
        worker's failure at the position it belongs to."""
        pos = int(pos)
        was_hit = True
        waited_s = 0.0
        with self._cond:
            if pos != self._consumed:
                raise RuntimeError(
                    f"ShardPrefetcher.get is sequential: expected position "
                    f"{self._consumed}, got {pos}")
            self._occupancy += sum(1 for q in self._results if q > pos)
            if pos in self._results:
                self._hits += 1
            else:
                was_hit = False
                self._stalls += 1
                t0 = time.perf_counter()
                while pos not in self._results and not self._closed:
                    self._cond.wait()
                waited_s = time.perf_counter() - t0
                self._stall_s += waited_s
                if pos not in self._results:
                    raise RuntimeError(
                        "ShardPrefetcher closed while waiting for shard "
                        f"{self.order[pos]}")
            kind, payload = self._results.pop(pos)
            self._consumed = pos + 1
            self._held -= self._sz[pos]
            self._cond.notify_all()
        # the hit or stall lands on the owning shard's ledger entry; the
        # worker's read_shard recorded the read itself
        led = _storage.active()
        if led is not None:
            led.record_prefetch(
                getattr(self.source, "fingerprint", "?"),
                self.order[pos], hit=was_hit, stall_s=waited_s)
        if kind == "err":
            raise payload
        return payload

    def close(self):
        """Stop the workers, add the stats to the recorder and close the
        span. Idempotent; the iterator helpers call it from ``finally``."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for t in self._workers:
            t.join()
        _obs.counter_add("oocore.prefetch_hits", self._hits)
        _obs.counter_add("oocore.prefetch_stalls", self._stalls)
        _obs.counter_add("oocore.prefetch_stall_s",
                         round(self._stall_s, 6))
        _obs.counter_add("oocore.prefetch_occupancy", self._occupancy)
        self._span.set(hits=self._hits, stalls=self._stalls,
                       stall_s=round(self._stall_s, 6),
                       consumed=self._consumed)
        self._span.__exit__(None, None, None)
        self._results.clear()
        # the pass-end ledger flush: one cumulative io record per shard
        # this pass touched
        _storage.flush("pass_end")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def iter_shards(source, shards, *, depth=None, threads=None,
                resident_bytes=None):
    """Yield the arrays of ``shards`` (a visit order) with bounded
    readahead. Depth 0, one shard, or a source without the
    ``prefetchable`` mark (:class:`~.store.ArraySource`'s reads are free
    slices) read serially, with the same bits."""
    d = prefetch_depth() if depth is None else max(0, int(depth))
    shards = [int(s) for s in shards]
    if (d <= 0 or len(shards) <= 1
            or not getattr(source, "prefetchable", False)):
        for s in shards:
            yield source.read_shard(s)
        return
    pf = ShardPrefetcher(source, shards, depth=d, threads=threads,
                         resident_bytes=resident_bytes)
    try:
        for pos in range(len(shards)):
            yield pf.get(pos)
    finally:
        pf.close()


class PrefetchingSource:
    """Row-source view of a shard store whose sequential row walks are
    served from a bounded readahead of its shards (what
    :func:`sq_learn_tpu_torch.streaming.stream_tiles` reads through, via
    :meth:`~.store.ShardStore.prefetched`). ``read_rows`` walks the shards
    in natural order from the first row asked for (the resume cursor:
    earlier shards are never read); a read out of that sequence takes the
    store's own path; everything else delegates to the store. Call
    :meth:`close` when the pass ends."""

    def __init__(self, store, *, depth=None, threads=None):
        self._store = store
        self._depth = depth
        self._threads = threads
        self._pf = None
        self._order = None
        self._pos = 0
        self._cur = (None, None)

    def __getattr__(self, name):
        return getattr(self._store, name)

    def __len__(self):
        return len(self._store)

    def _shard(self, i):
        idx, arr = self._cur
        if idx == i:
            return arr
        if self._pf is None:
            self._order = list(range(i, self._store.n_shards))
            self._pos = 0
            self._pf = ShardPrefetcher(self._store, self._order,
                                       depth=self._depth,
                                       threads=self._threads)
        if self._pos < len(self._order) and self._order[self._pos] == i:
            arr = self._pf.get(self._pos)
            self._pos += 1
            self._cur = (i, arr)
            return arr
        return self._store.read_shard(i)  # out of sequence: serial path

    def read_rows(self, start, stop):
        store = self._store
        start, stop = int(start), int(stop)
        n = store.shape[0]
        m = int(np.prod(store.shape[1:], dtype=np.int64))
        if not 0 <= start <= stop <= n:
            raise IndexError(f"rows [{start}, {stop}) out of [0, {n})")
        _budget_check((stop - start) * m * store.dtype.itemsize,
                      f"row read [{start}, {stop}) of {store.path}")
        out = np.empty((stop - start,) + tuple(store.shape[1:]), store.dtype)
        return _copy_rows(self._shard, store._offsets, start, stop, out)

    def close(self):
        if self._pf is not None:
            self._pf.close()
            self._pf = None
        self._cur = (None, None)
