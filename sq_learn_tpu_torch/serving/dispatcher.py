"""Async micro-batching dispatcher: many small requests, few padded
dispatches (counterpart of ``sq_learn_tpu/serving/dispatcher.py``).

Per-request predict on the card pays the whole dispatch stack (a
host→device copy, a kernel launch, a result fetch) for a handful of rows;
under concurrent load those fixed costs ARE the latency. This dispatcher
coalesces concurrent predict/transform requests into padded bucketed
batches:

- **Coalescing window.** Requests enqueue with a submit timestamp; the
  worker opens a batch at the head request's group key (the model's
  memoized ``(fingerprint, op, transfer dtype)``) and closes it when
  ``SQ_SERVE_MAX_BATCH_ROWS`` rows have accumulated or the head has waited
  ``SQ_SERVE_MAX_WAIT_MS``.
- **Bucketed shapes.** A batch pads to the pow2 buckets of
  :func:`sq_learn_tpu_torch.streaming.bucket_rows` with the serving floor
  ``SQ_SERVE_MIN_BUCKET_ROWS``, so each kernel sees a few shapes, all of
  which ``registry.warm()`` ran once before traffic
  (:mod:`~sq_learn_tpu_torch.serving.aot`). After
  :func:`pin_compile_budgets`, a dispatch of a signature that was never
  warmed is an ``aot_cache_miss``, and under ``SQ_OBS_STRICT=1`` it raises.
- **One copy in, one kernel, one copy out.** The batch is gathered (and
  quantized, under a ``quantize`` mode) into a reused pinned host buffer
  of the pool, crosses once through the transfer supervisor
  (:func:`sq_learn_tpu_torch.resilience.supervisor.put`: retries, backoff,
  deadline, breaker accounting) on the dispatcher's own CUDA stream, one
  kernel call serves every request in it, and one device-to-host fetch in
  :meth:`MicroBatchDispatcher._resolve` brings the rows back, which
  scatter per request in submission order. The pool buffer is released
  only after the fetch. ``native=False`` (or ``SQ_SERVE_NATIVE=0``) takes
  the per-request path (a fresh zeroed buffer, one slice assignment and
  one copy per request); both paths give the same bytes.
- **No fallback that hides the device.** Where the JAX package degrades a
  batch to a host route, the port fails it: with the circuit breaker OPEN
  at preflight every future of the batch gets the
  :class:`~sq_learn_tpu_torch.resilience.supervisor.BreakerOpenError`, and
  with retries exhausted every future gets the terminal transfer error.
  Nothing runs on the CPU, the queue moves on to the next batch, and the
  batch counts in ``serving.failed_batches``. The controller's last rung
  ("host", :mod:`~sq_learn_tpu_torch.serving.control`) is the same
  kernel on the same card behind a plain unsupervised copy; it counts
  as degraded, like the JAX package's host route.
- **Cross-tenant megabatching.** Tenants that share a fingerprint serve
  byte-identical params, so their requests coalesce into one launch;
  each tenant is billed its own requests, rows, row share of the bytes
  and split of the stage decomposition, and Σ per-tenant requests equals
  the run aggregate. ``SQ_SERVE_MEGABATCH=0`` keys batches per tenant.
- **Per-tenant attribution.** Under an active recorder every request's
  latency, every batch's queue / coalesce / assemble / transfer /
  compute / scatter decomposition and every live fold-audit draw is
  attributed to its tenant through the error-budget ledger
  (:class:`sq_learn_tpu_torch.obs.budget.BudgetLedger`); every
  ``SQ_SERVE_SLO_FLUSH_BATCHES`` batches a windowed ``slo`` record and
  the tenant ``budget`` records land. With ``SQ_OBS`` unset none of this
  exists.
- **Control plane.** With ``SQ_SERVE_AUTOTUNE`` on and a recorder active,
  every ``SQ_SERVE_AUTOTUNE_EVERY`` batches the registry's controller
  reads the ledger and degrades, recovers, relaxes or tightens tenants
  (one ``control`` record per evaluation). ``autotune=False`` pins the
  static plane.

Threads and streams: ``background=True`` starts one worker thread, which
dispatches on the dispatcher's own CUDA stream and assembles batch *t+1*
while batch *t* computes; :meth:`~MicroBatchDispatcher.close` drains the
queue and joins it. ``background=False`` starts no thread: callers submit
and :meth:`~MicroBatchDispatcher.flush`, and grouping depends only on
submission order and sizes.

The serving kernels are plain torch in full float32
(:mod:`~sq_learn_tpu_torch.serving.quantize`): the JAX package leaves them
to XLA, so they have no hand-written kernel.
"""

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from .. import _knobs
from .. import obs as _obs
from ..resilience import supervisor as _sup
from ..streaming import bucket_rows
from . import aot as _aot
from . import cache as _cache
from . import control as _ctl_mod
from . import quantize as _quant
from .registry import canonical_dtype
from .slo import SloTracker, slo_flush_batches

__all__ = ["AotCacheMissError", "MicroBatchDispatcher", "ServeFuture",
           "kernel_cache_sizes", "pin_compile_budgets",
           "serve_max_batch_rows", "serve_max_wait_ms",
           "serve_min_bucket_rows"]


def serve_max_wait_ms():
    """Coalescing window in milliseconds (``SQ_SERVE_MAX_WAIT_MS``,
    default 2.0)."""
    return _knobs.get_float("SQ_SERVE_MAX_WAIT_MS")


def serve_max_batch_rows():
    """Row cap per dispatched batch (``SQ_SERVE_MAX_BATCH_ROWS``, default
    512), also the largest serving bucket."""
    return _knobs.get_int("SQ_SERVE_MAX_BATCH_ROWS")


def serve_min_bucket_rows():
    """Smallest serving bucket (``SQ_SERVE_MIN_BUCKET_ROWS``, default 8),
    passed per call to :func:`~sq_learn_tpu_torch.streaming.bucket_rows`."""
    return _knobs.get_int("SQ_SERVE_MIN_BUCKET_ROWS")


class AotCacheMissError(RuntimeError):
    """A dispatch of a signature that was never warmed, with the budgets
    pinned and ``SQ_OBS_STRICT=1``."""


#: serving-kernel budget of unwarmed dispatches: None until
#: :func:`pin_compile_budgets` pins it, and the misses counted since
_pinned_budget = None
_pinned_misses = 0
_pin_lock = threading.Lock()


def kernel_cache_sizes():
    """Signatures warmed per serving kernel (0 for a kernel never warmed):
    the counterpart of the JAX package's per-kernel compile-cache
    sizes."""
    warmed = _aot.kernel_sizes()
    return {name: warmed.get(name, 0) for name in _quant.KERNELS}


def pin_compile_budgets(budget=0):
    """Pin the serving kernels to a flat budget of unwarmed signatures
    (the post-warm contract: 0). From then on a dispatch whose signature
    was never warmed counts as an ``aot_cache_miss`` and, under
    ``SQ_OBS_STRICT=1``, raises :class:`AotCacheMissError`. ``None``
    unpins."""
    global _pinned_budget, _pinned_misses
    with _pin_lock:
        _pinned_budget = None if budget is None else int(budget)
        _pinned_misses = 0


def _note_pinned_miss(signature):
    """Count one unwarmed dispatch against the pinned budget; raise past
    it under ``SQ_OBS_STRICT=1``."""
    global _pinned_misses
    with _pin_lock:
        if _pinned_budget is None:
            return
        _pinned_misses += 1
        over = _pinned_misses > _pinned_budget
    if over and _knobs.get_bool("SQ_OBS_STRICT"):
        raise AotCacheMissError(
            f"dispatch of the unwarmed serving signature {signature} "
            f"past the pinned budget of {_pinned_budget} (SQ_OBS_STRICT=1)")


class ServeFuture:
    """Slim future for one request's response: an Event around a slot
    (the per-request framework cost is the amortization floor). API
    subset: ``result(timeout)``, ``exception(timeout)``, ``done()``."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None

    def set_result(self, value):
        self._value = value
        self._event.set()

    def set_exception(self, exc):
        self._exc = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        return self._exc

    def result(self, timeout=None):
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._value


class _BufferPool:
    """Reusable padded assembly buffers, keyed by (rows, features, host
    dtype): numpy views of pinned host tensors when the device is a card
    (so the copy is asynchronous on the dispatcher's stream), of plain
    ones otherwise. A buffer is released only AFTER its batch's result
    fetch: the copy (and on the CPU, the kernel itself, which reads the
    buffer in place) may still be reading it until then. Bounded per key:
    the double-buffered worker holds at most two batches in flight, plus
    a concurrent flush."""

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/serving/
    #: dispatcher.py``'s map): the free lists are shared between the
    #: worker thread and flushing callers.
    _GUARDED_BY = {"_lock": ("_free",)}

    def __init__(self, pinned, per_key=4):
        self._lock = threading.Lock()
        self._free = {}
        self._pinned = bool(pinned)
        self._per_key = int(per_key)

    def acquire(self, rows, cols, dtype):
        """``(numpy view, host tensor)`` of a ``rows × cols`` buffer of
        host dtype ``dtype``; its bytes are stale (the caller overwrites
        the rows and zeroes the tail)."""
        key = (rows, cols, np.dtype(dtype))
        with self._lock:
            stack = self._free.get(key)
            if stack:
                return stack.pop()
        host = torch.from_numpy(np.empty((rows, cols), key[2]))
        if self._pinned:
            host = host.pin_memory()
        return host.numpy(), host

    def release(self, buf):
        view, _host = buf
        key = (view.shape[0], view.shape[1], view.dtype)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self._per_key:
                stack.append(buf)


class _Request:
    __slots__ = ("tenant", "op", "rows", "n_rows", "future", "submitted",
                 "cache_key", "model", "group_key", "consumed", "collected")

    def __init__(self, tenant, op, rows, model, cache_key, submitted,
                 group_key):
        self.tenant = tenant
        self.op = op
        self.rows = rows
        self.n_rows = rows.shape[0]
        self.model = model
        self.cache_key = cache_key
        self.submitted = submitted
        #: batch-pop timestamp (the queue-wait/coalesce split), stamped
        #: only under an active recorder
        self.collected = None
        self.future = ServeFuture()
        self.group_key = group_key
        self.consumed = False


def _scatter(out, counts):
    """Slice the batch result's leading rows back into per-request
    arrays: C-contiguous windows of ONE block allocated here (one
    allocation and one copy per batch), detached from ``out``; their bytes
    are the per-request path's ``np.array(out[a:b], copy=True)``."""
    ends = np.cumsum(np.asarray(counts, np.int64))
    total = int(ends[-1]) if len(counts) else 0
    block = np.empty((total,) + out.shape[1:], out.dtype)
    block[:] = out[:total]
    outs, lo = [], 0
    for hi in ends.tolist():
        outs.append(block[lo:hi])
        lo = hi
    return outs


class MicroBatchDispatcher:
    """Coalesce concurrent predict/transform requests into padded
    bucketed dispatches against a :class:`~sq_learn_tpu_torch.serving.
    registry.ModelRegistry`, on the registry's device.

    ``background=True`` starts the worker thread (live traffic);
    ``background=False`` is the deterministic mode (:meth:`submit` then
    :meth:`flush`, or :meth:`serve`). Use as a context manager or call
    :meth:`close`, which drains the queue, joins the worker and emits the
    run's ``slo`` records. ``tap``, when given, is called once per
    resolved batch with ``(kernel name, padded host batch, extra args,
    params, host result, per-request responses)`` before the pool buffer
    is released and the futures resolve (each response is the very
    object its future returns): an audit hook that replays batches.
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/serving/
    #: dispatcher.py``'s map, less ``_sites_seen``, which the port does not
    #: keep): queue and batching state shared with the worker thread is
    #: only written under ``self._cond`` (``*_locked`` helpers assume the
    #: lock is held).
    _GUARDED_BY = {"_cond": ("_queue", "_by_key", "_key_rows",
                             "_pending_count", "_stopping", "_batch_seq",
                             "_aot_hits", "_aot_misses", "_megabatches")}

    def __init__(self, registry, *, max_wait_ms=None, max_batch_rows=None,
                 min_bucket_rows=None, slo_p50_ms=None, slo_p99_ms=None,
                 background=True, coalesce=True, native=None,
                 megabatch=None, autotune=None, autotune_every=None,
                 site="serving.dispatcher", tap=None):
        self.registry = registry
        self.device = registry.device
        #: coalesce=False is the sequential per-request baseline: every
        #: dispatch serves exactly one request
        self._coalesce = bool(coalesce)
        self._max_wait_s = (serve_max_wait_ms() if max_wait_ms is None
                            else float(max_wait_ms)) / 1e3
        self._max_batch_rows = (serve_max_batch_rows()
                                if max_batch_rows is None
                                else int(max_batch_rows))
        self._min_bucket = (serve_min_bucket_rows()
                            if min_bucket_rows is None
                            else int(min_bucket_rows))
        self._site = site
        self._tap = tap
        self._native = (_knobs.get_bool("SQ_SERVE_NATIVE")
                        if native is None else bool(native))
        self._megabatch = (_knobs.get_bool("SQ_SERVE_MEGABATCH")
                           if megabatch is None else bool(megabatch))
        self._autotune = (_ctl_mod.autotune_enabled()
                          if autotune is None else bool(autotune))
        self._autotune_every = (_ctl_mod.autotune_every()
                                if autotune_every is None
                                else int(autotune_every))
        self._ctl = None
        on_card = self.device.type == "cuda"
        self._pool = _BufferPool(pinned=on_card)
        #: the dispatcher's own stream: batch t+1's copy queues behind
        #: batch t's kernel without waiting on the default stream
        self._stream = (torch.cuda.Stream(device=self.device) if on_card
                        else None)
        self.slo = SloTracker(site, slo_p50_ms=slo_p50_ms,
                              slo_p99_ms=slo_p99_ms)
        self._cond = threading.Condition()
        #: arrival-order index (head-of-line discovery; consumed entries
        #: are skipped lazily) + per-group-key subqueues (the batch pull)
        self._queue = collections.deque()
        self._by_key = {}
        self._key_rows = {}
        self._pending_count = 0
        self._stopping = False
        self._closed = False
        self._batch_seq = 0
        self._budget = None
        self._flush_every = slo_flush_batches()
        self._aot_hits = 0
        self._aot_misses = 0
        self._megabatches = 0
        self._failed_batches = 0
        self._worker = None
        if background:
            self._worker = threading.Thread(
                target=self._worker_loop, name=site, daemon=True)
            self._worker.start()

    # -- client surface ----------------------------------------------------

    def warm(self, tenants=None, aot=None):
        """Warm the registry AND the ladder for THIS dispatcher's bucket
        configuration; with the autotune latch on (and a recorder
        active) the registry's controller is created first, so every
        warmed tenant gets its ``plan`` record. Returns the registry's
        per-tenant warm statuses."""
        if self._autotune and _obs.enabled():
            self._controller()
        return self.registry.warm(
            tenants, aot=aot,
            buckets=_aot.bucket_ladder(self._min_bucket,
                                       self._max_batch_rows))

    def _prepare(self, tenant, op, X, submitted=None, models=None):
        """Validate and normalize one request. Returns a queue-ready
        :class:`_Request`, or an already-resolved :class:`ServeFuture` on
        a result-cache hit. Shape, dtype, tenant and op problems raise
        here, synchronously. ``submitted``/``models`` amortize a burst:
        one submit stamp and one registry resolve per tenant."""
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        if models is None:
            model = self.registry.resolve(tenant)
        else:
            model = models.get(tenant)
            if model is None:
                model = models[tenant] = self.registry.resolve(tenant)
        model.op(op)  # validates the op against the model, raises KeyError
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        rows = np.asarray(X)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2:
            raise ValueError(f"request must be a row batch (2D), "
                             f"got ndim={rows.ndim}")
        if rows.shape[1] != model.n_features:
            raise ValueError(
                f"request has {rows.shape[1]} features; tenant "
                f"{tenant!r} serves {model.n_features}")
        if not np.issubdtype(rows.dtype, np.floating):
            rows = rows.astype(model.dtype)
        else:
            canonical = canonical_dtype(rows.dtype)
            if rows.dtype != canonical:
                rows = rows.astype(canonical)
        if not rows.flags.c_contiguous:
            rows = np.ascontiguousarray(rows)
        if submitted is None:
            submitted = self.slo.note_submit()
        cache_key = None
        if op in model.cacheable:
            cache_key = _cache.key_for(model.fingerprint, op, rows)
            hit = _cache.lookup(cache_key)
            if hit is not None:
                fut = ServeFuture()
                fut.set_result(hit)
                if _obs.enabled():
                    done = time.perf_counter()
                    tenant = str(tenant)
                    p50_t, p99_t = self._targets_for(model, tenant)
                    self.slo.note_request_done(
                        submitted, ts=done, tenant=tenant,
                        targets=(p50_t, p99_t))
                    self._budget_ledger().note_request(
                        tenant, done - submitted, p50_ms=p50_t,
                        p99_ms=p99_t, ts=done)
                else:
                    self.slo.note_request_done(submitted)
                return fut
        tenant = str(tenant)
        group_key = model.group_key(op, rows.dtype)
        ctl = self._ctl
        if not self._megabatch or (ctl is not None
                                   and ctl.host_route(tenant)):
            # tenant-scoped batches: equal-fingerprint tenants never
            # merge, and a host-routed tenant never drags a healthy one
            # onto its route
            group_key = (tenant,) + group_key
        return _Request(tenant, op, rows, model, cache_key, submitted,
                        group_key)

    def _targets_for(self, model, tenant=None):
        """The (p50, p99) targets a tenant's requests burn against: the
        controller's renegotiated ones, else its declared ones, else the
        dispatcher's run-level ones, per percentile."""
        ctl = self._ctl
        if ctl is not None and tenant is not None:
            renegotiated = ctl.targets_for(tenant)
            if renegotiated is not None:
                return renegotiated
        return (model.slo_p50_ms if model.slo_p50_ms is not None
                else self.slo.slo_p50_ms,
                model.slo_p99_ms if model.slo_p99_ms is not None
                else self.slo.slo_p99_ms)

    def _controller(self):
        """The registry's shared controller, created on first use, only
        with the autotune latch on and a recorder active."""
        ctl = self._ctl
        if ctl is None and self._autotune:
            ctl = self._ctl = self.registry.controller()
        return ctl

    def _budget_ledger(self):
        """The per-tenant error-budget ledger, created on first use under
        an active recorder."""
        led = self._budget
        if led is None:
            led = self._budget = _obs.budget.BudgetLedger(site=self._site)
        return led

    def budget_ledger(self):
        """The dispatcher's error-budget ledger, or None when no observed
        traffic has been served (``SQ_OBS`` unset ⇒ always None)."""
        return self._budget

    def submit(self, tenant, op, X):
        """Enqueue one request; returns a :class:`ServeFuture` resolving to
        the response rows (row-aligned with ``X``). Malformed requests
        raise synchronously; a repeated identical ``transform`` payload may
        resolve at once from the result cache."""
        req = self._prepare(tenant, op, X)
        if isinstance(req, ServeFuture):
            return req
        with self._cond:
            self._enqueue_locked(req)
            self._cond.notify()
        return req.future

    def submit_many(self, requests):
        """Enqueue a burst of ``(tenant, op, X)`` requests under one lock
        acquisition, one submit stamp and one worker wakeup; returns the
        futures in order."""
        requests = list(requests)
        submitted = self.slo.note_submit()
        models = {}
        prepared = [self._prepare(t, op, X, submitted=submitted,
                                  models=models)
                    for t, op, X in requests]
        to_queue = [r for r in prepared if not isinstance(r, ServeFuture)]
        if to_queue:
            with self._cond:
                self._enqueue_many_locked(to_queue)
                self._cond.notify()
        return [r if isinstance(r, ServeFuture) else r.future
                for r in prepared]

    def _enqueue_locked(self, req):
        self._queue.append(req)
        key = req.group_key
        kq = self._by_key.get(key)
        if kq is None:
            kq = self._by_key[key] = collections.deque()
        kq.append(req)
        self._key_rows[key] = self._key_rows.get(key, 0) + req.n_rows
        self._pending_count += 1

    def _enqueue_many_locked(self, reqs):
        self._queue.extend(reqs)
        by_key = {}
        for req in reqs:
            by_key.setdefault(req.group_key, []).append(req)
        for key, lst in by_key.items():
            kq = self._by_key.get(key)
            if kq is None:
                self._by_key[key] = collections.deque(lst)
            else:
                kq.extend(lst)
            self._key_rows[key] = (self._key_rows.get(key, 0)
                                   + sum(r.n_rows for r in lst))
        self._pending_count += len(reqs)

    def serve(self, tenant, op, X):
        """Blocking convenience: submit, flush when deterministic, and
        return the response rows."""
        fut = self.submit(tenant, op, X)
        if self._worker is None:
            self.flush()
        return fut.result()

    def flush(self):
        """Drain the queue synchronously in the caller's thread: grouping
        by submission order and the row cap only. A failed batch lands on
        its futures and the drain goes on; an error raised after a batch's
        futures resolved (a strict budget or audit gate) propagates to the
        caller."""
        while True:
            group = self._collect_group(wait=False)
            if not group:
                return
            self._resolve_guarded(self._launch_guarded(group),
                                  reraise=True)

    def pending(self):
        with self._cond:
            return self._pending_count

    def close(self):
        """Drain, join the worker, emit the run's ``slo`` records (per
        tenant + aggregate) and the final ``budget``/``alert`` records.
        Idempotent; returns the aggregate SLO summary dict. A strict SLO
        violation or budget burn raises AFTER its records land."""
        if self._closed:
            return self.slo.summary()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
        self.flush()  # anything the worker left behind
        self._closed = True
        if _obs.enabled():
            if self._autotune and self._budget is not None:
                ctl = self._controller()
                if ctl is not None:
                    ctl.evaluate(self, final=True)
            _cache.flush_counters()
            if self._aot_hits:
                _obs.counter_add("serving.aot_cache_hits", self._aot_hits)
            if self._aot_misses:
                _obs.counter_add("serving.aot_cache_misses",
                                 self._aot_misses)
            if self._megabatches:
                _obs.counter_add("serving.megabatches", self._megabatches)
            nbytes = self.slo.transfer_bytes()
            if nbytes:
                _obs.counter_add("serving.transfer_bytes", nbytes)
        summary = self.slo.emit()
        if self._budget is not None:
            self._budget.emit()
        return summary

    def aot_stats(self):
        """{hits, misses} of the warmed-signature lookups, this
        dispatcher."""
        with self._cond:
            return {"hits": self._aot_hits, "misses": self._aot_misses}

    def megabatches(self):
        """Dispatched batches that spanned more than one tenant."""
        with self._cond:
            return self._megabatches

    def failed_batches(self):
        """Batches whose futures got an error instead of a result."""
        with self._cond:
            return self._failed_batches

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- batching core -----------------------------------------------------

    def _collect_group(self, wait):
        """Pop the next batch: the head request plus every queued same-key
        request, FIFO, until the row cap. With ``wait=True`` (worker mode)
        the head's coalescing window is honored."""
        with self._cond:
            head = self._head_locked()
            if wait:
                while head is None and not self._stopping:
                    self._cond.wait()
                    head = self._head_locked()
                if head is None:
                    return []
                deadline = head.submitted + self._max_wait_s
                while not self._stopping and self._coalesce:
                    remaining = deadline - time.perf_counter()
                    if (self._key_rows.get(head.group_key, 0)
                            >= self._max_batch_rows or remaining <= 0):
                        break
                    self._cond.wait(timeout=remaining)
            # a concurrent flush may have consumed the head meanwhile
            head = self._head_locked()
            if head is None:
                return []
            key = head.group_key
            kq = self._by_key[key]
            if not self._coalesce:
                kq.popleft().consumed = True
                self._key_rows[key] -= head.n_rows
                self._pending_count -= 1
                return [head]
            group, rows = [], 0
            while kq and (not group
                          or rows + kq[0].n_rows <= self._max_batch_rows):
                req = kq.popleft()
                req.consumed = True
                group.append(req)
                rows += req.n_rows
            self._key_rows[key] -= rows
            self._pending_count -= len(group)
            return group

    def _head_locked(self):
        q = self._queue
        while q and q[0].consumed:
            q.popleft()
        return q[0] if q else None

    def _worker_loop(self):
        """Double-buffered serving loop: batch *t+1* is collected, padded,
        copied and its kernel launched before batch *t*'s result is
        fetched, so batch *t* computes under batch *t+1*'s host-side
        assembly."""
        pending = None
        while True:
            if not self._coalesce:
                # the sequential baseline: strictly one dispatch at a time
                group = self._collect_group(wait=True)
                if not group:
                    with self._cond:
                        if (self._stopping
                                and self._head_locked() is None):
                            return
                    continue
                self._resolve_guarded(self._launch_guarded(group))
                continue
            if pending is not None:
                group = self._collect_group(wait=False)
                if not group:
                    self._resolve_guarded(pending)
                    pending = None
                    continue
                launched = self._launch_guarded(group)
                self._resolve_guarded(pending)
                pending = launched
                continue
            group = self._collect_group(wait=True)
            if not group:
                with self._cond:
                    if self._stopping and self._head_locked() is None:
                        return
                continue
            pending = self._launch_guarded(group)

    def _fail(self, group, exc):
        """Land ``exc`` on every unresolved future of ``group`` and count
        the batch in ``serving.failed_batches``. Returns False (counting
        nothing) when every future had already resolved."""
        pending = [r for r in group if not r.future.done()]
        if not pending:
            return False
        for r in pending:
            r.future.set_exception(exc)
        with self._cond:
            self._failed_batches += 1
        _obs.counter_add("serving.failed_batches", 1)
        return True

    def _launch_guarded(self, group):
        """Launch stage: the in-flight state, or None after landing a
        launch failure on the group's futures."""
        try:
            return self._launch(group)
        except Exception as exc:  # every request must resolve
            self._fail(group, exc)
            return None

    def _resolve_guarded(self, state, reraise=False):
        """Resolve stage: a failure before the futures resolved lands on
        them; one after them (a strict gate) re-raises when ``reraise``
        (a caller's flush); the worker has no caller, and the gate's
        records surface at close."""
        if state is None:
            return
        try:
            self._resolve(state)
        except Exception as exc:  # every request must resolve
            if not self._fail(state[0], exc) and reraise:
                raise

    # -- dispatch ----------------------------------------------------------

    def _assemble(self, group, bucket, model):
        """Build the padded host batch in the group's transfer dtype: the
        request rows verbatim (exact route), or quantized to the model's
        mode (one rounding pass on the host). Returns ``(padded, host,
        buf, extra_args, amax_x)``: ``host`` is the tensor over
        ``padded`` (pinned on a card), ``buf`` the pool entry to release
        after the fetch (None on the per-request path), ``extra_args``
        the int8 route's batch scale, ``amax_x`` the batch's dynamic
        range the fold is evaluated at (None when no audit can use
        it)."""
        head = group[0]
        mode = model.quantize
        m = head.rows.shape[1]
        pooled = self._native
        dtype = (head.rows.dtype if mode is None
                 else _quant.host_dtype(_quant.transfer_dtype(mode)))
        if pooled:
            buf = self._pool.acquire(bucket, m, dtype)
            padded = buf[0]
        else:
            buf = None
            padded = np.zeros((bucket, m), dtype)
        extra = ()
        amax_x = None
        off = 0
        if mode is None:
            for r in group:
                padded[off:off + r.n_rows] = r.rows
                off += r.n_rows
        else:
            if mode == "int8" or _obs.guarantees.enabled():
                amax_x = max((float(np.max(np.abs(r.rows))) if r.rows.size
                              else 0.0) for r in group)
            scale = None
            if mode == "int8":
                scale = _quant.int8_scale(amax_x)
                extra = (float(np.float32(scale)),)
            for r in group:
                _quant.quantize_rows(r.rows, mode,
                                     out=padded[off:off + r.n_rows],
                                     scale=scale)
                off += r.n_rows
        if pooled:
            padded[off:] = 0  # pooled buffers carry stale tail bytes
            host = buf[1]
        else:
            host = torch.from_numpy(padded)
        return padded, host, buf, extra, amax_x

    def _launch(self, group):
        """Stage 1: pad (quantizing when the model says so), copy to the
        card (supervised, or plain for a host-routed tenant), launch the
        kernel WITHOUT waiting for it. Returns the in-flight state for
        :meth:`_resolve`. Under an active recorder the stage boundaries
        are stamped."""
        head = group[0]
        model = head.model
        kernel_name, params = model.op(head.op)
        n = sum(r.n_rows for r in group)
        full = self._max_batch_rows
        if n > full:  # one oversized request: pad to its own pow2 bucket
            full = 1 << max(0, int(n - 1).bit_length())
        min_rows = self._min_bucket
        ctl = self._ctl
        if ctl is not None:
            # the controller's "wider coalescing" rung
            min_rows = ctl.min_rows_for(head.tenant, min_rows)
        bucket = bucket_rows(max(n, 1), full, min_rows=min_rows)

        observing = _obs.enabled()
        t_collect = time.perf_counter() if observing else 0.0
        if observing:
            for r in group:
                r.collected = t_collect
        padded, host, buf, extra, amax_x = self._assemble(group, bucket,
                                                          model)
        t_assembled = time.perf_counter() if observing else 0.0
        dtype_name = model.transfer_dtype(head.rows.dtype)
        warmed = _aot.lookup(model, head.op, bucket, dtype_name)
        multi = any(r.tenant != head.tenant for r in group)
        with self._cond:
            seq = self._batch_seq
            self._batch_seq += 1
            if warmed is not None:
                self._aot_hits += 1
            else:
                self._aot_misses += 1
            if multi:
                self._megabatches += 1
        if warmed is None:
            _note_pinned_miss(model.aot_signature(head.op, bucket,
                                                  dtype_name))

        torch_dtype = _quant.torch_dtype(dtype_name)
        host_route = ctl is not None and ctl.host_route(head.tenant)
        with self._stream_ctx():
            if host_route:
                # the controller's last rung: the same kernel on the same
                # card behind a plain, unsupervised copy
                dev = host.to(self.device, non_blocking=True)
            else:
                # an OPEN breaker raises here (its half-open trial probes
                # the card afresh); exhausted retries raise from put: the
                # batch fails, nothing runs elsewhere
                _sup.breaker.preflight(site=self._site, device=self.device)
                dev = _sup.put(
                    lambda t: torch.as_tensor(t).to(self.device,
                                                    non_blocking=True),
                    host, seq, site=self._site)
            if dev.dtype != torch_dtype:
                dev = dev.view(torch_dtype)  # bfloat16 crosses as int16
            t_placed = time.perf_counter() if observing else 0.0
            out_dev = _quant.KERNELS[kernel_name](dev, *extra, *params)
        if host_route:
            _obs.counter_add("serving.degraded_batches", 1)
        stamps = ((t_collect, t_assembled, t_placed) if observing
                  else None)
        return (group, out_dev, n, bucket, host_route, observing,
                padded.nbytes, amax_x, seq, stamps, padded, buf, multi,
                kernel_name, extra, params)

    def _stream_ctx(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _resolve(self, state):
        """Stage 2: fetch the batch's result (one device-to-host copy,
        waiting on the dispatcher's stream) and scatter it back per
        request: cache store, future resolution, SLO accounting (per
        tenant under an active recorder) and, for a quantized batch, the
        strided live audit draw."""
        (group, out_dev, n, bucket, degraded, observing, nbytes, amax_x,
         seq, stamps, padded, buf, multi, kernel_name, extra,
         params) = state
        with self._stream_ctx():
            out = out_dev.cpu().numpy()
        done = time.perf_counter()
        if self._native:
            results = _scatter(out, [r.n_rows for r in group])
        else:
            results, off = [], 0
            for r in group:
                results.append(np.array(out[off:off + r.n_rows], copy=True))
                off += r.n_rows
        if self._tap is not None:
            self._tap(kernel_name, padded.copy(), extra, params, out,
                      results)
        if buf is not None:
            # the fetch proves the batch's copy and kernel are done
            # reading the buffer: only now may the next batch reuse it
            self._pool.release(buf)
        head_res = results[0] if results else None
        for r, res in zip(group, results):
            if r.cache_key is not None:
                _cache.store(r.cache_key, res)
            r.future.set_result(res)
        head = group[0]
        tenant = targets = stages = parts = None
        if observing:
            tenant = head.tenant
            targets = self._targets_for(head.model, tenant)
            # "queue" is the non-head requests' wait for the batch to
            # open (the head's wait is the coalescing window); "compute"
            # spans the launch to the end of the fetch, so in worker
            # mode it includes the overlap with the next batch's assembly
            t_collect, t_assembled, t_placed = stamps
            t_scatter = time.perf_counter()
            stages = {
                "queue": sum(max(0.0, t_collect - r.submitted)
                             for r in group[1:]),
                "coalesce": max(0.0, t_collect - head.submitted),
                "assemble": max(0.0, t_assembled - t_collect),
                "transfer": max(0.0, t_placed - t_assembled),
                "compute": max(0.0, done - t_placed),
                "scatter": max(0.0, t_scatter - done),
            }
            if multi:
                parts = self._tenant_parts(group, head, n, nbytes,
                                           stamps, stages)
        self.slo.note_batch_done([r.submitted for r in group], done, n,
                                 bucket, degraded, nbytes=nbytes,
                                 tenant=None if parts else tenant,
                                 targets=None if parts else targets,
                                 stages=stages, parts=parts)
        if observing:
            led = self._budget_ledger()
            if parts is not None:
                for (t, ts_list, _rows, _nb, tgt, _st) in parts:
                    led.note_requests(t, [done - ts for ts in ts_list],
                                      p50_ms=tgt[0], p99_ms=tgt[1],
                                      ts=done)
            else:
                led.note_requests(
                    tenant, [done - r.submitted for r in group],
                    p50_ms=targets[0], p99_ms=targets[1], ts=done)
        if observing and head.model.quant_folds and amax_x is not None \
                and head_res is not None:
            draw = _quant.audit_batch(head.model, head.op, head.rows,
                                      head_res, amax_x, seq,
                                      tenant=tenant)
            if draw is not None:
                self._budget_ledger().note_draw(
                    tenant, draw["violated"], draw["fail_prob"])
        # the controller runs BEFORE the windowed budget flush below: a
        # degrade's renegotiation re-bases the ledger's burn before the
        # flush can emit an alert on the old targets
        if observing and self._autotune and self._autotune_every > 0 \
                and (seq + 1) % self._autotune_every == 0:
            ctl = self._controller()
            if ctl is not None and self._budget is not None:
                ctl.evaluate(self)
        if observing and self._flush_every > 0 \
                and (seq + 1) % self._flush_every == 0:
            self.slo.flush_window()
            if self._budget is not None:
                self._budget.emit()

    def _tenant_parts(self, group, head, n, nbytes, stamps, stages):
        """Per-tenant billing split of one megabatch, submission order:
        one ``(tenant, submit_ts_list, rows, nbytes_share, targets,
        stage_split)`` tuple per tenant. Queue wait is exact per tenant,
        the coalescing window bills to the head's tenant, and the batch
        stages split by row share; Σ parts reproduces the batch totals."""
        by_tenant = {}
        for r in group:
            by_tenant.setdefault(r.tenant, []).append(r)
        parts = []
        for t, reqs in by_tenant.items():
            rows_t = sum(r.n_rows for r in reqs)
            st = None
            if stages is not None:
                frac = rows_t / n if n else 0.0
                t_collect = stamps[0]
                st = {
                    "queue": sum(max(0.0, t_collect - r.submitted)
                                 for r in reqs if r is not head),
                    "coalesce": (stages["coalesce"]
                                 if reqs[0] is head else 0.0),
                    "assemble": stages["assemble"] * frac,
                    "transfer": stages["transfer"] * frac,
                    "compute": stages["compute"] * frac,
                    "scatter": stages["scatter"] * frac,
                }
            parts.append((t, [r.submitted for r in reqs], rows_t,
                          (nbytes * rows_t) // n if n else 0,
                          self._targets_for(reqs[0].model, t), st))
        return parts
