"""Run-scoped observability recorder: spans, counters, gauges, JSONL sink
(counterpart of ``sq_learn_tpu/obs/recorder.py``).

Every instrumented surface of the port (estimator fits, the quantum
routines' guarantee draws, the runtime ledger, trade-off sweeps) writes
through one in-memory :class:`Recorder`, with an optional append-only
JSONL sink in the JAX package's record envelope, so the JAX package's
readers (``python -m sq_learn_tpu.obs audit|frontier``, its schema
validator) read the port's artifacts.

1. **Nothing happens while it is off.** Every instrumentation point is one
   module-global read: :func:`span` returns the shared :data:`NULL_SPAN`,
   :func:`counter_add`/:func:`gauge` return at once. Nothing allocates,
   formats or touches a tensor, so no instrumentation point makes the
   host wait for the device.
2. **Run-scoped.** :func:`enable` starts a fresh run; :func:`disable`
   closes the sink. ``SQ_OBS=1`` enables at import with the sink at
   ``SQ_OBS_PATH`` (default ``sq_obs.jsonl`` in the working directory).
3. **Honest timing.** A span records host wall clock between enter and
   exit. CUDA launches are asynchronous, so a span around them measures
   the launches, not the work; ``sync=`` (or ``.sync(x)``) makes the exit
   wait for the stream of the device a tensor lives on, and the record
   carries ``synced: true`` only then.

Record envelope: ``{"v": 11, "schema_version": 11, "ts": <unix seconds>,
"type": <record type>}`` plus the fields of each type
(:mod:`.schema`). ``SQ_OBS_ROTATE_BYTES`` rotates the sink into gzipped
``<path>.<n>.gz`` segments, and ``SQ_OBS_TRACE=<path>`` renders a closed
run's sink as a Chrome trace (:mod:`.trace`). The storage ledger
(:mod:`.storage`) hangs off the recorder and flushes its ``io`` records
at close.

The fleet envelope: with a fleet run id (``SQ_OBS_FLEET_RUN_ID``, or
``run_id=`` for a private recorder, or :func:`set_fleet` later) every
record carries ``"fleet": {"run_id", "host", "pid", "gen"}``, so the
shards of the elastic world's processes merge into one timeline
(:mod:`.fleet`); :func:`set_generation` stamps the live generation.
``SQ_OBS_FLEET_DIR`` puts an ``SQ_OBS=1`` run's sink at
``<dir>/obs.<host>.jsonl``. The watchdog and XLA-cost fields of the JAX
package's :func:`snapshot` have no object in an eager torch port.
"""

import json
import os
import threading
import time

from .. import _knobs

#: the record envelope version of the JAX package this port's artifacts
#: follow (``sq_learn_tpu/obs/recorder.py:93``)
SCHEMA_VERSION = 11

#: default sink path when SQ_OBS=1 and SQ_OBS_PATH is unset
DEFAULT_PATH = "sq_obs.jsonl"

_lock = threading.RLock()
_tls = threading.local()

#: the active recorder, or None when observability is off. Module-global so
#: the disabled fast path is a single attribute read.
_active = None


class _NullSpan:
    """The disabled-mode span: a shared, stateless, no-op context manager.
    ``set`` drops its attributes untouched (a tensor attribute is never
    read) and ``sync`` returns its value without waiting."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, value):
        return value


NULL_SPAN = _NullSpan()


def _synchronize(value):
    """Wait for the current stream of the CUDA device each tensor in
    ``value`` (a tensor, or a list or tuple of them) lives on."""
    import torch

    tensors = value if isinstance(value, (list, tuple)) else (value,)
    for device in {t.device for t in tensors
                   if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()


class Span:
    """One timed scope. Created by :func:`span`; closes into a 'span'
    record with nesting metadata (depth, parent seq) from a per-thread
    stack."""

    __slots__ = ("_rec", "name", "attrs", "_sync", "_t0", "_seq", "_parent",
                 "_depth", "_synced")

    def __init__(self, rec, name, sync, attrs):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._sync = sync
        self._synced = False

    def set(self, **attrs):
        """Attach attributes discovered mid-scope (resolved solver, engine,
        iteration counts); they land in the closed record."""
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Wait for ``value``'s device at exit and return it — chains into
        expressions: ``out = sp.sync(step(...))``."""
        self._sync = value
        return value

    def __enter__(self):
        stack = getattr(_tls, "span_stack", None)
        if stack is None:
            stack = _tls.span_stack = []
        self._parent = stack[-1]._seq if stack else None
        self._depth = len(stack)
        self._seq = self._rec._next_seq()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sync is not None:
            _synchronize(self._sync)
            self._synced = True
        dur = time.perf_counter() - self._t0
        stack = getattr(_tls, "span_stack", ())
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"type": "span", "name": self.name, "seq": self._seq,
               "dur_s": round(dur, 6), "depth": self._depth,
               "parent": self._parent, "synced": self._synced}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = _jsonable(self.attrs)
        self._rec.record(rec, kind="spans")
        return False


def _jsonable(obj):
    """Best-effort conversion of attr values to JSON-serializable types;
    observability must never crash the instrumented computation."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    try:
        return float(obj)  # numpy scalars, 0-d tensors
    except (TypeError, ValueError, RuntimeError):
        return repr(obj)


class Recorder:
    """In-memory store of one run's records, with an optional JSONL sink.

    Public views: ``spans``, ``counters``, ``gauges``, ``gauge_events``,
    ``ledger_entries``, ``guarantee_records``, ``tradeoff_records``,
    ``fault_events``, ``breaker_events``, ``io_records``,
    ``slo_records``, ``budget_records``, ``alert_records``,
    ``control_records``, ``probe_events`` and ``elastic_records`` — plain
    Python containers, safe to read at any point in the run.

    ``run_id``/``host`` give a private recorder its fleet identity (the
    elastic coordinator's); otherwise ``SQ_OBS_FLEET_RUN_ID`` and
    ``SQ_OBS_FLEET_HOST`` do. Without a run id no record carries the
    envelope.
    """

    def __init__(self, path=None, run_id=None, host=None):
        rid = (run_id if run_id is not None
               else _knobs.get_str("SQ_OBS_FLEET_RUN_ID", ""))
        if rid:
            self.fleet_run_id = str(rid)
            self.fleet_host = str(
                host or _knobs.get_str("SQ_OBS_FLEET_HOST", "")
                or f"pid{os.getpid()}")
        else:
            self.fleet_run_id = None
            self.fleet_host = str(host) if host else None
        self.fleet_generation = None
        self.spans = []
        self.counters = {}
        self.gauges = {}
        self.gauge_events = []
        self.ledger_entries = []
        self.guarantee_records = []
        self.tradeoff_records = []
        self.fault_events = []
        self.breaker_events = []
        self.io_records = []
        # the serving plane's records (serving/, obs.budget, obs.probe)
        self.slo_records = []
        self.budget_records = []
        self.alert_records = []
        self.control_records = []
        self.probe_events = []
        # the elastic world's transitions (parallel/elastic.py)
        self.elastic_records = []
        # the storage ledger (obs.storage), attached at the first
        # instrumented shard read and flushed by close()
        self._storage = None
        self.path = path
        self._seq = 0
        self._sink = None
        # size-based rotation: at SQ_OBS_ROTATE_BYTES written bytes the
        # live sink is gzipped to <path>.<n>.gz and reopened (0 = off)
        self._rotate_bytes = _knobs.get_int("SQ_OBS_ROTATE_BYTES")
        self._sink_bytes = 0
        self._segments = 0
        if path:
            self._sink = open(path, "a", buffering=1)
            self.record({"type": "meta", "pid": os.getpid(),
                         "schema": SCHEMA_VERSION}, kind=None)

    def _next_seq(self):
        with _lock:
            self._seq += 1
            return self._seq

    def record(self, rec, kind=None):
        """Store ``rec`` in-memory (under ``kind``) and append it to the
        sink as one JSON line."""
        rec.setdefault("v", SCHEMA_VERSION)
        rec.setdefault("schema_version", SCHEMA_VERSION)
        rec.setdefault("ts", round(time.time(), 3))
        if self.fleet_run_id is not None and "fleet" not in rec:
            rec["fleet"] = self._envelope()
        with _lock:
            if kind is not None:
                getattr(self, kind).append(rec)
            if self._sink is not None:
                try:
                    line = json.dumps(rec) + "\n"
                    self._sink.write(line)
                    self._sink_bytes += len(line)
                except OSError:
                    pass  # a full disk must not kill the fit
                else:
                    if (self._rotate_bytes
                            and self._sink_bytes >= self._rotate_bytes):
                        self._rotate_locked()

    def _envelope(self):
        return {"run_id": self.fleet_run_id, "host": self.fleet_host,
                "pid": os.getpid(), "gen": self.fleet_generation}

    def _rotate_locked(self):
        """Gzip the live sink to the next ``<path>.<n>.gz`` segment and
        reopen the path with a ``meta`` line stamping the segment ordinal.
        Rotation trouble leaves an unrotated sink, never a dead run."""
        import gzip
        import shutil

        try:
            self._sink.flush()
            self._sink.close()
            self._segments += 1
            seg = f"{self.path}.{self._segments}.gz"
            with open(self.path, "rb") as src, gzip.open(seg, "wb") as dst:
                shutil.copyfileobj(src, dst)
            self._sink = open(self.path, "w", buffering=1)
            meta = {"type": "meta", "pid": os.getpid(),
                    "schema": SCHEMA_VERSION, "segment": self._segments,
                    "v": SCHEMA_VERSION, "schema_version": SCHEMA_VERSION,
                    "ts": round(time.time(), 3)}
            if self.fleet_run_id is not None:
                meta["fleet"] = self._envelope()
            line = json.dumps(meta) + "\n"
            self._sink.write(line)
            self._sink_bytes = len(line)
        except OSError:
            try:
                if self._sink is None or self._sink.closed:
                    self._sink = open(self.path, "a", buffering=1)
                self._rotate_bytes = 0  # stop retrying on every write
            except OSError:
                self._sink = None

    def flush(self, fsync=True):
        """Flush the JSONL sink to the OS and, with ``fsync`` (the
        default), to disk, so that a SIGKILL right after loses at most
        the line being written: elastic workers call it at every commit
        window and before ``os._exit``. Returns True when a sink was
        flushed."""
        with _lock:
            sink = self._sink
            if sink is None:
                return False
            try:
                sink.flush()
                if fsync:
                    os.fsync(sink.fileno())
            except OSError:
                return False
            return True

    def close(self):
        with _lock:
            # the storage ledger's unflushed aggregates land first
            if self._storage is not None:
                try:
                    self._storage.flush("close")
                except Exception:  # obs must not mask the run it observed
                    pass
            if self._sink is not None:
                try:
                    self._sink.close()
                finally:
                    self._sink = None


# ---------------------------------------------------------------------------
# Module-level API (the instrumentation surface)
# ---------------------------------------------------------------------------


def enabled():
    """True when a recorder is active (``SQ_OBS=1`` or :func:`enable`)."""
    return _active is not None


def get_recorder():
    """The active :class:`Recorder`, or None when observability is off."""
    return _active


def enable(path=None):
    """Start a fresh observability run. ``path`` opens a JSONL sink
    (appending); None records in memory only."""
    global _active
    with _lock:
        disable()
        _active = Recorder(path)
    return _active


def disable():
    """Close the current run (flushes the sink) and return its recorder.
    Safe to call when off. With ``SQ_OBS_TRACE=<path>`` and a JSONL sink,
    the closed run is also rendered as a Chrome trace at that path
    (:mod:`.trace`); a failed render never masks the run."""
    global _active
    with _lock:
        rec = _active
        _active = None
        if rec is not None:
            rec.close()
    trace_path = _knobs.get_raw("SQ_OBS_TRACE")
    if rec is not None and rec.path and trace_path:
        try:
            from .trace import write_trace

            write_trace([rec.path], trace_path)
        except Exception:
            pass
    return rec


def flush(fsync=True):
    """Durably flush the active run's JSONL sink (see
    :meth:`Recorder.flush`). False when disabled or in-memory."""
    rec = _active
    if rec is None:
        return False
    return rec.flush(fsync=fsync)


def set_fleet(run_id=None, host=None):
    """Adopt (or override) the active recorder's fleet identity: every
    later record carries the envelope. A world member that joined
    through ``distributed.initialize(..., elastic=True)`` adopts the
    world's run id this way. Returns the recorder, or None when
    disabled."""
    rec = _active
    if rec is None:
        return None
    with _lock:
        if run_id:
            rec.fleet_run_id = str(run_id)
        if host:
            rec.fleet_host = str(host)
        if rec.fleet_run_id is not None and rec.fleet_host is None:
            rec.fleet_host = f"pid{os.getpid()}"
    return rec


def set_generation(generation):
    """Stamp the live elastic generation into the active recorder's
    envelope (workers at every world join, the in-process simulator at
    every shrink); None clears it. No-op when disabled."""
    rec = _active
    if rec is None:
        return None
    with _lock:
        rec.fleet_generation = (None if generation is None
                                else int(generation))
    return rec


def span(name, sync=None, **attrs):
    """Open a named timed scope. Disabled mode returns the shared no-op
    :data:`NULL_SPAN` (one global read, zero allocation)."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return Span(rec, name, sync, attrs)


def record_span(name, dur_s, **attrs):
    """Record an externally timed span (a scope that owns its device
    synchronization)."""
    rec = _active
    if rec is None:
        return
    rec.record({"type": "span", "name": name, "seq": rec._next_seq(),
                "dur_s": round(float(dur_s), 6), "depth": 0, "parent": None,
                "synced": True, "attrs": _jsonable(attrs) if attrs else {}},
               kind="spans")


def counter_add(name, delta):
    """Add ``delta`` to a cumulative counter."""
    rec = _active
    if rec is None:
        return
    with _lock:
        val = rec.counters.get(name, 0) + delta
        rec.counters[name] = val
    rec.record({"type": "counter", "name": name, "value": val,
                "delta": delta})


def gauge(name, value, **attrs):
    """Set a point-in-time gauge."""
    rec = _active
    if rec is None:
        return
    with _lock:
        rec.gauges[name] = value
    out = {"type": "gauge", "name": name, "value": _jsonable(value)}
    if attrs:
        out["attrs"] = _jsonable(attrs)
    rec.record(out, kind="gauge_events")


def snapshot():
    """One-dict summary of the run: spans, ledger entries, the guarantee
    audit's draws, violations and flagged sites, trade-off points, the
    sketch's counters, faults injected and the breaker's state, the
    measured MFU, and the out-of-core plane's transfer, prefetch and codec
    counters with the storage ledger's per-surface rollup. None when
    disabled."""
    rec = _active
    if rec is None:
        return None
    from ..resilience.supervisor import breaker
    from .guarantees import audit
    from .storage import surfaces_snapshot

    audit_flagged = sorted(
        site for site, a in audit(rec.guarantee_records).items()
        if a["flagged"])
    counters = rec.counters
    mfu_gauge = rec.gauges.get("profiling.mfu")
    return {
        "spans": len(rec.spans),
        "ledger_entries": len(rec.ledger_entries),
        "guarantee_records": len(rec.guarantee_records),
        "guarantee_violations": sum(
            1 for g in rec.guarantee_records if g.get("violated")),
        "audit_flagged": audit_flagged,
        "tradeoff_records": len(rec.tradeoff_records),
        "sketch_estimates": int(counters.get("sketch.estimates", 0)),
        "total_transfer_bytes": int(
            counters.get("streaming.transfer_bytes", 0)),
        "faults_injected": len(rec.fault_events),
        "breaker_state": breaker.state(),
        "breaker_trips": int(breaker.trips),
        # the run's measured MFU gauge (utils.profiling.mfu), None until
        # something priced one
        "measured_mfu": (round(float(mfu_gauge), 6)
                         if isinstance(mfu_gauge, (int, float)) else None),
        "prefetch_hits": int(counters.get("oocore.prefetch_hits", 0)),
        "prefetch_stalls": int(counters.get("oocore.prefetch_stalls", 0)),
        "prefetch_stall_s": round(float(
            counters.get("oocore.prefetch_stall_s", 0.0)), 6),
        "codec_bytes_in": int(counters.get("oocore.codec_bytes_in", 0)),
        "codec_bytes_out": int(counters.get("oocore.codec_bytes_out", 0)),
        "io_records": len(rec.io_records),
        "storage_surfaces": surfaces_snapshot(rec),
        # the serving plane: slo summaries, degraded batches, the result
        # cache's traffic, warmed signatures and their dispatch hits, the
        # bytes serving moved, budget alerts and controller decisions
        "slo_records": len(rec.slo_records),
        "serving_degraded": int(
            counters.get("serving.degraded_batches", 0)),
        "serving_failed_batches": int(
            counters.get("serving.failed_batches", 0)),
        "serve_cache_hits": int(counters.get("serving.cache_hits", 0)),
        "serve_cache_misses": int(counters.get("serving.cache_misses", 0)),
        "serve_cache_spills": int(counters.get("serving.cache_spills", 0)),
        "serve_cache_disk_hits": int(
            counters.get("serving.cache_disk_hits", 0)),
        "aot_compiles": int(counters.get("serving.aot_compiles", 0)),
        "aot_cache_hits": int(counters.get("serving.aot_cache_hits", 0)),
        "aot_cache_misses": int(
            counters.get("serving.aot_cache_misses", 0)),
        "serving_transfer_bytes": int(
            counters.get("serving.transfer_bytes", 0)),
        "budget_records": len(rec.budget_records),
        "budget_alerts": len(rec.alert_records),
        "control_records": len(rec.control_records),
        "probes": len(rec.probe_events),
        # the elastic world: transitions recorded, host failures
        # declared and the highest generation reached
        "elastic_records": len(rec.elastic_records),
        "elastic_host_failures": sum(
            1 for e in rec.elastic_records
            if e.get("event") == "host_fail"),
        "elastic_generation": max(
            (int(e["generation"]) for e in rec.elastic_records
             if isinstance(e.get("generation"), int)), default=None),
    }


def _default_path():
    """Sink path of the run that ``SQ_OBS=1`` enables: ``SQ_OBS_PATH``;
    else, with ``SQ_OBS_FLEET_DIR``, ``<dir>/obs.<host>.jsonl``."""
    path = _knobs.get_raw("SQ_OBS_PATH")
    if path:
        return path
    fleet_dir = _knobs.get_str("SQ_OBS_FLEET_DIR", "")
    if fleet_dir:
        host = (_knobs.get_str("SQ_OBS_FLEET_HOST", "")
                or f"pid{os.getpid()}")
        try:
            os.makedirs(fleet_dir, exist_ok=True)
            return os.path.join(fleet_dir, f"obs.{host}.jsonl")
        except OSError:
            pass  # an unwritable fleet directory: the default path
    return DEFAULT_PATH


# SQ_OBS=1 enables at first import, sink at SQ_OBS_PATH; the atexit
# disable flushes the sink of a run that never calls disable() itself
# (and renders its trace under SQ_OBS_TRACE)
if _knobs.get_bool("SQ_OBS"):
    enable(_default_path())
    import atexit

    atexit.register(disable)
