"""Serving SLO accounting: p50/p99 latency, sustained QPS, batch
occupancy, degrade counts — per run, per tenant, per flush window
(counterpart of ``sq_learn_tpu/serving/slo.py``).

- :class:`SloTracker` collects one entry per served request (submit →
  result on the host clock) and one per dispatched batch (valid rows
  against bucket rows, the padded payload bytes, and whether the batch
  ran degraded). Under an active recorder the same inputs also
  accumulate per tenant (a batch spans tenants only when they share a
  fingerprint, a megabatch; the dispatcher then passes per-tenant
  ``parts``) and into a since-last-flush window; with ``SQ_OBS`` unset
  neither exists.
- :meth:`SloTracker.emit` folds the run into ``slo`` records: one per
  tenant (its declared targets and its queue / coalesce / assemble /
  transfer / compute / scatter ``stages`` in seconds), then the run
  aggregate: p50/p99 in ms, QPS over the submit → last-result window,
  mean batch occupancy, degrade count and ``violated``.
- :meth:`SloTracker.flush_window` emits one windowed ``slo`` record
  (``attrs.windowed``) and resets the window; the dispatcher calls it
  every ``SQ_SERVE_SLO_FLUSH_BATCHES`` batches. Windowed records are
  telemetry, never gated.

Targets come from the dispatcher's ``slo_p50_ms``/``slo_p99_ms`` or the
``SQ_SERVE_SLO_P50_MS``/``SQ_SERVE_SLO_P99_MS`` knobs; a tenant's own
declared targets (``ModelRegistry.register(..., slo_p50_ms=,
slo_p99_ms=)``) override them for its record. ``SQ_SERVE_SLO_STRICT=1``
turns a violated close-time aggregate into a raised
:class:`SloViolation`.

Percentiles are nearest-rank (the ceil(q·n)-th order statistic): p99 is
an observed latency, never an interpolation.
"""

import threading
import time

from .. import obs as _obs
from .. import _knobs

__all__ = ["SloTracker", "SloViolation", "percentile",
           "slo_flush_batches"]


class SloViolation(RuntimeError):
    """A declared p50/p99 target was exceeded under
    ``SQ_SERVE_SLO_STRICT=1``; the message carries the realized and
    declared numbers."""


def percentile(values, q):
    """Nearest-rank percentile (q in (0, 1]) of a non-empty sequence."""
    import math

    ordered = sorted(values)
    rank = min(len(ordered), max(1, math.ceil(len(ordered) * q)))
    return ordered[rank - 1]


def _env_target(raw):
    return float(raw) if raw else None


def slo_flush_batches():
    """Windowed-flush stride in dispatched batches
    (``SQ_SERVE_SLO_FLUSH_BATCHES``, default 256; 0 disables): every Nth
    batch the dispatcher emits a windowed ``slo`` record and the
    tenant ``budget`` records, so long-running servers emit windows and
    a crash doesn't lose the history."""
    return _knobs.get_int("SQ_SERVE_SLO_FLUSH_BATCHES")


class _Accum:
    """One accounting scope (the run, a flush window, or a tenant)."""

    __slots__ = ("latencies_s", "batches", "occupancy_sum", "degraded",
                 "transfer_bytes", "first_submit", "last_done", "stages",
                 "p50_ms", "p99_ms")

    def __init__(self, p50_ms=None, p99_ms=None):
        self.latencies_s = []
        self.batches = 0
        self.occupancy_sum = 0.0
        self.degraded = 0
        self.transfer_bytes = 0
        self.first_submit = None
        self.last_done = None
        self.stages = {}
        self.p50_ms = p50_ms
        self.p99_ms = p99_ms

    def note_request(self, submitted_ts, done_ts):
        self.latencies_s.append(done_ts - submitted_ts)
        if self.first_submit is None or submitted_ts < self.first_submit:
            self.first_submit = submitted_ts
        if self.last_done is None or done_ts > self.last_done:
            self.last_done = done_ts

    def note_batch(self, valid_rows, bucket_rows, degraded, nbytes):
        self.batches += 1
        self.occupancy_sum += (valid_rows / bucket_rows
                               if bucket_rows else 0.0)
        self.transfer_bytes += int(nbytes)
        if degraded:
            self.degraded += 1

    def add_stages(self, stages):
        for k, v in stages.items():
            self.stages[k] = self.stages.get(k, 0.0) + float(v)


class SloTracker:
    """Thread-safe per-run serving scoreboard (one per dispatcher)."""

    def __init__(self, site="serving.dispatcher", slo_p50_ms=None,
                 slo_p99_ms=None):
        self.site = site
        self.slo_p50_ms = (
            slo_p50_ms if slo_p50_ms is not None
            else _env_target(_knobs.get_raw("SQ_SERVE_SLO_P50_MS")))
        self.slo_p99_ms = (
            slo_p99_ms if slo_p99_ms is not None
            else _env_target(_knobs.get_raw("SQ_SERVE_SLO_P99_MS")))
        self._lock = threading.Lock()
        self._run = _Accum()
        #: since-last-flush window + per-tenant accumulators: populated
        #: only under an active recorder (one module-global read per
        #: note) — the disabled hot path allocates nothing extra
        self._win = _Accum()
        self._win_seq = 0
        self._tenants = {}

    # -- inputs ------------------------------------------------------------

    def note_submit(self, ts=None):
        ts = time.perf_counter() if ts is None else ts
        with self._lock:
            run = self._run
            if run.first_submit is None or ts < run.first_submit:
                run.first_submit = ts
        return ts

    def _tenant_accum(self, tenant, targets):
        acc = self._tenants.get(tenant)
        if acc is None:
            acc = self._tenants[tenant] = _Accum()
        if targets is not None:
            p50, p99 = targets
            if p50 is not None:
                acc.p50_ms = float(p50)
            if p99 is not None:
                acc.p99_ms = float(p99)
        return acc

    def note_request_done(self, submitted_ts, ts=None, tenant=None,
                          targets=None):
        """One request resolved outside a batch (the result-cache hit
        path). ``tenant``/``targets`` attribute it per tenant — passed
        only under an active recorder (the dispatcher's rule)."""
        ts = time.perf_counter() if ts is None else ts
        with self._lock:
            self._run.note_request(submitted_ts, ts)
            if _obs.enabled():
                self._win.note_request(submitted_ts, ts)
                if tenant is not None:
                    self._tenant_accum(str(tenant), targets).note_request(
                        submitted_ts, ts)

    def note_batch(self, valid_rows, bucket_rows, degraded, nbytes=0):
        """A dispatched batch whose requests resolved exceptionally —
        batch-level accounting only (the futures carry the failure)."""
        with self._lock:
            self._run.note_batch(valid_rows, bucket_rows, degraded, nbytes)
            if _obs.enabled():
                self._win.note_batch(valid_rows, bucket_rows, degraded,
                                     nbytes)

    def note_batch_done(self, submit_timestamps, done_ts, valid_rows,
                        bucket_rows, degraded, nbytes=0, tenant=None,
                        targets=None, stages=None, parts=None):
        """One dispatched batch's whole scoreboard update under a single
        lock — the scatter path runs per batch, not per request (the
        per-request lock traffic was a measurable slice of the
        micro-batching amortization floor). ``nbytes`` is the padded
        payload the batch moved host→device — the quantized route's
        bytes-halved claim is read off this tally. ``tenant`` attributes
        a single-tenant batch, ``targets`` the tenant's resolved
        (p50, p99) targets, ``stages`` the batch's latency decomposition
        in seconds. A cross-tenant megabatch passes ``parts`` instead:
        one ``(tenant, submit_ts_list, rows, part_nbytes, targets,
        part_stages)`` tuple per tenant, in submission order — the run
        and window scopes still count the batch ONCE (Σ per-tenant
        requests == the run aggregate is the reconciliation gate),
        while each tenant accumulator is billed exactly its own rows,
        its row-share of the payload bytes, and its split of the stage
        decomposition. All attribution arguments are passed only under
        an active recorder, so the disabled path stays byte-identical."""
        with self._lock:
            run = self._run
            for ts in submit_timestamps:
                run.note_request(ts, done_ts)
            run.note_batch(valid_rows, bucket_rows, degraded, nbytes)
            if (tenant is None and stages is None and parts is None
                    and not _obs.enabled()):
                return
            if _obs.enabled():
                win = self._win
                for ts in submit_timestamps:
                    win.note_request(ts, done_ts)
                win.note_batch(valid_rows, bucket_rows, degraded, nbytes)
            if stages:
                run.add_stages(stages)
            if parts is not None:
                for (t, ts_list, rows, part_nbytes, tgt, st) in parts:
                    acc = self._tenant_accum(str(t), tgt)
                    for ts in ts_list:
                        acc.note_request(ts, done_ts)
                    acc.note_batch(rows, bucket_rows, degraded,
                                   part_nbytes)
                    if st:
                        acc.add_stages(st)
            elif tenant is not None:
                acc = self._tenant_accum(str(tenant), targets)
                for ts in submit_timestamps:
                    acc.note_request(ts, done_ts)
                acc.note_batch(valid_rows, bucket_rows, degraded, nbytes)
                if stages:
                    acc.add_stages(stages)

    def transfer_bytes(self):
        """Total padded payload bytes moved so far (the dispatcher
        flushes this into the ``serving.transfer_bytes`` counter at
        close)."""
        with self._lock:
            return self._run.transfer_bytes

    # -- outputs -----------------------------------------------------------

    def _summarize(self, acc, p50_t, p99_t, tenant=None):
        """Fold one accumulator into the record dict (lock held by the
        caller or the accumulator already detached)."""
        lat = list(acc.latencies_s)
        window = ((acc.last_done - acc.first_submit)
                  if lat and acc.last_done is not None
                  and acc.first_submit is not None else 0.0)
        n = len(lat)
        p50 = percentile(lat, 0.50) * 1e3 if lat else 0.0
        p99 = percentile(lat, 0.99) * 1e3 if lat else 0.0
        qps = (n / window) if window > 0 else 0.0
        occupancy = (acc.occupancy_sum / acc.batches) if acc.batches else 0.0
        targets = {}
        if p50_t is not None:
            targets["p50_ms"] = p50_t
        if p99_t is not None:
            targets["p99_ms"] = p99_t
        violated = bool((p50_t is not None and p50 > p50_t)
                        or (p99_t is not None and p99 > p99_t))
        out = {
            "site": self.site,
            "requests": n,
            "batches": acc.batches,
            "p50_ms": round(p50, 4),
            "p99_ms": round(p99, 4),
            "qps": round(qps, 3),
            "batch_occupancy": round(min(1.0, occupancy), 4),
            "degraded": acc.degraded,
            "transfer_bytes": acc.transfer_bytes,
            "window_s": round(window, 6),
            "violated": violated,
            **({"targets": targets} if targets else {}),
        }
        if tenant is not None:
            out["tenant"] = tenant
        if acc.stages:
            out["stages"] = {k: round(v, 6)
                             for k, v in sorted(acc.stages.items())}
        return out

    def summary(self):
        """The run-so-far numbers as a plain dict (ms/qps scale)."""
        with self._lock:
            return self._summarize(self._run, self.slo_p50_ms,
                                   self.slo_p99_ms)

    def tenant_summaries(self):
        """``{tenant: summary}`` of the per-tenant accumulators (empty
        unless a recorder was active during the run). A tenant's own
        declared targets take precedence over the run-level ones."""
        with self._lock:
            return {
                t: self._summarize(
                    acc,
                    acc.p50_ms if acc.p50_ms is not None
                    else self.slo_p50_ms,
                    acc.p99_ms if acc.p99_ms is not None
                    else self.slo_p99_ms,
                    tenant=t)
                for t, acc in sorted(self._tenants.items())}

    def flush_window(self):
        """Emit one *windowed* ``slo`` record from the since-last-flush
        accumulators and reset them; returns the summary (None when the
        window saw nothing). Telemetry only — never strict-gated."""
        with self._lock:
            acc = self._win
            if not acc.latencies_s and not acc.batches:
                return None
            self._win = _Accum()
            self._win_seq += 1
            seq = self._win_seq
        summary = self._summarize(acc, self.slo_p50_ms, self.slo_p99_ms)
        summary["attrs"] = {"windowed": True, "flush_seq": seq}
        rec = _obs.get_recorder()
        if rec is not None:
            rec.record(dict(summary, type="slo"), kind="slo_records")
        return summary

    def emit(self):
        """The run's ``slo`` records: one per tenant (when a recorder
        tracked tenants), then the run aggregate. Always returns the
        aggregate summary dict (recorded only when a recorder is
        active); under ``SQ_SERVE_SLO_STRICT=1`` a violated aggregate
        raises :class:`SloViolation` AFTER every record lands — the
        artifact must carry the evidence of the violation it reports."""
        tenant_records = self.tenant_summaries()
        summary = self.summary()
        rec = _obs.get_recorder()
        if rec is not None:
            for t in sorted(tenant_records):
                rec.record(dict(tenant_records[t], type="slo"),
                           kind="slo_records")
            rec.record(dict(summary, type="slo"), kind="slo_records")
        if summary["violated"] and \
                _knobs.get_bool("SQ_SERVE_SLO_STRICT"):
            raise SloViolation(
                f"serving SLO violated at {self.site}: realized "
                f"p50={summary['p50_ms']}ms p99={summary['p99_ms']}ms "
                f"against targets {summary.get('targets')}")
        return summary
