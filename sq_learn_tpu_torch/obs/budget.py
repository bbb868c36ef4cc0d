"""Per-tenant error-budget ledger: latency-SLO and (ε, δ) burn rates
(counterpart of ``sq_learn_tpu/obs/budget.py``).

An SRE-style ledger that tracks, per tenant and per rolling window, how
fast two budgets burn:

- **Latency-SLO burn.** A tenant's declared p50/p99 targets define an
  error budget: a p99 target *allows* 1 % of requests over it (a p50
  target allows 50 %). ``slo_burn`` is the observed fraction of window
  requests over the p99 target (the p50 target when only p50 is
  declared), and the latency **burn rate** is the observed violating
  fraction divided by the allowed fraction.
- **Statistical burn.** Guarantee draws attributed to the tenant (the
  live ``serving.quant.*`` fold audits) burn the declared δ budget.
  ``stat_burn`` is the violated-draw fraction; the statistical burn rate
  is the Clopper–Pearson lower confidence bound on the failure rate
  divided by the declared failure probability, so a single unlucky draw
  never alarms.

**Multi-window alerting**: each tenant is evaluated over every window of
``SQ_OBS_BUDGET_WINDOWS`` (default ``60,600`` seconds). An ``alert``
record fires only when a kind's burn rate meets ``SQ_OBS_BUDGET_BURN``
(default 2.0) in **every** window; ``SQ_OBS_BUDGET_STRICT=1`` escalates
it to a raised :class:`BudgetBurnError` after the records land.

Every evaluation lands as ``budget`` records (one per tenant × window)
plus ``alert`` records for tripped tenants, each with a ledger-scoped
monotonic ``seq``. The serving dispatcher emits them on its periodic SLO
flush (``SQ_SERVE_SLO_FLUSH_BATCHES``) and at close, and constructs a
ledger only under an active recorder.

Standard library only, like :mod:`.guarantees`: the collect/render/CLI
half runs in processes that never load torch.
"""

import collections
import math
import threading
import time

from .guarantees import clopper_pearson_lower
from .. import _knobs

__all__ = [
    "BudgetBurnError",
    "BudgetLedger",
    "DEFAULT_BURN_THRESHOLD",
    "DEFAULT_WINDOWS",
    "burn_threshold",
    "collect",
    "main",
    "render",
    "strict",
    "windows",
]

#: default rolling windows in seconds (short, long): the multi-window
#: burn-rate pattern — short catches a fast burn, long filters blips
DEFAULT_WINDOWS = (60.0, 600.0)

#: default burn-rate threshold: budget burning at >= 2x its refill rate
#: in EVERY window trips the alert (2.0 is also the maximum possible
#: rate of a p50 target, so a p50-only tenant alerts exactly when every
#: request violates)
DEFAULT_BURN_THRESHOLD = 2.0

#: burn-rate ceiling recorded in place of an unbounded ratio (a declared
#: fail_prob of 0 with observed violations burns "infinitely fast";
#: JSONL must stay portable, so the record carries this sentinel cap)
MAX_BURN_RATE = 1e6

#: allowed violating fraction per declared percentile target: the error
#: budget a pXX latency target grants by definition
ALLOWED_FRACTION = {"p50": 0.50, "p99": 0.01}


class BudgetBurnError(RuntimeError):
    """A tenant's error budget is burning at or past the threshold in
    every configured window (raised under ``SQ_OBS_BUDGET_STRICT=1``);
    the message carries the per-window burn rates."""


def windows():
    """The configured rolling windows in seconds
    (``SQ_OBS_BUDGET_WINDOWS``, comma-separated, default ``60,600``)."""
    raw = _knobs.get_raw("SQ_OBS_BUDGET_WINDOWS")
    if not raw:
        return DEFAULT_WINDOWS
    out = tuple(sorted(float(w) for w in raw.split(",") if w.strip()))
    return out or DEFAULT_WINDOWS


def burn_threshold():
    """The multi-window alert threshold (``SQ_OBS_BUDGET_BURN``,
    default 2.0): the burn rate that must hold in EVERY window."""
    return _knobs.get_float("SQ_OBS_BUDGET_BURN")


def strict():
    """True when a tripped alert must raise
    (``SQ_OBS_BUDGET_STRICT=1``)."""
    return _knobs.get_bool("SQ_OBS_BUDGET_STRICT")


def _percentile(values, q):
    """Nearest-rank percentile of a non-empty sequence (the SLO read:
    an actually-observed value, never an interpolation)."""
    ordered = sorted(values)
    rank = min(len(ordered), max(1, math.ceil(len(ordered) * q)))
    return ordered[rank - 1]


class _TenantState:
    """One tenant's rolling event history + run-scoped totals."""

    __slots__ = ("requests", "draws", "p50_ms", "p99_ms", "fail_prob",
                 "total_requests", "total_draws")

    def __init__(self):
        #: (ts, latency_ms) — pruned past the longest window
        self.requests = collections.deque()
        #: (ts, violated) — pruned past the longest window
        self.draws = collections.deque()
        self.p50_ms = None
        self.p99_ms = None
        #: LARGEST declared failure probability seen (auditing against
        #: the loosest declaration is conservative — guarantees.audit)
        self.fail_prob = None
        self.total_requests = 0
        self.total_draws = 0


class BudgetLedger:
    """Per-tenant rolling error-budget scoreboard.

    The serving dispatcher owns one (created only under an active
    recorder — the disabled path never allocates), feeds it request
    latencies and guarantee draws attributed to tenants, and calls
    :meth:`emit` on its periodic SLO flush and at close. All ``note_*``
    inputs are host-clock monotonic seconds (``time.perf_counter``
    epoch) so window arithmetic is immune to wall-clock steps; tests
    pass explicit ``ts``/``now`` for determinism.
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/obs/budget.py``'s
    #: map): the tenant table and the emit counter are only written under
    #: ``self._lock``; ``_state``/``_prune`` run with the lock held.
    _GUARDED_BY = {"_lock": ("_tenants", "_emit_seq")}
    _ASSUMES_LOCK = ("_state", "_prune")

    def __init__(self, window_seconds=None, threshold=None,
                 site="serving.dispatcher"):
        self.windows = (windows() if window_seconds is None
                        else tuple(sorted(float(w)
                                          for w in window_seconds)))
        if not self.windows or min(self.windows) <= 0:
            raise ValueError(f"windows must be positive seconds, "
                             f"got {self.windows}")
        self.threshold = (burn_threshold() if threshold is None
                          else float(threshold))
        self.site = site
        self._lock = threading.Lock()
        self._tenants = {}
        self._emit_seq = 0

    # -- inputs ------------------------------------------------------------

    def _state(self, tenant):
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState()
        return st

    def _prune(self, st, now):
        horizon = now - self.windows[-1]
        while st.requests and st.requests[0][0] < horizon:
            st.requests.popleft()
        while st.draws and st.draws[0][0] < horizon:
            st.draws.popleft()

    def note_request(self, tenant, latency_s, p50_ms=None, p99_ms=None,
                     ts=None):
        """Record one served request for ``tenant`` with the tenant's
        declared targets (None = that percentile undeclared)."""
        self.note_requests(tenant, (latency_s,), p50_ms=p50_ms,
                           p99_ms=p99_ms, ts=ts)

    def note_requests(self, tenant, latencies_s, p50_ms=None, p99_ms=None,
                      ts=None):
        """Batch form: one lock acquisition per dispatched batch (the
        scatter path runs per batch, not per request)."""
        if ts is None:
            ts = time.perf_counter()
        with self._lock:
            st = self._state(str(tenant))
            if p50_ms is not None:
                st.p50_ms = float(p50_ms)
            if p99_ms is not None:
                st.p99_ms = float(p99_ms)
            for lat in latencies_s:
                st.requests.append((ts, float(lat) * 1e3))
                st.total_requests += 1
            self._prune(st, ts)

    def note_draw(self, tenant, violated, fail_prob=None, ts=None):
        """Record one guarantee draw attributed to ``tenant`` against
        its declared failure probability δ/γ."""
        if ts is None:
            ts = time.perf_counter()
        with self._lock:
            st = self._state(str(tenant))
            st.draws.append((ts, bool(violated)))
            st.total_draws += 1
            if fail_prob is not None:
                fp = float(fail_prob)
                if st.fail_prob is None or fp > st.fail_prob:
                    st.fail_prob = fp
            self._prune(st, ts)

    def tenants(self):
        with self._lock:
            return sorted(self._tenants)

    def total_requests(self, tenant):
        """Run-scoped request count for ``tenant`` (the reconciliation
        number the load bench checks against the aggregate slo record)."""
        with self._lock:
            st = self._tenants.get(str(tenant))
            return st.total_requests if st is not None else 0

    # -- burn math ---------------------------------------------------------

    def window_stats(self, tenant, window_s, now=None):
        """One tenant's burn numbers over the trailing ``window_s``
        seconds — the dict one ``budget`` record serializes.

        ``slo_burn`` = violating-request fraction of the budget-defining
        target (p99 when declared, else p50); the latency burn rate is
        the max over declared targets of fraction/allowed. ``stat_burn``
        = violated-draw fraction; the statistical burn rate is
        cp_lower_bound / declared fail_prob. ``burn_rate`` = the worst
        of the two (None when the tenant declared nothing observable).
        """
        if now is None:
            now = time.perf_counter()
        window_s = float(window_s)
        with self._lock:
            st = self._tenants.get(str(tenant))
            if st is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            horizon = now - window_s
            lats = [lat for ts, lat in st.requests if ts >= horizon]
            draws = [v for ts, v in st.draws if ts >= horizon]
            p50_t, p99_t, fail_prob = st.p50_ms, st.p99_ms, st.fail_prob
        n = len(lats)
        over_p50 = (sum(1 for lat in lats if lat > p50_t)
                    if p50_t is not None else None)
        over_p99 = (sum(1 for lat in lats if lat > p99_t)
                    if p99_t is not None else None)
        slo_burn = None
        slo_rate = None
        if n:
            rates = []
            for key, over in (("p50", over_p50), ("p99", over_p99)):
                if over is None:
                    continue
                frac = over / n
                rates.append(frac / ALLOWED_FRACTION[key])
                # the budget-defining target: p99 when declared (the
                # tightest budget), else p50
                if key == "p99" or slo_burn is None:
                    slo_burn = frac
            if rates:
                slo_rate = max(rates)
        d = len(draws)
        viol = sum(1 for v in draws if v)
        stat_burn = (viol / d) if d else None
        cp = clopper_pearson_lower(viol, d) if d else None
        stat_rate = None
        if cp is not None and fail_prob is not None:
            if fail_prob > 0.0:
                stat_rate = min(cp / fail_prob, MAX_BURN_RATE)
            else:
                stat_rate = MAX_BURN_RATE if cp > 0.0 else 0.0
        candidates = [r for r in (slo_rate, stat_rate) if r is not None]
        burn_rate = max(candidates) if candidates else None
        targets = {}
        if p50_t is not None:
            targets["p50_ms"] = p50_t
        if p99_t is not None:
            targets["p99_ms"] = p99_t
        return {
            "tenant": str(tenant),
            "window_s": window_s,
            "requests": n,
            "over_p50": over_p50,
            "over_p99": over_p99,
            "p50_ms": round(_percentile(lats, 0.50), 4) if lats else None,
            "p99_ms": round(_percentile(lats, 0.99), 4) if lats else None,
            "slo_burn": (round(slo_burn, 6) if slo_burn is not None
                         else None),
            "slo_burn_rate": (round(slo_rate, 6) if slo_rate is not None
                              else None),
            "draws": d,
            "draw_violations": viol,
            "stat_burn": (round(stat_burn, 6) if stat_burn is not None
                          else None),
            "cp_lower_bound": round(cp, 6) if cp is not None else None,
            "stat_burn_rate": (round(stat_rate, 6)
                               if stat_rate is not None else None),
            "burn_rate": (round(burn_rate, 6) if burn_rate is not None
                          else None),
            "fail_prob": fail_prob,
            "targets": targets,
            "alerting": (burn_rate is not None
                         and burn_rate >= self.threshold),
        }

    def summary(self, now=None):
        """``{tenant: {window_s: stats}}`` across every configured
        window (no records emitted — the read-only view)."""
        if now is None:
            now = time.perf_counter()
        return {t: {w: self.window_stats(t, w, now) for w in self.windows}
                for t in self.tenants()}

    def alerts(self, now=None, summary=None):
        """Tripped multi-window alerts: one dict per (tenant, kind)
        whose burn rate meets the threshold in EVERY window."""
        summary = self.summary(now) if summary is None else summary
        out = []
        for tenant in sorted(summary):
            per_window = summary[tenant]
            for kind in ("slo_burn", "stat_burn"):
                rates = {w: s.get(f"{kind}_rate")
                         for w, s in per_window.items()}
                if rates and all(r is not None and r >= self.threshold
                                 for r in rates.values()):
                    out.append({
                        "tenant": tenant,
                        "kind": kind,
                        "threshold": self.threshold,
                        "burn_rates": {f"{w:g}s": r
                                       for w, r in rates.items()},
                    })
        return out

    # -- emission ----------------------------------------------------------

    def _next_emit_seq(self):
        """Ledger-scoped monotonic counter stamped on every emitted
        ``budget``/``alert`` line (schema v8): wall-clock ``ts`` values
        collide at millisecond resolution, so the trace exporter breaks
        ties on this instead of file order."""
        with self._lock:
            seq = self._emit_seq
            self._emit_seq = seq + 1
        return seq

    def emit(self, now=None):
        """Record one ``budget`` line per tenant × window plus ``alert``
        lines for tripped tenants; returns ``(summary, alerts)``. Under
        ``SQ_OBS_BUDGET_STRICT=1`` a tripped alert raises AFTER every
        record lands — the artifact must carry the evidence of the burn
        it reports (the SloTracker rule)."""
        from . import recorder

        summary = self.summary(now)
        alerts = self.alerts(summary=summary)
        rec = recorder.get_recorder()
        if rec is not None:
            for tenant in sorted(summary):
                for w in self.windows:
                    s = summary[tenant][w]
                    entry = {"type": "budget", "site": self.site,
                             "seq": self._next_emit_seq()}
                    entry.update(
                        (k, v) for k, v in s.items()
                        if (v is not None and not (k == "targets"
                                                   and not v))
                        or k in ("slo_burn", "stat_burn",
                                 "cp_lower_bound", "burn_rate"))
                    rec.record(entry, kind="budget_records")
            for a in alerts:
                rec.record(dict(a, type="alert", site=self.site,
                                seq=self._next_emit_seq()),
                           kind="alert_records")
        if alerts and strict():
            worst = alerts[0]
            raise BudgetBurnError(
                f"error budget of tenant {worst['tenant']!r} burning at "
                f">= {self.threshold}x in every window "
                f"({worst['kind']}: {worst['burn_rates']}) "
                f"(SQ_OBS_BUDGET_STRICT=1)")
        return summary, alerts


# ---------------------------------------------------------------------------
# File-tool half (collect / render / CLI) — standard library only
# ---------------------------------------------------------------------------


def collect(records):
    """Aggregate decoded records into the budget view: ``{"tenants":
    {tenant: {window_s: last budget record}}, "alerts": [...]}`` —
    cumulative rolling windows, so the LAST record per (tenant, window)
    is the run's final word (the counter convention)."""
    tenants = {}
    alerts = []
    for r in records:
        if not isinstance(r, dict):
            continue
        if r.get("type") == "budget":
            t = r.get("tenant")
            w = r.get("window_s")
            tenants.setdefault(t, {})[w] = r
        elif r.get("type") == "alert":
            alerts.append(r)
    return {"tenants": tenants, "alerts": alerts}


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float) and (abs(v) >= 1e5 or 0 < abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def render(view):
    """Format a :func:`collect` view as the report's tenant
    error-budget table."""
    lines = []
    out = lines.append
    tenants = view.get("tenants") or {}
    if not tenants:
        return "  (no budget records)"
    for tenant in sorted(tenants, key=str):
        for w in sorted(tenants[tenant], key=lambda x: (x is None, x)):
            r = tenants[tenant][w]
            flag = "  ALERTING" if r.get("alerting") else ""
            out(f"  {str(tenant):<12} {_fmt(w):>6}s  "
                f"req={r.get('requests', 0):<6} "
                f"slo_burn={_fmt(r.get('slo_burn')):>8}  "
                f"stat_burn={_fmt(r.get('stat_burn')):>8}  "
                f"cp_lb={_fmt(r.get('cp_lower_bound')):>8}  "
                f"burn_rate={_fmt(r.get('burn_rate')):>8}{flag}")
    for a in view.get("alerts") or []:
        out(f"  ALERT {a.get('tenant')}: {a.get('kind')} >= "
            f"{_fmt(a.get('threshold'))}x in every window "
            f"({a.get('burn_rates')})")
    return "\n".join(lines)


def main(argv):
    """``budget <jsonl> [more.jsonl ...] [--json]`` — render the
    per-tenant error-budget table of one or more obs JSONL artifacts;
    exits 1 when any alert fired or any budget record is alerting (the
    CI-friendly burn check), 0 when budgets are healthy, and 2 when the
    artifacts carry ZERO budget records — "no telemetry" must never
    read as "no burn" in CI."""
    import json
    import sys

    as_json = "--json" in argv
    paths = [a for a in argv if a != "--json"]
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs budget <jsonl> "
              "[more.jsonl ...] [--json]", file=sys.stderr)
        return 2
    from ._files import load_jsonl

    records = []
    for p in paths:
        records.extend(load_jsonl(p))
    view = collect(records)
    if not view["tenants"] and not view["alerts"]:
        if as_json:
            print(json.dumps(dict(view, burning=False,
                                  error="no budget telemetry")))
        print(f"no budget telemetry: zero budget records in "
              f"{', '.join(paths)}", file=sys.stderr)
        return 2
    burning = bool(view["alerts"]) or any(
        r.get("alerting") for per_w in view["tenants"].values()
        for r in per_w.values())
    if as_json:
        print(json.dumps(dict(view, burning=burning)))
    else:
        print("== tenant error budgets (multi-window burn rates) ==")
        print(render(view))
        alerting = sorted({a.get("tenant") for a in view["alerts"]})
        print(f"burning: {alerting if burning else 'none'}")
    return 1 if burning else 0
