"""SLO-driven (ε, δ) autotuner + admission control: the serving control
plane's live half (counterpart of ``sq_learn_tpu/serving/control.py``).

A :class:`Controller`, owned by the :class:`~sq_learn_tpu_torch.serving.
registry.ModelRegistry` and driven by the dispatcher every
``SQ_SERVE_AUTOTUNE_EVERY`` batches, reads the error-budget ledger's
multi-window burn telemetry (:mod:`sq_learn_tpu_torch.obs.budget`) and
acts on it before the run-level SLO gate or the burn alert trips:

- **Plan (register/warm time).** A tenant that declares accuracy headroom
  (``register(..., slo_eps=...)``) gets the cheapest route on the Pareto
  frontier of (exact, bf16, int8) whose representation error fits its ε.
  Tenants without declared headroom keep their registered route.
- **Degrade, cheapest first.** When a tenant's latency burn rate reaches
  ``SQ_SERVE_AUTOTUNE_BURN`` (1.5, below the ledger's 2.0 alert) in any
  window, it steps one rung down: (1) the quantized route (ε-headroom
  tenants only), (2) wider coalescing (a raised per-tenant bucket floor),
  (3) the host route (:data:`LEVELS`' last rung: on the card that is the
  same kernel behind a plain unsupervised copy; the tenant also stops
  megabatching). Every degrade renegotiates the tenant's ledger targets
  to the measured window percentile × :data:`RENEGOTIATE_MARGIN`.
- **Relax / tighten.** A δ-headroom tenant (``slo_delta=``) whose budget
  stays underspent (every window at or below ``SQ_SERVE_AUTOTUNE_RELAX``
  for ``SQ_SERVE_AUTOTUNE_PATIENCE`` evaluations) has its served δ
  relaxed toward ``SQ_SERVE_AUTOTUNE_DELTA_CAP`` × the declaration; a
  rising statistical burn tightens it back first.
- **Recover.** A degraded tenant that stays underspent for a patience
  streak steps back up, most recent rung first.

Every evaluation lands as a ``control`` record (the telemetry consumed,
the decision, its predicted effect and the realized effect of the
previous one), read by ``python -m sq_learn_tpu_torch.obs control`` and
the report. ``SQ_SERVE_AUTOTUNE=0`` (or ``autotune=False``) pins the
static plane; with ``SQ_OBS`` unset no controller state exists.
"""

import threading
import time

from .. import _knobs
from ..obs.frontier import pareto
from . import quantize as _quant

__all__ = ["Controller", "LEVELS", "RENEGOTIATE_MARGIN", "ROUTE_COST",
           "autotune_enabled", "autotune_every", "record_control",
           "theoretical_cost"]

#: renegotiation headroom: a degraded tenant's new latency target is
#: the measured window percentile times this factor — achievable by
#: construction (the measurement IS the evidence), with margin so the
#: re-based burn lands well under the relax threshold, not at 1.0
RENEGOTIATE_MARGIN = 2.0

#: the admission-control ladder, cheapest intervention first; a
#: tenant's ``level`` is how many rungs it currently stands down
LEVELS = ("normal", "quantized", "widened", "host")

#: relative transfer-cost weight per serving route (the quantized
#: routes move half / a quarter of the bytes across the host→device
#: boundary — serving.quantize's headline claim, bench-verified)
ROUTE_COST = {None: 1.0, "bf16": 0.5, "int8": 0.25}

#: per-element relative representation error per route (the accuracy
#: axis of the plan-time frontier; quantize.REL_STEP plus the exact
#: route's zero)
ROUTE_EPS = {None: 0.0, "bf16": _quant.REL_STEP["bf16"],
             "int8": _quant.REL_STEP["int8"]}


def autotune_enabled():
    """Process-default autotune latch (``SQ_SERVE_AUTOTUNE``, default
    on; 0 pins the static serving plane bit-identically — the
    dispatcher's ``autotune=`` argument overrides per instance)."""
    return _knobs.get_bool("SQ_SERVE_AUTOTUNE")


def autotune_every():
    """Controller cadence in dispatched batches
    (``SQ_SERVE_AUTOTUNE_EVERY``, default 32; 0 disables the periodic
    evaluation — close-time still evaluates once)."""
    return _knobs.get_int("SQ_SERVE_AUTOTUNE_EVERY")


def degrade_threshold():
    """Latency burn rate that triggers a degrade step
    (``SQ_SERVE_AUTOTUNE_BURN``, default 1.5 — deliberately below the
    ledger's 2.0 alert threshold: the controller acts BEFORE the alert
    can trip)."""
    return _knobs.get_float("SQ_SERVE_AUTOTUNE_BURN")


def relax_threshold():
    """Burn rate at or below which a window counts as underspent
    (``SQ_SERVE_AUTOTUNE_RELAX``, default 0.25)."""
    return _knobs.get_float("SQ_SERVE_AUTOTUNE_RELAX")


def relax_patience():
    """Consecutive underspent evaluations required before a relax or
    recover step (``SQ_SERVE_AUTOTUNE_PATIENCE``, default 3)."""
    return _knobs.get_int("SQ_SERVE_AUTOTUNE_PATIENCE")


def delta_cap():
    """Ceiling on the relaxed served δ, as a multiple of the declared
    δ (``SQ_SERVE_AUTOTUNE_DELTA_CAP``, default 4.0 — with cost ∝ 1/δ²
    that banks up to 16× theoretical runtime per tenant)."""
    return _knobs.get_float("SQ_SERVE_AUTOTUNE_DELTA_CAP")


def theoretical_cost(delta, route=None):
    """Relative theoretical runtime cost of serving a contract at
    failure budget ``delta`` over ``route``: the runtime model's
    1/δ² scaling (both non-well-clusterable terms of
    ``QKMeans.quantum_runtime_model`` carry it) times the route's
    transfer weight. None when the tenant declared no δ — there is no
    contract to price."""
    if delta is None or delta <= 0.0:
        return None
    return ROUTE_COST.get(route, 1.0) / (float(delta) * float(delta))


def record_control(tenant, action, seq, inputs, decision, *,
                   site="serving.control", level=0, predicted=None,
                   realized=None, **attrs):
    """Append one ``control`` record to the active run (no-op when
    observability is off; the controller only exists under an active
    recorder, so in practice every evaluation lands)."""
    from ..obs import recorder

    rec = recorder.get_recorder()
    if rec is None:
        return
    entry = {"type": "control", "tenant": str(tenant),
             "action": str(action), "seq": int(seq), "site": str(site),
             "level": int(level),
             "inputs": recorder._jsonable(inputs or {}),
             "decision": recorder._jsonable(decision or {})}
    if predicted is not None:
        entry["predicted"] = recorder._jsonable(predicted)
    if realized is not None:
        entry["realized"] = recorder._jsonable(realized)
    if attrs:
        entry["attrs"] = recorder._jsonable(attrs)
    rec.record(entry, kind="control_records")


class _TenantCtl:
    """One tenant's controller state: the declared headroom, the
    current ladder position with its applied steps (so recover can
    undo most-recent-first), the served δ, and the previous decision's
    prediction (realized on the next record)."""

    __slots__ = ("tenant", "planned", "steps", "min_rows", "host",
                 "targets", "eps_slo", "delta_slo", "delta_served",
                 "streak", "seq", "predicted")

    def __init__(self, tenant, eps_slo=None, delta_slo=None):
        self.tenant = tenant
        self.planned = False
        #: applied ladder rungs, oldest first ("quantize" | "widen" |
        #: "host"); the level IS len(steps)
        self.steps = []
        self.min_rows = None
        self.host = False
        #: renegotiated (p50_ms, p99_ms), or None = declared targets
        self.targets = None
        self.eps_slo = eps_slo
        self.delta_slo = delta_slo
        #: the served failure budget the cost accounting prices; starts
        #: at the declaration and moves only under δ headroom
        self.delta_served = delta_slo
        self.streak = 0
        self.seq = 0
        self.predicted = None

    @property
    def level(self):
        return len(self.steps)


class Controller:
    """The live autotuner. One per :class:`~sq_learn_tpu_torch.serving.
    registry.ModelRegistry` (shared by every dispatcher serving it),
    constructed lazily by :meth:`~sq_learn_tpu_torch.serving.registry.
    ModelRegistry.controller` and ONLY under an active recorder.

    Constructor overrides exist for the bench and the tests (per-call
    configuration, never env mutation — the knob registry's rule);
    every ``None`` falls back to its ``SQ_SERVE_AUTOTUNE_*`` knob.
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/serving/
    #: control.py``'s map): tenant state is only written under
    #: ``self._lock``; ``_state`` assumes the lock is held.
    _GUARDED_BY = {"_lock": ("_tenants",)}
    _ASSUMES_LOCK = ("_state",)

    def __init__(self, registry, *, burn=None, relax=None, patience=None,
                 cap=None, margin=None, site="serving.control"):
        self.registry = registry
        self.burn = degrade_threshold() if burn is None else float(burn)
        self.relax = relax_threshold() if relax is None else float(relax)
        self.patience = (relax_patience() if patience is None
                         else int(patience))
        self.cap = delta_cap() if cap is None else float(cap)
        self.margin = (RENEGOTIATE_MARGIN if margin is None
                       else float(margin))
        self.site = site
        self._lock = threading.Lock()
        self._tenants = {}

    # -- per-tenant state & the dispatcher's override hooks ----------------

    def _state(self, tenant):
        st = self._tenants.get(tenant)
        if st is None:
            eps_slo, delta_slo = self.registry.contract(tenant)
            st = self._tenants[tenant] = _TenantCtl(
                tenant, eps_slo=eps_slo, delta_slo=delta_slo)
        return st

    def targets_for(self, tenant):
        """The tenant's renegotiated ``(p50_ms, p99_ms)`` targets, or
        None when nothing was renegotiated (the dispatcher falls back
        to the declared/run-level targets)."""
        with self._lock:
            st = self._tenants.get(tenant)
            return st.targets if st is not None else None

    def min_rows_for(self, tenant, default):
        """The tenant's bucket floor: the widened per-tenant override
        when the ladder applied one, else ``default``."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None and st.min_rows is not None:
                return max(int(st.min_rows), int(default))
        return default

    def host_route(self, tenant):
        """True when admission control pinned the tenant to the host
        route (the dispatcher then also keys its batches per tenant, so
        a host-routed tenant never megabatches a healthy one along)."""
        with self._lock:
            st = self._tenants.get(tenant)
            return st is not None and st.host

    def contracts(self):
        """Per-tenant served-contract view — what the cost accounting
        (and the bench's summed-theoretical-runtime claim) reads:
        ``{tenant: {level, route, delta_declared, delta_served,
        eps_slo, cost_declared, cost_served}}``."""
        with self._lock:
            tenants = dict(self._tenants)
        out = {}
        for t, st in tenants.items():
            route = self.registry.current_route(t)
            out[t] = {
                "level": st.level,
                "route": "host" if st.host else (route or "exact"),
                "delta_declared": st.delta_slo,
                "delta_served": st.delta_served,
                "eps_slo": st.eps_slo,
                "cost_declared": theoretical_cost(st.delta_slo, route),
                "cost_served": theoretical_cost(st.delta_served, route),
            }
        return out

    # -- plan (register/warm time) -----------------------------------------

    def plan(self, tenant, replan=False):
        """Pick the tenant's serving route off the candidate frontier
        and land the ``plan`` record. Idempotent per registration
        (``replan=True`` — a re-register — re-evaluates); tenants
        without declared ε headroom keep their registered route, but
        STILL land a record: a silent controller is indistinguishable
        from a dead one."""
        tenant = str(tenant)
        with self._lock:
            st = self._state(tenant)
            if st.planned and not replan:
                return st
            if replan:
                eps_slo, delta_slo = self.registry.contract(tenant)
                st.eps_slo, st.delta_slo = eps_slo, delta_slo
                st.delta_served = delta_slo
            st.planned = True
            seq = st.seq
            st.seq += 1
        registered = self.registry.current_route(tenant)
        candidates = [
            {"route": r, "accuracy": -ROUTE_EPS[r],
             "q_runtime": ROUTE_COST[r]}
            for r in (None, "bf16", "int8")]
        front = pareto(candidates)
        route = registered
        picked = False
        if st.eps_slo is not None:
            fits = [candidates[i] for i in front
                    if -candidates[i]["accuracy"] <= st.eps_slo]
            if fits:
                route = min(fits, key=lambda p: p["q_runtime"])["route"]
                picked = True
        if picked and route != registered:
            self.registry.set_route_override(tenant, route)
        decision = {
            "route": route or "exact",
            "delta_served": st.delta_served,
            "eps_served": st.eps_slo,
            "cost": theoretical_cost(st.delta_served, route),
        }
        p50_t, p99_t = self.registry.declared_targets(tenant)
        record_control(
            tenant, "plan", seq,
            {"slo_eps": st.eps_slo, "slo_delta": st.delta_slo,
             "declared_p50_ms": p50_t, "declared_p99_ms": p99_t,
             "candidates": len(candidates), "frontier": len(front),
             "registered_route": registered or "exact"},
            decision, site=self.site, level=st.level)
        return st

    # -- evaluate (the cadence tick) ---------------------------------------

    def evaluate(self, dispatcher, now=None, final=False):
        """One controller pass over every tenant the dispatcher's
        ledger has observed: read the multi-window burn telemetry,
        decide (degrade / relax / tighten / recover / hold), apply, and
        land one ``control`` record per tenant. Returns the list of
        (tenant, action) pairs. ``final=True`` marks the close-time
        pass (recorded in the records' attrs — post-run forensics can
        tell a cadence tick from the close)."""
        led = dispatcher.budget_ledger()
        if led is None:
            return []
        if now is None:
            now = time.perf_counter()
        actions = []
        for tenant in led.tenants():
            st = self.plan(tenant)  # lazy: late registrations get one
            stats = {w: led.window_stats(tenant, w, now)
                     for w in led.windows}
            long_stats = stats[max(stats)]
            slo_rates = [s["slo_burn_rate"] for s in stats.values()
                         if s["slo_burn_rate"] is not None]
            stat_rates = [s["stat_burn_rate"] for s in stats.values()
                          if s["stat_burn_rate"] is not None]
            worst_slo = max(slo_rates) if slo_rates else None
            worst_stat = max(stat_rates) if stat_rates else None
            rates = [r for r in (worst_slo, worst_stat) if r is not None]
            worst = max(rates) if rates else None
            cp = long_stats["cp_lower_bound"]
            inputs = {
                "burn_rate": worst, "slo_burn_rate": worst_slo,
                "stat_burn_rate": worst_stat, "cp_lower_bound": cp,
                "requests": long_stats["requests"],
                "draws": long_stats["draws"],
                "p99_ms": long_stats["p99_ms"],
                "window_s": long_stats["window_s"],
            }
            realized = None
            if st.predicted is not None:
                # the previous decision's realized effect, measured one
                # full evaluation later — the record that closes the loop
                realized = {"burn_rate": worst,
                            "p99_ms": long_stats["p99_ms"]}
            action, predicted = self._decide(st, dispatcher, led, tenant,
                                             long_stats, worst_slo,
                                             worst_stat, worst, cp, now)
            route = self.registry.current_route(tenant)
            eff_p50, eff_p99 = (st.targets if st.targets is not None
                                else self.registry.declared_targets(tenant))
            decision = {
                "route": "host" if st.host else (route or "exact"),
                "min_rows": st.min_rows,
                "delta_served": st.delta_served,
                "eps_served": st.eps_slo,
                "p50_ms": eff_p50, "p99_ms": eff_p99,
                "cost": theoretical_cost(st.delta_served, route),
            }
            with self._lock:
                seq = st.seq
                st.seq += 1
                st.predicted = predicted
            record_control(tenant, action, seq, inputs, decision,
                           site=self.site, level=st.level,
                           predicted=predicted, realized=realized,
                           **({"final": True} if final else {}))
            actions.append((tenant, action))
        return actions

    def _decide(self, st, dispatcher, led, tenant, long_stats, worst_slo,
                worst_stat, worst, cp, now):
        """Pick and APPLY one action for one tenant. Priority: a
        latency burn near the alert threshold degrades (admission
        control is the emergency path); statistical over-burn tightens
        a relaxed δ; a persistent underspend recovers the ladder first
        (restore service quality before banking), then relaxes δ."""
        with self._lock:
            if worst_slo is not None and worst_slo >= self.burn:
                st.streak = 0
                return self._degrade_locked(st, dispatcher, led, tenant,
                                            long_stats, now)
            if (worst_stat is not None and worst_stat > 1.0
                    and st.delta_slo is not None
                    and st.delta_served is not None
                    and st.delta_served > st.delta_slo):
                # the draw stream is statistically inconsistent with
                # the relaxed contract: walk δ back toward the
                # declaration before the audit flags it
                st.streak = 0
                st.delta_served = max(st.delta_slo, st.delta_served / 2.0)
                return "tighten", {
                    "cost": theoretical_cost(
                        st.delta_served, self.registry.current_route(tenant))}
            if worst is None or worst > self.relax:
                st.streak = 0
                return "hold", None
            st.streak += 1
            if st.streak < self.patience:
                return "hold", None
            if st.steps:
                st.streak = 0
                return self._recover_locked(st, tenant)
            if (st.delta_slo is not None and st.delta_served is not None
                    and st.delta_served < self.cap * st.delta_slo
                    and (cp is None or cp < st.delta_slo)):
                st.streak = 0
                st.delta_served = min(self.cap * st.delta_slo,
                                      st.delta_served * 2.0)
                return "relax", {
                    "cost": theoretical_cost(
                        st.delta_served, self.registry.current_route(tenant))}
            return "hold", None

    def _degrade_locked(self, st, dispatcher, led, tenant, long_stats,
                        now):
        """One rung down the cheapest-first ladder + target
        renegotiation (lock held). The renegotiated targets re-base the
        ledger's burn retroactively — ``window_stats`` re-judges every
        window sample against the CURRENT targets — so the multi-window
        alert deterministically cannot trip on the old, unachievable
        declaration."""
        applied = None
        route = self.registry.current_route(tenant)
        if ("quantize" not in st.steps and st.eps_slo is not None
                and route != "int8"):
            nxt = "bf16" if route is None else "int8"
            if ROUTE_EPS[nxt] <= st.eps_slo:
                st.steps.append("quantize")
                applied = "quantize"
                self.registry.set_route_override(tenant, nxt)
        if applied is None and "widen" not in st.steps:
            st.steps.append("widen")
            applied = "widen"
            # fuller launches: raise the tenant's bucket floor to a
            # quarter of the batch cap (dispatcher geometry — the
            # controller is package-internal and reads it directly)
            st.min_rows = max(dispatcher._min_bucket * 4,
                              min(dispatcher._max_batch_rows, 64))
            st.min_rows = min(st.min_rows, dispatcher._max_batch_rows)
        if applied is None and "host" not in st.steps:
            st.steps.append("host")
            applied = "host"
            st.host = True
        # renegotiate the declared percentiles to achievable values:
        # measured window percentile × margin, declared-vs-renegotiated
        # landing in the record via the decision's p50/p99 fields
        p50_t, p99_t = (st.targets if st.targets is not None
                        else self.registry.declared_targets(tenant))
        new_p50 = (round(long_stats["p50_ms"] * self.margin, 4)
                   if p50_t is not None and long_stats["p50_ms"] is not None
                   else p50_t)
        new_p99 = (round(long_stats["p99_ms"] * self.margin, 4)
                   if p99_t is not None and long_stats["p99_ms"] is not None
                   else p99_t)
        st.targets = (new_p50, new_p99)
        led.note_requests(tenant, (), p50_ms=new_p50, p99_ms=new_p99,
                          ts=now)
        predicted = {"burn_rate": 1.0 / self.margin}
        if new_p99 is not None:
            predicted["p99_ms"] = new_p99
        return "degrade", predicted

    def _recover_locked(self, st, tenant):
        """Undo the most recent ladder rung (lock held); renegotiated
        targets stay until the tenant is fully recovered — recovering
        the route before the targets would re-trip the very burn that
        degraded it."""
        undone = st.steps.pop()
        if undone == "quantize":
            self.registry.set_route_override(tenant, None)
        elif undone == "widen":
            st.min_rows = None
        elif undone == "host":
            st.host = False
        if not st.steps:
            st.targets = None
            st.min_rows = None
        return "recover", {"burn_rate": self.relax}
