"""Control-plane smoke: the SLO-driven (ε, δ) autotuner and admission
control end to end, on the card, in seconds (counterpart of
``sq_learn_tpu/serving/control_smoke.py``).

``make control-smoke-torch`` runs ``python -m sq_learn_tpu_torch.serving.
control_smoke --device cuda``:

1. fit one tiny q-means tenant model, checkpoint it, and register three
   tenants off the same checkpoint with different declared headroom:

   - ``greedy``: accuracy headroom (``slo_eps``), δ headroom
     (``slo_delta``) and an impossible p99 target: the register-time
     **plan** must pick the cheapest frontier route (int8) and price the
     contract;
   - ``steady``: the same impossible p99 but NO declared headroom:
     admission control may widen or host-route it (both bit-identical)
     but must NEVER move it to a lossy route;
   - ``banker``: a generous p99 and ``slo_delta``: persistently
     underspent, its served δ must be **relaxed** toward the cap
     (theoretical runtime banked, ``cost_served < cost_declared``);

2. a deterministic load with the autotuner on (cadence 1, patience 1)
   under ``SQ_OBS_BUDGET_STRICT=1`` the whole way: the burning tenants
   force a **degrade** (cheapest first: the widen rung before any host
   rung) whose renegotiated targets re-base the ledger's burn, so the
   multi-window alert cannot trip: the strict close must NOT raise and
   ZERO ``alert`` records may land;
3. a **full-ladder leg** on a second registry: an aggressive
   renegotiation margin keeps the tenant burning after the widen rung, so
   the next tick must take the host rung: ladder order widen → host,
   responses still row-equal to the estimator, zero requests lost;
4. asserts: zero lost requests; every response row-matches the
   estimator's own surface; ≥ 1 closed-loop record (a post-degrade
   ``realized`` burn measured under the alert threshold); the relax
   banked cost for ``banker``; the emitted JSONL validates with ≥ 1
   ``control`` and ≥ 1 ``budget`` record; and the read side
   (:mod:`sq_learn_tpu_torch.obs.control`) collects and renders the
   decision history.

``--device {cuda,cpu}``: the default is the configured device, the card;
without CUDA the smoke exits 2 before writing anything. Unlike the JAX
smoke it pins no backend in-process. Departure: the host rung is the
same kernel on the same card behind a plain unsupervised copy (the port
runs nothing on the CPU in a card's place, ``ROADMAP.md``'s ground
rules), where the JAX package serves it on the host. The summary line
adds ``launches`` and ``device``.

Exit code 0 = contract holds; 1 = violation (printed as JSON); 2 = no
such device.
"""

import json
import os
import shutil
import sys
import tempfile

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.serving.control_smoke"


def tenant_rows(rng=None):
    """The tenant's 400 × 8 training rows, 3 blobs 6 apart: the smoke's
    first draw from ``rng`` (default: a fresh ``default_rng(0)``, the
    smoke's own)."""
    import numpy as np

    rng = np.random.default_rng(0) if rng is None else rng
    return (rng.normal(size=(400, 8))
            + 6.0 * rng.integers(0, 3, size=(400, 1))).astype(np.float32)


def main(device):
    import numpy as np

    from ..models import QKMeans
    from ..obs import control as obs_control
    from ..obs import disable, enable, get_recorder
    from ..obs._files import load_jsonl
    from ..obs.budget import DEFAULT_BURN_THRESHOLD, BudgetBurnError
    from ..obs.schema import validate_jsonl
    from ..utils.checkpoint import save_estimator
    from . import MicroBatchDispatcher, ModelRegistry
    from .control import theoretical_cost

    path = _smoke.artifact_path("control")
    open(path, "w").close()
    enable(path)
    strict = _knobs.set_env(SQ_OBS_BUDGET_STRICT=1)

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    rng = np.random.default_rng(0)
    X = tenant_rows(rng)
    m = X.shape[1]
    qkm = QKMeans(n_clusters=3, random_state=0, device=device).fit(X)
    tmp = tempfile.mkdtemp(prefix="sq_control_smoke_")
    ckpt = save_estimator(qkm, os.path.join(tmp, "tenant"))

    reg = ModelRegistry(device=device)
    # the controller is created BEFORE the registrations (per-call
    # overrides, never env mutation) so each register lands its plan
    ctl = reg.controller(patience=1)
    check(ctl is not None, "registry refused a controller under obs")
    reg.register("greedy", ckpt, quantize=None, slo_p99_ms=1e-6,
                 slo_eps=0.01, slo_delta=1e-3)
    reg.register("steady", ckpt, quantize=None, slo_p99_ms=1e-6)
    reg.register("banker", ckpt, quantize=None, slo_p99_ms=1e4,
                 slo_delta=1e-3)

    rec = get_recorder()
    plans = {r["tenant"]: r for r in rec.control_records
             if r["action"] == "plan"}
    check(set(plans) >= {"greedy", "steady", "banker"},
          f"register did not land a plan per tenant: {sorted(plans)}")
    check(plans.get("greedy", {}).get("decision", {}).get("route")
          == "int8",
          "plan did not pick the cheapest frontier route for the "
          f"eps-headroom tenant: {plans.get('greedy')}")
    check(plans.get("steady", {}).get("decision", {}).get("route")
          == "exact",
          "plan re-routed a tenant that declared no accuracy headroom")
    check(reg.current_route("greedy") == "int8",
          "the plan's route override did not take effect")

    # -- leg 1: forced burn under the STRICT budget gate --------------------
    sizes = [2, 5, 8, 13]
    d = MicroBatchDispatcher(reg, background=False, autotune=True,
                             autotune_every=1)
    futs, refs = [], []
    for i in range(24):
        rows = rng.normal(size=(sizes[i % len(sizes)], m)) \
            .astype(np.float32)
        rows += 6.0 * rng.integers(0, 3)
        for tenant in ("greedy", "steady", "banker"):
            futs.append(d.submit(tenant, "predict", rows))
            refs.append(qkm.predict(rows))
        d.flush()
    outs = [f.result(timeout=30) for f in futs]
    raised = False
    try:
        d.close()
    except BudgetBurnError:
        raised = True
    check(not raised,
          "the controller let a burn alert trip under "
          "SQ_OBS_BUDGET_STRICT=1: it must renegotiate first")
    check(len(outs) == len(futs) and all(o is not None for o in outs),
          "a request was lost under admission control")
    check(all(np.array_equal(o, r) for o, r in zip(outs, refs)),
          "a response diverged from the estimator's own predict")
    check(not rec.alert_records,
          f"burn alerts fired despite the controller: "
          f"{rec.alert_records[:2]}")

    by_tenant = {}
    for r in rec.control_records:
        by_tenant.setdefault(r["tenant"], []).append(r)
    for tenant in ("greedy", "steady"):
        degrades = [r for r in by_tenant.get(tenant, ())
                    if r["action"] == "degrade"]
        check(degrades, f"{tenant} burned but was never degraded")
        if degrades:
            first = degrades[0]
            check(first["decision"].get("route") != "host",
                  f"{tenant}'s FIRST degrade jumped to the host rung: "
                  f"{first['decision']}")
            check(first["decision"].get("min_rows") is not None,
                  f"{tenant}'s first degrade did not widen coalescing: "
                  f"{first['decision']}")
            check(first["decision"].get("p99_ms", 0) > 1e-6,
                  f"{tenant}'s degrade did not renegotiate the "
                  f"impossible p99: {first['decision']}")
    check(all(r["decision"].get("route") in ("exact", "host")
              for r in by_tenant.get("steady", ())),
          "a tenant without declared eps headroom was moved to a "
          "lossy route")
    closed_loop = [
        r for r in rec.control_records
        if r["tenant"] in ("greedy", "steady")
        # the record AFTER a degrade: still on the ladder, or the recover
        # that steps off it; either way `realized` measures the degrade's
        # effect one full evaluation later
        and (r.get("level", 0) >= 1 or r["action"] == "recover")
        and isinstance(r.get("realized"), dict)
        and r["realized"].get("burn_rate") is not None
        and r["realized"]["burn_rate"] < DEFAULT_BURN_THRESHOLD]
    check(closed_loop,
          "no post-degrade record measured a realized burn under the "
          "alert threshold: the loop never closed")

    relaxes = [r for r in by_tenant.get("banker", ())
               if r["action"] == "relax"]
    check(relaxes, "the underspent delta-headroom tenant was never "
                   "relaxed")
    contracts = ctl.contracts()
    bank = contracts.get("banker", {})
    check(bank.get("delta_served", 0) and bank.get("delta_declared", 0)
          and bank["delta_served"] > bank["delta_declared"],
          f"relax did not move the served delta: {bank}")
    check(bank.get("cost_served", 0) and bank.get("cost_declared", 0)
          and bank["cost_served"] < bank["cost_declared"],
          f"relax banked no theoretical runtime: {bank}")
    check(bank.get("cost_declared")
          == theoretical_cost(bank.get("delta_declared")),
          f"contract pricing disagrees with theoretical_cost: {bank}")

    # -- leg 2: the full ladder, cheapest first -----------------------------
    # an aggressive margin renegotiates targets the tenant STILL burns
    # against, so the ladder must walk widen -> host; before close the
    # margin is restored so the final renegotiation is achievable and the
    # strict gate stays quiet
    reg2 = ModelRegistry(device=device)
    ctl2 = reg2.controller(patience=1, margin=0.25)
    reg2.register("steady2", ckpt, quantize=None, slo_p99_ms=1e-6)
    d2 = MicroBatchDispatcher(reg2, background=False, autotune=True,
                              autotune_every=1)
    futs2, refs2 = [], []
    for i in range(16):
        rows = rng.normal(size=(sizes[i % len(sizes)], m)) \
            .astype(np.float32)
        futs2.append(d2.submit("steady2", "predict", rows))
        refs2.append(qkm.predict(rows))
        d2.flush()
    outs2 = [f.result(timeout=30) for f in futs2]
    ctl2.margin = 4.0
    raised2 = False
    try:
        d2.close()
    except BudgetBurnError:
        raised2 = True
    check(not raised2, "the ladder leg tripped the strict budget gate")
    check(all(np.array_equal(o, r) for o, r in zip(outs2, refs2)),
          "a host-routed response diverged from the estimator")
    rungs = []
    for r in rec.control_records:
        if r["tenant"] == "steady2" and r["action"] == "degrade":
            rung = ("host" if r["decision"].get("route") == "host"
                    else "widen")
            if rung not in rungs:
                rungs.append(rung)
    check(rungs[:2] == ["widen", "host"],
          f"the ladder was not walked cheapest-first: {rungs}")
    check(ctl2.host_route("steady2"),
          "the exhausted ladder did not pin the tenant to the host route")

    _knobs.set_env(**strict)
    disable()
    shutil.rmtree(tmp, ignore_errors=True)

    summary = validate_jsonl(path)
    check(not summary["errors"],
          f"schema errors: {summary['errors'][:5]}")
    check(summary["by_type"].get("control", 0) >= 1,
          f"expected >=1 control record, got {summary['by_type']}")
    check(summary["by_type"].get("budget", 0) >= 1,
          f"expected >=1 budget record, got {summary['by_type']}")
    check(summary["by_type"].get("alert", 0) == 0,
          f"alert records in the artifact: {summary['by_type']}")

    view = obs_control.collect(load_jsonl(path))
    check(set(view["tenants"]) >= {"greedy", "steady", "banker",
                                   "steady2"},
          f"the read side lost tenants: {sorted(view['tenants'])}")
    for action in ("plan", "hold", "degrade", "recover", "relax"):
        check(view["actions"].get(action, 0) >= 1,
              f"no {action} decision in the artifact: {view['actions']}")
    rendered = obs_control.render(view)
    check("predicted[" in rendered and "realized[" in rendered,
          "the rendered decision history lost the predicted/realized "
          "loop")

    print(json.dumps({
        "control_smoke": "fail" if failures else "ok",
        "path": path,
        "device": str(device),
        "requests": len(outs) + len(outs2),
        "actions": view["actions"],
        "banker": contracts.get("banker"),
        "ladder": rungs,
        "jsonl": summary["by_type"],
        "launches": _smoke.launches(),
        "errors": failures,
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(_smoke.cli(PROG, __doc__, main))
