"""Read side of the serving control plane: collect / render / CLI over
``control`` records (counterpart of ``sq_learn_tpu/obs/control.py``).

The live half, the SLO-driven (ε, δ) autotuner that writes these
records, is :mod:`sq_learn_tpu_torch.serving.control`. This module is
its read side and, like :mod:`.budget`, imports the standard library
only.

One ``control`` record is one controller evaluation of one tenant: the
telemetry it consumed (``inputs``), the decision it took (``decision``:
route, coalescing floor, renegotiated targets, served (ε, δ)), the
decision's ``predicted`` effect, and the ``realized`` effect of the
previous decision. Actions: ``plan``, ``hold``, ``relax`` / ``tighten``,
``degrade`` / ``recover``.

CLI: ``python -m sq_learn_tpu_torch.obs control <jsonl> [more.jsonl ...]
[--json]`` — exits 0 when control records exist, 2 when the artifacts
carry none.
"""

__all__ = ["collect", "render", "main"]


def collect(records):
    """Aggregate decoded records into the control view:
    ``{"tenants": {tenant: [records, eval-ordered]}, "actions":
    {action: count}}`` — per-tenant decision histories ordered by
    ``(ts, seq)`` so the ladder walk reads top to bottom."""
    tenants = {}
    actions = {}
    for r in records:
        if not isinstance(r, dict) or r.get("type") != "control":
            continue
        tenants.setdefault(str(r.get("tenant")), []).append(r)
        a = r.get("action")
        actions[a] = actions.get(a, 0) + 1
    for recs in tenants.values():
        recs.sort(key=lambda r: (r.get("ts", 0.0),
                                 r.get("seq") if isinstance(r.get("seq"),
                                                            int) else -1))
    return {"tenants": tenants, "actions": actions}


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float) and (abs(v) >= 1e5 or 0 < abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def _kv(obj, keys):
    parts = []
    for k in keys:
        if obj.get(k) is not None:
            parts.append(f"{k}={_fmt(obj[k])}")
    return " ".join(parts)


def render(view, last=8):
    """Format a :func:`collect` view as the report's controller-decisions
    section: the action tally, then each tenant's most recent ``last``
    decisions with the inputs they consumed and the predicted vs
    realized effect."""
    lines = []
    out = lines.append
    tenants = view.get("tenants") or {}
    if not tenants:
        return "  (no control records)"
    tally = ", ".join(f"{a}={n}" for a, n in
                      sorted((view.get("actions") or {}).items()))
    out(f"  actions: {tally}")
    for tenant in sorted(tenants, key=str):
        recs = tenants[tenant]
        shown = recs[-last:]
        skipped = len(recs) - len(shown)
        head = f"  {tenant}: {len(recs)} evaluation(s)"
        if skipped:
            head += f" (showing last {len(shown)})"
        out(head)
        for r in shown:
            inputs = r.get("inputs") or {}
            decision = r.get("decision") or {}
            inp = _kv(inputs, ("burn_rate", "slo_burn_rate",
                               "stat_burn_rate", "cp_lower_bound",
                               "requests"))
            dec = _kv(decision, ("route", "min_rows", "delta_served",
                                 "eps_served", "p99_ms", "cost"))
            line = (f"    #{_fmt(r.get('seq'))} {r.get('action')}"
                    f"@L{r.get('level', 0)}")
            if inp:
                line += f"  in[{inp}]"
            if dec:
                line += f"  out[{dec}]"
            out(line)
            pred, real = r.get("predicted"), r.get("realized")
            if pred or real:
                pr = _kv(pred or {}, sorted(pred or {}))
                rl = (_kv(real, sorted(real)) if isinstance(real, dict)
                      else "-")
                out(f"      predicted[{pr}]  realized[{rl}]")
    return "\n".join(lines)


def main(argv):
    """``control <jsonl> [more.jsonl ...] [--json]`` — render the
    controller-decision history of one or more obs JSONL artifacts;
    exits 0 when control records exist, 2 when there are none (empty
    telemetry is distinguishable from a quiet controller: a quiet
    controller still lands ``plan``/``hold`` records)."""
    import json
    import sys

    as_json = "--json" in argv
    paths = [a for a in argv if a != "--json"]
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs control <jsonl> "
              "[more.jsonl ...] [--json]", file=sys.stderr)
        return 2
    from ._files import load_jsonl

    records = []
    for p in paths:
        records.extend(load_jsonl(p))
    view = collect(records)
    if not view["tenants"]:
        if as_json:
            print(json.dumps(dict(view, error="no control telemetry")))
        print(f"no control telemetry: zero control records in "
              f"{', '.join(paths)}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(view))
    else:
        print("== controller decisions (SLO-driven (eps, delta) "
              "autotuner) ==")
        print(render(view))
    return 0
