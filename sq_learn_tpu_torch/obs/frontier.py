"""Accuracy-vs-theoretical-runtime frontier (counterpart of
``sq_learn_tpu/obs/frontier.py``).

The thesis of the source framework (reference ``README.rst:26-44``) is
that ε/δ are *runtime* parameters: loosening them buys theoretical
quantum runtime at the price of accuracy. Every sweep point lands as one
``tradeoff`` record (error budget, measured accuracy, theoretical quantum
runtime, classical cost model, measured wall clock), and the CLI renders
the trade-off table with its Pareto frontier::

    python -m sq_learn_tpu_torch.obs frontier <run.jsonl> [more.jsonl ...]

A point is Pareto-optimal when no other point of the same sweep has both
higher accuracy and lower theoretical quantum runtime.

:func:`effective_contracts` is the per-tenant table of the serving plane:
what each tenant's live guarantee draws (the quantized routes' fold
audits, ``serving.quant.*``) say it was actually served, next to what was
declared.
"""

import json

from . import recorder

__all__ = ["record_tradeoff", "collect", "effective_contracts", "pareto",
           "render", "render_effective", "main"]


def record_tradeoff(sweep, point, *, accuracy, accuracy_metric=None,
                    q_runtime=None, c_runtime=None, wall_s=None,
                    budget=None, **attrs):
    """Append one ``tradeoff`` record (and its JSONL line) to the active
    run. No-op when observability is disabled.

    ``point`` is the sweep's dial value (δ, or ε+δ); ``accuracy`` the
    measured downstream quality at that budget; ``q_runtime``/
    ``c_runtime`` the theoretical quantum / classical cost-model outputs
    (None where the model declines, e.g. δ=0); ``wall_s`` the measured
    classical wall clock of the simulated run.
    """
    rec = recorder.get_recorder()
    if rec is None:
        return
    entry = {"type": "tradeoff", "sweep": str(sweep),
             "point": float(point), "accuracy": float(accuracy),
             "q_runtime": (None if q_runtime is None else float(q_runtime)),
             "c_runtime": (None if c_runtime is None else float(c_runtime))}
    if accuracy_metric is not None:
        entry["accuracy_metric"] = str(accuracy_metric)
    if wall_s is not None:
        entry["wall_s"] = round(float(wall_s), 6)
    if budget:
        entry["budget"] = {k: float(v) for k, v in budget.items()}
    if attrs:
        entry["attrs"] = recorder._jsonable(attrs)
    rec.record(entry, kind="tradeoff_records")


def collect(records):
    """The tradeoff records of an iterable of decoded record dicts,
    grouped per sweep: ``{sweep: [record, ...]}`` in input order."""
    sweeps = {}
    for r in records:
        if isinstance(r, dict) and r.get("type") == "tradeoff":
            sweeps.setdefault(r.get("sweep"), []).append(r)
    return sweeps


def pareto(points, acc_key="accuracy", cost_key="q_runtime"):
    """Indices of the Pareto-optimal points: maximal accuracy, minimal
    theoretical runtime. Points without a finite cost are never frontier
    members. Ties on both axes keep the first point."""
    idx = [i for i, p in enumerate(points)
           if isinstance(p.get(cost_key), (int, float))
           and isinstance(p.get(acc_key), (int, float))]
    front = []
    for i in idx:
        pi = points[i]
        dominated = False
        for j in idx:
            if j == i:
                continue
            pj = points[j]
            better_eq = (pj[acc_key] >= pi[acc_key]
                         and pj[cost_key] <= pi[cost_key])
            strictly = (pj[acc_key] > pi[acc_key]
                        or pj[cost_key] < pi[cost_key])
            # ties on both axes: the earlier point wins
            if better_eq and (strictly or j < i):
                dominated = True
                break
        if not dominated:
            front.append(i)
    return front


def effective_contracts(records):
    """The per-tenant "effective (ε, δ)" table: ``guarantee`` records
    grouped by their ``attrs.tenant`` (draws without one are skipped).
    Returns ``{tenant: {sites, draws, violations, delta_declared,
    delta_lower_bound, eps_declared, eps_effective, eps_max}}`` where
    ``delta_declared`` is the largest declared failure probability (the
    loosest contract), ``delta_lower_bound`` the Clopper–Pearson lower
    bound on the realized failure rate, ``eps_declared`` the largest
    declared tolerance, ``eps_effective`` the nearest-rank
    (1 − δ_declared)-quantile of the realized errors and ``eps_max`` the
    worst realized draw (``sq_learn_tpu/obs/frontier.py:107``)."""
    import math

    from .guarantees import clopper_pearson_lower

    tenants = {}
    for r in records:
        if not isinstance(r, dict) or r.get("type") != "guarantee":
            continue
        tenant = (r.get("attrs") or {}).get("tenant")
        if tenant is None:
            continue
        e = tenants.setdefault(str(tenant), {
            "sites": set(), "draws": 0, "violations": 0,
            "delta_declared": None, "eps_declared": None,
            "_realized": []})
        e["sites"].add(r.get("site"))
        e["draws"] += 1
        if r.get("violated"):
            e["violations"] += 1
        fp = r.get("fail_prob")
        if isinstance(fp, (int, float)) and not isinstance(fp, bool):
            if e["delta_declared"] is None or fp > e["delta_declared"]:
                e["delta_declared"] = float(fp)
        tol = r.get("tol")
        if isinstance(tol, (int, float)) and not isinstance(tol, bool):
            if e["eps_declared"] is None or tol > e["eps_declared"]:
                e["eps_declared"] = float(tol)
        rl = r.get("realized")
        if isinstance(rl, (int, float)) and not isinstance(rl, bool):
            e["_realized"].append(float(rl))
    for e in tenants.values():
        e["sites"] = sorted(s for s in e["sites"] if s is not None)
        e["delta_lower_bound"] = clopper_pearson_lower(
            e["violations"], e["draws"]) if e["draws"] else 0.0
        realized = sorted(e.pop("_realized"))
        e["eps_max"] = realized[-1] if realized else None
        if realized:
            q = 1.0 - (e["delta_declared"] or 0.0)
            rank = min(len(realized), max(1, math.ceil(len(realized) * q)))
            e["eps_effective"] = realized[rank - 1]
        else:
            e["eps_effective"] = None
    return tenants


def render_effective(tenants):
    """Format an :func:`effective_contracts` table (one line per tenant:
    declared against empirically served (ε, δ))."""
    lines = []
    if not tenants:
        return "  (no tenant-attributed guarantee draws)"
    for tenant in sorted(tenants):
        e = tenants[tenant]
        lines.append(
            f"  {tenant:<12} {e['violations']:3d}/{e['draws']:<5d} over "
            f"tol  eps_declared={_fmt(e['eps_declared'])} "
            f"eps_effective={_fmt(e['eps_effective'])} "
            f"eps_max={_fmt(e['eps_max'])}  "
            f"delta_declared={_fmt(e['delta_declared'])} "
            f"delta_lcb={_fmt(e['delta_lower_bound'])}  "
            f"sites={','.join(e['sites'])}")
    return "\n".join(lines)


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float) and (abs(v) >= 1e5 or 0 < abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4f}" if isinstance(v, float) else str(v)


def render(sweeps):
    """Format collected tradeoff records as the frontier table: one block
    per sweep, points sorted by budget, Pareto members starred."""
    lines = []
    out = lines.append
    if not sweeps:
        return "  (no tradeoff records)"
    for sweep in sorted(sweeps):
        pts = sorted(sweeps[sweep], key=lambda p: p.get("point", 0.0))
        front = set(pareto(pts))
        out(f"-- sweep {sweep} --")
        out("      point   accuracy     q_runtime     c_runtime    "
            "wall_s  frontier")
        for i, p in enumerate(pts):
            mark = "*" if i in front else " "
            metric = p.get("accuracy_metric")
            out(f"  {mark} {p.get('point', 0.0):7.4g}  "
                f"{_fmt(p.get('accuracy')):>9}  "
                f"{_fmt(p.get('q_runtime')):>12}  "
                f"{_fmt(p.get('c_runtime')):>12}  "
                f"{_fmt(p.get('wall_s')):>8}"
                f"{'  [' + metric + ']' if metric else ''}")
        # what accuracy the cheapest and the dearest frontier budgets buy
        fr = [pts[i] for i in sorted(front,
                                     key=lambda i: pts[i]["q_runtime"])]
        if fr:
            lo, hi = fr[0], fr[-1]
            out(f"  frontier: {len(fr)} of {len(pts)} points; "
                f"q_runtime {_fmt(lo['q_runtime'])} buys accuracy "
                f"{_fmt(lo['accuracy'])}, {_fmt(hi['q_runtime'])} buys "
                f"{_fmt(hi['accuracy'])}")
        else:
            out("  frontier: empty (no point carries a finite q_runtime)")
    return "\n".join(lines)


def main(argv):
    """``frontier <jsonl> [more.jsonl ...] [--json]`` — render the
    accuracy-vs-theoretical-runtime table (with its Pareto frontier) of
    one or more obs JSONL artifacts, and the per-tenant effective-(ε, δ)
    table. Exits 2 on no input and 1 when the artifacts carry neither a
    tradeoff record nor a tenant-attributed draw (a frontier view of a
    run that stated no trade-off is a broken expectation), 0
    otherwise."""
    import sys

    from ._files import load_jsonl

    as_json = "--json" in argv
    paths = [a for a in argv if a != "--json"]
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs frontier <jsonl> "
              "[more.jsonl ...] [--json]", file=sys.stderr)
        return 2
    records = []
    for p in paths:
        records.extend(load_jsonl(p))
    sweeps = collect(records)
    effective = effective_contracts(records)
    if as_json:
        doc = {}
        for sweep, pts in sweeps.items():
            pts = sorted(pts, key=lambda p: p.get("point", 0.0))
            doc[sweep] = {"points": pts, "pareto": pareto(pts)}
        print(json.dumps({"sweeps": doc, "effective": effective}))
    else:
        print("== accuracy vs theoretical quantum runtime ==")
        print(render(sweeps))
        print("== effective (eps, delta) per tenant (live draws) ==")
        print(render_effective(effective))
    return 0 if sweeps or effective else 1
