"""Guarantee auditor: do the simulated routines honor their (ε, δ)
contracts? (counterpart of ``sq_learn_tpu/obs/guarantees.py``).

The paper's routines are randomized approximators sold with two-sided
contracts: "the realized error is at most ``tol`` with probability at
least ``1 − fail_prob``" (tomography's δ, amplitude and phase
estimation's (ε, γ), IPE's rescaled ε, consistent PE's ε-grid snap). The
simulations know the value they perturb, so each audited call has a
ground truth:

- **Per-draw records.** An audited routine emits one ``guarantee`` record
  per draw: the declared budgets, the realized error and whether the
  draw violated its tolerance. Large batches are evenly subsampled to
  ``_MAX_DRAWS_PER_CALL`` draws; a batch of tensors is subsampled on its
  device and only those draws are copied to the host, in one copy.
- **Where the JAX package audits.** It audits eager calls only: a
  routine called inside a ``jit`` trace (every fit loop) has no concrete
  truth and records nothing. The port has no traces, so the regions the
  JAX package runs under ``jit`` are marked :func:`no_audit`, and a site
  records in the port exactly where it records on the JAX package's
  accelerator route.
- **Clopper–Pearson aggregation.** A violated draw is expected now and
  then; :func:`audit` flags a site only when the exact binomial lower
  confidence bound on its failure rate exceeds the declared failure
  probability.
- **Strict escalation.** ``SQ_OBS_AUDIT_STRICT=1`` re-audits a site on
  every violated draw and raises :class:`GuaranteeViolationError` once
  the bound crosses the declared failure probability.
- **Zero-budget short-circuits.** δ=0/ε=0 routes are the exact classical
  computation; their records carry ``short_circuit: true`` with
  ``realized = 0`` and ``violated = false`` by construction.

The audit half is standard-library code, copied from the JAX package so
that both compute the same bounds.
"""

import contextlib
import math
import threading

from .. import _knobs
from . import recorder

__all__ = [
    "GuaranteeViolationError",
    "audit",
    "clopper_pearson_lower",
    "enabled",
    "main",
    "no_audit",
    "observe",
    "record_guarantee",
    "render",
    "strict",
]

#: per-call cap on audited draws: a 70k-row tomography call records an
#: evenly strided 64-draw sample (``n_total`` rides in the record)
_MAX_DRAWS_PER_CALL = 64

#: default confidence level of the Clopper–Pearson lower bound
CONFIDENCE = 0.95

_tls = threading.local()


class GuaranteeViolationError(RuntimeError):
    """A site's empirical failure rate is statistically inconsistent with
    its declared failure probability (raised under
    ``SQ_OBS_AUDIT_STRICT=1``)."""


def enabled():
    """True when a recorder is active and the caller is outside a
    :func:`no_audit` region — the arming condition of every audit site."""
    return recorder._active is not None and not getattr(_tls, "depth", 0)


@contextlib.contextmanager
def no_audit():
    """Mark a region the JAX package runs under ``jit`` (a fit loop, a
    fused binary search, a blocked ``lax.map``): the quantum routines
    called inside it record no guarantee draws, as traced calls record
    none there."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def strict():
    """True when flagged sites must raise (``SQ_OBS_AUDIT_STRICT=1``)."""
    return _knobs.get_bool("SQ_OBS_AUDIT_STRICT")


# ---------------------------------------------------------------------------
# Clopper–Pearson (exact binomial) lower confidence bound — dependency-free
# ---------------------------------------------------------------------------


def _log_binom_tail_geq(n, k, p):
    """log P(X ≥ k) for X ~ Binomial(n, p), exact via lgamma logs, summed
    in probability space over the upper-tail terms."""
    if p <= 0.0:
        return -math.inf if k > 0 else 0.0
    if p >= 1.0:
        return 0.0
    lp, lq = math.log(p), math.log1p(-p)
    lgn = math.lgamma(n + 1)
    total = 0.0
    for i in range(k, n + 1):
        lt = (lgn - math.lgamma(i + 1) - math.lgamma(n - i + 1)
              + i * lp + (n - i) * lq)
        total += math.exp(lt)
    return math.log(total) if total > 0 else -math.inf


def clopper_pearson_lower(violations, trials, confidence=CONFIDENCE):
    """Exact (Clopper–Pearson) lower confidence bound on a binomial
    proportion: the largest p such that observing ≥ ``violations`` out of
    ``trials`` draws still has probability ≥ 1 − confidence under p.

    ``violations == 0`` returns 0.0; ``violations == trials`` still
    returns < 1. Solved by bisection on the exact binomial upper tail.
    """
    k, n = int(violations), int(trials)
    if n <= 0 or k <= 0:
        return 0.0
    if k > n:
        raise ValueError(f"violations {k} > trials {n}")
    alpha = 1.0 - float(confidence)
    log_alpha = math.log(alpha)
    lo, hi = 0.0, 1.0
    # P(X ≥ k | p) is increasing in p; the bound is the p where the tail
    # probability equals α. 60 bisection steps ≈ 1 ulp of float64.
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _log_binom_tail_geq(n, k, mid) < log_alpha:
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Per-draw records (the instrumentation surface)
# ---------------------------------------------------------------------------


def record_guarantee(site, realized, tol, *, fail_prob=None, violated=None,
                     short_circuit=False, n_total=None, **attrs):
    """Append one ``guarantee`` record (and its JSONL line) to the active
    run. No-op when observability is disabled.

    ``realized``/``tol`` are in the routine's own error units;
    ``fail_prob`` is the contract's declared failure probability (None
    when the routine declares none: measured, never flagged).
    ``violated`` defaults to ``realized > tol``; short-circuits record
    0/0/False by construction.
    """
    rec = recorder.get_recorder()
    if rec is None:
        return
    realized = float(realized)
    tol = float(tol)
    if violated is None:
        violated = bool(realized > tol) and not short_circuit
    entry = {"type": "guarantee", "site": str(site),
             "realized": round(realized, 9), "tol": round(tol, 9),
             "violated": bool(violated),
             "fail_prob": (None if fail_prob is None
                           else round(float(fail_prob), 9))}
    if short_circuit:
        entry["short_circuit"] = True
    if n_total is not None:
        entry["n_total"] = int(n_total)
    if attrs:
        entry["attrs"] = recorder._jsonable(attrs)
    rec.record(entry, kind="guarantee_records")
    if entry["violated"] and strict():
        _enforce(rec, site)


def _enforce(rec, site):
    """Strict-mode escalation: re-audit ``site`` over the run so far and
    raise when the Clopper–Pearson lower bound on its failure rate
    exceeds its declared failure probability."""
    summary = audit(rec.guarantee_records).get(site)
    if summary and summary["flagged"]:
        raise GuaranteeViolationError(
            f"guarantee audit: site {site!r} violates its declared "
            f"contract — {summary['violations']}/{summary['trials']} draws "
            f"over tolerance, failure-rate lower bound "
            f"{summary['lower_bound']:.4f} > declared fail_prob "
            f"{summary['fail_prob']:.4f} (SQ_OBS_AUDIT_STRICT=1)")


def _subsample(n):
    """Evenly strided index sample of ``range(n)`` capped at
    ``_MAX_DRAWS_PER_CALL`` — deterministic, endpoints included."""
    if n <= _MAX_DRAWS_PER_CALL:
        return list(range(n))
    step = (n - 1) / (_MAX_DRAWS_PER_CALL - 1)
    return sorted({min(n - 1, round(i * step))
                   for i in range(_MAX_DRAWS_PER_CALL)})


def _subsample_on(n, device):
    """:func:`_subsample` as an index tensor made on ``device`` (no
    host→device copy): past the cap the stride exceeds 1, so the rounded
    points are distinct, and float64 ``torch.round`` rounds half to even
    as Python's ``round`` does."""
    import torch

    if n <= _MAX_DRAWS_PER_CALL:
        return torch.arange(n, device=device)
    step = (n - 1) / (_MAX_DRAWS_PER_CALL - 1)
    points = torch.arange(_MAX_DRAWS_PER_CALL, dtype=torch.float64,
                          device=device) * step
    return torch.clamp(torch.round(points).to(torch.int64), max=n - 1)


def _sampled_draws(realized_errors, tol):
    """(errors, per-draw tolerances or the scalar tol, n, sampled indices).
    Tensors are subsampled on their device and the sampled draws come to
    the host in one copy; everything else is read as a flat sequence."""
    import torch

    if isinstance(realized_errors, torch.Tensor):
        errs = realized_errors.reshape(-1)
        n = errs.numel()
        sel = _subsample_on(n, errs.device)
        idx = range(sel.numel())
        errs = errs.to(torch.float64).index_select(0, sel)
        if isinstance(tol, torch.Tensor):
            tols = torch.broadcast_to(
                tol.to(errs.device), realized_errors.shape).reshape(-1)
            host = torch.stack([errs, tols.to(torch.float64).index_select(
                0, sel)]).cpu().tolist()
            return host[0], host[1], n, idx
        return errs.cpu().tolist(), tol, n, idx
    errs = [float(e) for e in realized_errors]
    n = len(errs)
    return errs, tol, n, _subsample(n)


def observe(site, realized_errors, tol, *, fail_prob=None, **attrs):
    """Record a batch of realized errors against one declared tolerance.

    ``realized_errors`` is a flat sequence or a tensor (one entry per
    independent draw of the routine); batches beyond
    :data:`_MAX_DRAWS_PER_CALL` are evenly subsampled and the records
    carry ``n_total``. ``tol`` is a scalar or one per draw. No-op when
    observability is disabled.
    """
    if not enabled():
        return
    errs, tol, n, idx = _sampled_draws(realized_errors, tol)
    if n == 0:
        return
    m = len(errs)
    try:
        tols = [float(t) for t in tol]
        if len(tols) != m:
            raise ValueError(
                f"per-draw tol length {len(tols)} != draws {m}")
    except TypeError:
        tols = [float(tol)] * m
    for i in idx:
        record_guarantee(site, errs[i], tols[i], fail_prob=fail_prob,
                         n_total=(n if n > len(idx) else None), **attrs)


# ---------------------------------------------------------------------------
# Aggregation (the auditor proper)
# ---------------------------------------------------------------------------


def audit(records=None, confidence=CONFIDENCE):
    """Aggregate guarantee records per site with Clopper–Pearson bounds.

    ``records`` defaults to the active run's ``guarantee_records``; any
    iterable of decoded record dicts works (the CLI passes JSONL lines).
    Returns ``{site: {trials, violations, rate, lower_bound, fail_prob,
    flagged, short_circuits, confidence}}`` where ``fail_prob`` is the
    LARGEST failure probability the site declared and ``flagged`` means
    ``lower_bound > fail_prob``. Sites that never declared a failure
    probability are measured but never flagged.
    """
    if records is None:
        rec = recorder.get_recorder()
        records = rec.guarantee_records if rec is not None else []
    sites = {}
    for r in records:
        if not isinstance(r, dict) or r.get("type") != "guarantee":
            continue
        s = sites.setdefault(r.get("site"),
                             {"trials": 0, "violations": 0,
                              "short_circuits": 0, "fail_prob": None})
        s["trials"] += 1
        if r.get("violated"):
            s["violations"] += 1
        if r.get("short_circuit"):
            s["short_circuits"] += 1
        fp = r.get("fail_prob")
        if isinstance(fp, (int, float)) and not isinstance(fp, bool):
            if s["fail_prob"] is None or fp > s["fail_prob"]:
                s["fail_prob"] = float(fp)
    for s in sites.values():
        s["rate"] = s["violations"] / s["trials"] if s["trials"] else 0.0
        s["lower_bound"] = clopper_pearson_lower(
            s["violations"], s["trials"], confidence)
        s["confidence"] = confidence
        s["flagged"] = (s["fail_prob"] is not None
                        and s["lower_bound"] > s["fail_prob"])
    return sites


def render(summary):
    """Format an :func:`audit` summary as the audit table."""
    lines = []
    if not summary:
        return "  (no guarantee records)"
    for site in sorted(summary):
        a = summary[site]
        fp = ("-" if a["fail_prob"] is None
              else f"{a['fail_prob']:.4g}")
        flag = "  FLAGGED" if a["flagged"] else ""
        sc = (f" short_circuit={a['short_circuits']}"
              if a["short_circuits"] else "")
        lines.append(
            f"  {a['violations']:4d}/{a['trials']:<5d} over tol  "
            f"lcb={a['lower_bound']:.4f} vs declared {fp:>7}  "
            f"{site}{sc}{flag}")
    return "\n".join(lines)


def main(argv):
    """``audit <jsonl> [more.jsonl ...] [--json] [--confidence C]`` —
    audit the guarantee records of one or more obs JSONL artifacts; exits
    1 when any site is flagged."""
    import json as _json
    import sys

    from ._files import load_jsonl

    as_json = "--json" in argv
    confidence = CONFIDENCE
    paths = []
    it = iter(a for a in argv if a != "--json")
    for a in it:
        if a == "--confidence":
            confidence = float(next(it, CONFIDENCE))
        else:
            paths.append(a)
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs audit <jsonl> "
              "[more.jsonl ...] [--json] [--confidence C]",
              file=sys.stderr)
        return 2
    records = []
    for p in paths:
        records.extend(load_jsonl(p))
    summary = audit(records, confidence)
    flagged = sorted(s for s, a in summary.items() if a["flagged"])
    if as_json:
        print(_json.dumps({"audit": summary, "flagged": flagged}))
    else:
        print("== guarantee audit ==")
        print(render(summary))
        print(f"flagged: {flagged if flagged else 'none'}")
    return 1 if flagged else 0
