"""Fleet observability: merge per-process obs shards into one timeline
(counterpart of ``sq_learn_tpu/obs/fleet.py``).

The elastic world (:mod:`sq_learn_tpu_torch.parallel.elastic`) runs N
worker processes plus a coordinator outside the world, each with its own
recorder and JSONL sink. Given the shards of ONE run (correlated by the
coordinator-minted ``fleet.run_id`` envelope), this module

- estimates **per-host clock offsets** from the ``clock`` records the
  elastic world piggybacks on exchanges it makes anyway (heartbeats,
  generation manifests, progress commits). Each sample pairs a peer's
  send timestamp with the local receive timestamp, so
  ``recv − sent ≥ offset(local − peer)`` with equality at zero delay:
  the MINIMUM over samples is the tightest upper bound, and when both
  directions exist the midpoint ``(min_ab − min_ba) / 2`` cancels the
  symmetric part of the delay (NTP-style, no extra messages). Hosts
  align to the coordinator's clock through a BFS over the pairwise
  sample graph;
- **merges** the shards into one causally ordered timeline: every
  record gains ``_host`` and an aligned ``ts_fleet``, and the merge is
  sorted by it (monotone by construction);
- decomposes each shrink's **critical path** (detect → shrink →
  re-init → resume) from the merged elastic events;
- computes **per-host rollups** (record/span/counter totals); and
- **reconciles** the commit ledger: node 0 emits one ``commit`` event
  per committed window, every host a ``window`` event per folded window
  — the merge must hold each committed window exactly once, with no
  gaps, or the artifact disagrees with the fold ledger.

Standard library only, like :mod:`.schema`: the CLI runs without torch.

CLI: ``python -m sq_learn_tpu_torch.obs fleet <run_dir | shard.jsonl
...> [--json] [-o trace.json] [--merged merged.jsonl]`` — exits 1 when
the commit-ledger reconciliation fails, 2 when there is no shard.
"""

import json
import os

from .trace import load_jsonl, to_chrome_trace

__all__ = ["load_shards", "clock_offsets", "merge", "critical_path",
           "rollups", "reconcile", "summarize", "render",
           "write_merged", "main"]

#: the reference host every offset is stated against (the coordinator
#: lives outside the mesh and survives every generation)
COORD_HOST = "coord"


def _shard_host(path, records):
    """Stable host label for one shard: the fleet envelope wins, the
    ``obs.<host>.jsonl`` filename convention is the fallback."""
    for rec in records:
        fl = rec.get("fleet")
        if isinstance(fl, dict) and isinstance(fl.get("host"), str):
            return fl["host"]
    name = os.path.basename(str(path))
    if name.endswith(".gz"):
        name = name[:-len(".gz")]
    if name.startswith("obs.") and name.endswith(".jsonl"):
        return name[len("obs."):-len(".jsonl")]
    return name


def load_shards(source):
    """Load the per-process shards of one fleet run.

    ``source`` is either a run directory — every ``obs.*.jsonl`` /
    ``obs.*.jsonl.gz`` in it is a shard — or an iterable of shard
    paths. Returns ``[(host_label, records), ...]`` sorted by label
    (coordinator first).
    """
    if isinstance(source, (str, os.PathLike)) and os.path.isdir(source):
        paths = sorted(
            os.path.join(source, n) for n in os.listdir(source)
            if n.startswith("obs.")
            and (n.endswith(".jsonl") or n.endswith(".jsonl.gz")))
    elif isinstance(source, (str, os.PathLike)):
        paths = [source]
    else:
        paths = list(source)
    shards = []
    for p in paths:
        records = load_jsonl(p)
        if records:
            shards.append((_shard_host(p, records), records))
    shards.sort(key=lambda hr: (hr[0] != COORD_HOST, hr[0]))
    return shards


def run_ids(shards):
    """Every distinct fleet run_id present (one for a coherent run)."""
    ids = set()
    for _, records in shards:
        for rec in records:
            fl = rec.get("fleet")
            if isinstance(fl, dict) and isinstance(fl.get("run_id"), str):
                ids.add(fl["run_id"])
    return sorted(ids)


def clock_offsets(shards, reference=None):
    """Per-host clock offsets (seconds, ``host_clock − ref_clock``).

    Built from the shards' ``clock`` records: host H recording
    ``{peer: P, sent_ts, recv_ts}`` bounds ``offset(H − P) ≤
    recv_ts − sent_ts`` (the message can only age in flight), so the
    per-(H, P) minimum is the tightest one-way bound and opposite
    minima average into the midpoint estimate. Offsets propagate from
    ``reference`` (default: the coordinator if present, else the first
    host) by BFS; unreachable hosts get offset 0.0 — an unaligned lane
    beats a dropped one.
    """
    hosts = [h for h, _ in shards]
    if not hosts:
        return {}
    if reference is None:
        reference = COORD_HOST if COORD_HOST in hosts else hosts[0]
    # min over samples of (recv - sent) per directed pair (obs, peer)
    one_way = {}
    for host, records in shards:
        for rec in records:
            if rec.get("type") != "clock":
                continue
            sent, recv = rec.get("sent_ts"), rec.get("recv_ts")
            if not isinstance(sent, (int, float)) \
                    or not isinstance(recv, (int, float)):
                continue
            peer = str(rec.get("peer"))
            key = (host, peer)
            d = recv - sent
            if key not in one_way or d < one_way[key]:
                one_way[key] = d

    def pair_offset(a, b):
        """offset(a − b), or None when no samples link the two."""
        ab = one_way.get((a, b))  # bound on offset(a − b)
        ba = one_way.get((b, a))  # bound on offset(b − a)
        if ab is not None and ba is not None:
            return (ab - ba) / 2.0
        if ab is not None:
            return ab
        if ba is not None:
            return -ba
        return None

    offsets = {reference: 0.0}
    frontier = [reference]
    while frontier:
        nxt = []
        for a in frontier:
            for b in hosts:
                if b in offsets:
                    continue
                rel = pair_offset(b, a)
                if rel is not None:
                    offsets[b] = offsets[a] + rel
                    nxt.append(b)
        frontier = nxt
    for h in hosts:
        offsets.setdefault(h, 0.0)
    return offsets


def merge(shards, offsets=None):
    """One causally-ordered timeline from per-host shards.

    Each record is shallow-copied with ``_host`` (its shard's label)
    and ``ts_fleet`` (its ``ts`` minus the host's clock offset, i.e.
    restated on the reference clock), then the merge is sorted by
    ``(ts_fleet, host, file order)`` — monotone in ``ts_fleet`` by
    construction, deterministic under timestamp collisions.
    """
    if offsets is None:
        offsets = clock_offsets(shards)
    out = []
    for host, records in shards:
        off = offsets.get(host, 0.0)
        for idx, rec in enumerate(records):
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            merged = dict(rec)
            merged["_host"] = host
            merged["ts_fleet"] = round(ts - off, 6)
            out.append((merged["ts_fleet"], host, idx, merged))
    out.sort(key=lambda t: t[:3])
    return [m for _, _, _, m in out]


def critical_path(merged):
    """Per-generation detect → shrink → re-init → resume decomposition.

    For every generation ``g ≥ 1`` reached by a shrink, reads the
    merged (clock-aligned) elastic events:

    - ``detect_s``: the slowest surviving host's lease-layer detection
      latency (its ``host_fail`` record's own measurement);
    - ``shrink_s``: first ``host_fail`` → the coordinator's ``shrink``
      (failure files read, new manifest written);
    - ``reinit_s``: ``shrink`` → last ``world_up`` at g (KV service up,
      collectives re-initialized, leases re-armed);
    - ``resume_s``: ``world_up`` → last ``resume`` at g (checkpoint
      loaded, cursor restated);
    - ``finish_s``: ``resume`` → last ``done`` at g.

    Segments whose anchor events are missing are None; present ones are
    clamped at 0 (clock alignment is an estimate).
    """
    ev = {}
    for rec in merged:
        if rec.get("type") != "elastic":
            continue
        g = rec.get("generation")
        if not isinstance(g, int) or isinstance(g, bool):
            continue
        ev.setdefault((rec.get("event"), g), []).append(rec)

    def _ts(event, g, pick):
        recs = ev.get((event, g))
        if not recs:
            return None
        return pick(r["ts_fleet"] for r in recs)

    gens = sorted({g for (e, g) in ev if e == "world_up" and g > 0})
    paths = []
    for g in gens:
        t_fail = _ts("host_fail", g - 1, min)
        t_shrink = _ts("shrink", g, min)
        t_up = _ts("world_up", g, max)
        t_resume = _ts("resume", g, max)
        t_done = _ts("done", g, max)
        detect = [r.get("detect_s") for r in ev.get(("host_fail", g - 1), [])
                  if isinstance(r.get("detect_s"), (int, float))]

        def seg(a, b):
            if a is None or b is None:
                return None
            return round(max(0.0, b - a), 6)

        path = {
            "generation": g,
            "detect_s": round(max(detect), 6) if detect else None,
            "shrink_s": seg(t_fail, t_shrink),
            "reinit_s": seg(t_shrink, t_up),
            "resume_s": seg(t_up, t_resume),
            "finish_s": seg(t_resume, t_done),
            "total_s": seg(t_fail, t_done),
        }
        paths.append(path)
    return paths


def rollups(shards):
    """Per-host record/span/counter totals: ``{host: {records,
    by_type, span_s, spans, counters}}`` where ``counters`` holds each
    counter's final cumulative value."""
    out = {}
    for host, records in shards:
        by_type = {}
        span_s = 0.0
        n_spans = 0
        counters = {}
        for rec in records:
            t = rec.get("type")
            by_type[t] = by_type.get(t, 0) + 1
            if t == "span" and isinstance(rec.get("dur_s"), (int, float)):
                span_s += rec["dur_s"]
                n_spans += 1
            elif t == "counter" and isinstance(rec.get("name"), str) \
                    and isinstance(rec.get("value"), (int, float)):
                counters[rec["name"]] = rec["value"]
        out[host] = {"records": len(records), "by_type": by_type,
                     "spans": n_spans, "span_s": round(span_s, 6),
                     "counters": counters}
    return out


def reconcile(merged):
    """Check the obs commit ledger against itself: every committed
    window ordinal appears EXACTLY once across hosts and generations
    (node 0 of the live generation owns the commit; a voided window is
    recomputed but never re-committed), with no gaps from 0 to the
    last. Returns ``{ok, windows, committed, duplicates, gaps,
    max_cursor}``.
    """
    commits = [r for r in merged if r.get("type") == "elastic"
               and r.get("event") == "commit"]
    seen = {}
    for r in commits:
        w = r.get("window")
        if isinstance(w, int) and not isinstance(w, bool):
            seen[w] = seen.get(w, 0) + 1
    duplicates = sorted(w for w, n in seen.items() if n > 1)
    gaps = []
    if seen:
        gaps = sorted(set(range(max(seen) + 1)) - set(seen))
    cursors = [r.get("cursor") for r in commits
               if isinstance(r.get("cursor"), int)]
    # vacuously ok with zero commits (a non-elastic fleet run has no
    # ledger to disagree with); consumers that EXPECT commits assert on
    # ``windows`` themselves (the smoke's elastic phase, the tests)
    return {"ok": not duplicates and not gaps,
            "windows": len(seen), "committed": len(commits),
            "duplicates": duplicates, "gaps": gaps,
            "max_cursor": max(cursors) if cursors else None}


def summarize(source):
    """The whole fleet view as one dict: hosts, run ids, clock offsets,
    per-host rollups, per-generation critical paths, and the commit
    reconciliation. ``source`` as in :func:`load_shards`."""
    # a list of (host, records) pairs is already-loaded shards; any
    # other list (e.g. shard paths) goes through load_shards
    if isinstance(source, list) and source \
            and all(isinstance(s, tuple) and len(s) == 2 for s in source):
        shards = source
    else:
        shards = load_shards(source)
    offsets = clock_offsets(shards)
    merged = merge(shards, offsets)
    gens = sorted({r["generation"] for r in merged
                   if r.get("type") == "elastic"
                   and isinstance(r.get("generation"), int)})
    return {
        "run_ids": run_ids(shards),
        "hosts": [h for h, _ in shards],
        "records": len(merged),
        "generations": gens,
        "clock_offsets_s": {h: round(o, 6) for h, o in offsets.items()},
        "rollups": rollups(shards),
        "critical_path": critical_path(merged),
        "reconciliation": reconcile(merged),
    }


def render(summary):
    """Human-readable text view of :func:`summarize`'s dict."""
    lines = []
    rid = ", ".join(summary["run_ids"]) or "(no fleet envelope)"
    lines.append(f"fleet run: {rid}")
    lines.append(f"hosts: {', '.join(summary['hosts'])}  "
                 f"records: {summary['records']}  "
                 f"generations: {summary['generations']}")
    lines.append("")
    lines.append("clock offsets vs reference (s):")
    for h, o in sorted(summary["clock_offsets_s"].items()):
        lines.append(f"  {h:<12} {o:+.6f}")
    lines.append("")
    lines.append(f"{'host':<12} {'records':>8} {'spans':>6} "
                 f"{'span_s':>9}  top types")
    for h, r in sorted(summary["rollups"].items()):
        top = sorted(r["by_type"].items(), key=lambda kv: -kv[1])[:4]
        tops = " ".join(f"{t}:{n}" for t, n in top)
        lines.append(f"{h:<12} {r['records']:>8} {r['spans']:>6} "
                     f"{r['span_s']:>9.3f}  {tops}")
    if summary["critical_path"]:
        lines.append("")
        lines.append("shrink critical path (s):")
        lines.append(f"  {'gen':>3} {'detect':>8} {'shrink':>8} "
                     f"{'reinit':>8} {'resume':>8} {'finish':>8} "
                     f"{'total':>8}")
        for p in summary["critical_path"]:
            vals = [p[k] for k in ("detect_s", "shrink_s", "reinit_s",
                                   "resume_s", "finish_s", "total_s")]
            cells = " ".join(f"{v:>8.3f}" if isinstance(v, (int, float))
                             else f"{'—':>8}" for v in vals)
            lines.append(f"  {p['generation']:>3} {cells}")
    rc = summary["reconciliation"]
    lines.append("")
    state = "OK" if rc["ok"] else "BROKEN"
    lines.append(f"commit ledger: {state} — {rc['windows']} windows "
                 f"committed ({rc['committed']} records), "
                 f"duplicates={rc['duplicates']}, gaps={rc['gaps']}, "
                 f"max cursor={rc['max_cursor']}")
    return "\n".join(lines)


def write_merged(shards, out_path, offsets=None):
    """Write the merged, clock-aligned timeline as one JSONL file —
    every line schema-valid (the added ``_host`` / ``ts_fleet`` keys
    ride outside the validated fields). Returns the merged list."""
    merged = merge(shards, offsets)
    with open(out_path, "w") as fh:
        for rec in merged:
            fh.write(json.dumps(rec) + "\n")
    return merged


def main(argv):
    """``fleet <run_dir | shard.jsonl ...> [--json] [-o trace.json]
    [--merged merged.jsonl]``"""
    import sys

    as_json = False
    trace_out = None
    merged_out = None
    paths = []
    it = iter(argv)
    for a in it:
        if a == "--json":
            as_json = True
        elif a in ("-o", "--out"):
            trace_out = next(it, None)
        elif a == "--merged":
            merged_out = next(it, None)
        else:
            paths.append(a)
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs fleet "
              "<run_dir | shard.jsonl ...> [--json] [-o trace.json] "
              "[--merged merged.jsonl]", file=sys.stderr)
        return 2
    source = paths[0] if len(paths) == 1 else paths
    shards = load_shards(source)
    if not shards:
        print(f"no obs shards found in {paths}", file=sys.stderr)
        return 2
    summary = summarize(shards)
    if merged_out:
        write_merged(shards, merged_out,
                     offsets=summary["clock_offsets_s"])
        summary["merged"] = merged_out
    if trace_out:
        trace = to_chrome_trace(shards)
        with open(trace_out, "w") as fh:
            json.dump(trace, fh)
        summary["trace"] = trace_out
    if as_json:
        print(json.dumps(summary))
    else:
        print(render(summary))
    return 0 if summary["reconciliation"]["ok"] else 1
