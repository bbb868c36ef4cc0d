"""Human-readable report over an obs JSONL run artifact (counterpart of
``sq_learn_tpu/obs/report.py``).

``python -m sq_learn_tpu_torch.obs report <jsonl>`` prints the run the way
a person asks about it: where wall clock went (top spans by SELF time: a
parent's time minus its children's), how many bytes moved, what faults
and breaker transitions fired, the theoretical quantum queries of the
ledger, the guarantee audit and the trade-off frontier, and the serving
plane's SLOs, error budgets, effective (ε, δ) and controller decisions.

It reads artifacts of either package: the JAX package's sections that the
port never writes (compiles per site, XLA cost, the persistent compile
cache, the fleet envelope) render from a JAX-written artifact and say
"none" on a port one. Standard library only: it runs in processes that
never load torch.
"""

import json

from . import budget as _budget
from . import control as _control
from . import frontier as _frontier
from . import guarantees as _guarantees
from . import storage as _storage
from ._files import load_jsonl

__all__ = ["summarize", "render", "main"]


def _fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0


def _fmt_num(n):
    if n is None:
        return "-"
    if abs(n) >= 1e15:
        return f"{n:.3e}"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= scale:
            return f"{n / scale:.2f}{suffix}"
    return f"{n:.4g}"


def summarize(records):
    """Aggregate one run's records into the report dict ``render`` prints.

    Span self-time: ``dur - Σ(direct children dur)``, children resolved
    through the recorder's ``parent``-seq links (clamped at 0 — async
    overlap can make children sum past the parent's wall-clock).
    """
    spans = [r for r in records if r.get("type") == "span"]
    child_dur = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            child_dur[p] = child_dur.get(p, 0.0) + float(s.get("dur_s", 0.0))
    by_name = {}
    for s in spans:
        dur = float(s.get("dur_s", 0.0))
        self_s = max(0.0, dur - child_dur.get(s.get("seq"), 0.0))
        agg = by_name.setdefault(
            s.get("name"), {"count": 0, "total_s": 0.0, "self_s": 0.0,
                            "errors": 0})
        agg["count"] += 1
        agg["total_s"] += dur
        agg["self_s"] += self_s
        agg["errors"] += 1 if "error" in s else 0

    watchdog = {}
    for r in records:
        if r.get("type") == "watchdog":
            watchdog[r.get("site")] = r  # last observation wins

    counters = {}
    for r in records:
        if r.get("type") == "counter":
            counters[r.get("name")] = r.get("value")  # cumulative: last wins

    xla = {}
    for r in records:
        if r.get("type") != "xla_cost":
            continue
        site = xla.setdefault(r.get("site"),
                              {"signatures": 0, "flops": None,
                               "bytes_accessed": None, "peak_bytes": None})
        site["signatures"] += 1
        for field in ("flops", "bytes_accessed", "peak_bytes"):
            v = r.get(field)
            if isinstance(v, (int, float)) and (site[field] is None
                                                or v > site[field]):
                site[field] = v

    ledger_queries = {}
    ledger_wall = 0.0
    for r in records:
        if r.get("type") != "ledger":
            continue
        for k, v in (r.get("queries") or {}).items():
            ledger_queries[k] = ledger_queries.get(k, 0.0) + v
        ledger_wall += float(r.get("wall_s", 0.0))

    timeline = [r for r in records
                if r.get("type") in ("fault", "breaker", "regression")]
    timeline.sort(key=lambda r: r.get("ts", 0.0))

    probes = [r for r in records if r.get("type") == "probe"]
    gauges = {r.get("name"): r.get("value")
              for r in records if r.get("type") == "gauge"}
    by_type = {}
    for r in records:
        t = r.get("type")
        by_type[t] = by_type.get(t, 0) + 1

    # spectral-stats engine: digest-cache traffic + sketched-vs-exact
    # estimated FLOPs (engine counters) + measured sketch wall-clock
    # (every span under the sketch.* namespace, total: the kernels run
    # async, so self-time would under-count the overlapped work)
    sketch_wall = sum(agg["total_s"] for name, agg in by_name.items()
                      if name.startswith("sketch."))
    sketch = {
        "cache_hits": counters.get("stats_cache.hits", 0),
        "cache_misses": counters.get("stats_cache.misses", 0),
        "estimates": counters.get("sketch.estimates", 0),
        "sketch_flops": counters.get("sketch.flops"),
        "exact_equiv_flops": counters.get("sketch.exact_equiv_flops"),
        "wall_s": round(sketch_wall, 6),
    }

    slo = [r for r in records if r.get("type") == "slo"]

    # fleet correlation (v10): which run/hosts/generations the artifact's
    # records came from — stamped by the recorder's fleet envelope, plus
    # the elastic window/commit ledger and clock-sample traffic
    fleet_hosts = {}
    fleet_runs = set()
    for r in records:
        env = r.get("fleet")
        if isinstance(env, dict):
            fleet_runs.add(env.get("run_id"))
            h = env.get("host")
            fleet_hosts[h] = fleet_hosts.get(h, 0) + 1
    elastic_recs = [r for r in records if r.get("type") == "elastic"]
    fleet = {
        "run_ids": sorted(str(x) for x in fleet_runs if x is not None),
        "hosts": fleet_hosts,
        "generations": sorted({r.get("generation") for r in elastic_recs
                               if isinstance(r.get("generation"), int)}),
        "commits": sum(1 for r in elastic_recs
                       if r.get("event") == "commit"),
        "windows": sum(1 for r in elastic_recs
                       if r.get("event") == "window"),
        "clock_samples": by_type.get("clock", 0),
    }

    # warmed / quantized serving: signatures warmed before traffic vs
    # dispatch-time hits (100% = no dispatch of an unwarmed signature),
    # the JAX package's persistent compile-cache reloads, the bytes
    # serving moved, and each quantized residency's declared fold
    serving = {
        "aot_compiles": counters.get("serving.aot_compiles", 0),
        "aot_cache_hits": counters.get("serving.aot_cache_hits", 0),
        "aot_cache_misses": counters.get("serving.aot_cache_misses", 0),
        "persistent_cache_hits": counters.get(
            "serving.persistent_cache_hits", 0),
        "persistent_cache_misses": counters.get(
            "serving.persistent_cache_misses", 0),
        "transfer_bytes": counters.get("serving.transfer_bytes", 0),
        "quant_folds": [r.get("value") for r in records
                        if r.get("type") == "gauge"
                        and r.get("name") == "serving.quant_fold"],
    }

    # out-of-core prefetch: readahead hit/stall traffic plus the measured
    # stall seconds — the numbers that say whether shard reads overlapped
    # compute or the consumer sat waiting on the disk/CRC pass
    pf_spans = by_name.get("oocore.prefetch", {})
    prefetch = {
        "hits": counters.get("oocore.prefetch_hits", 0),
        "stalls": counters.get("oocore.prefetch_stalls", 0),
        "stall_s": counters.get("oocore.prefetch_stall_s", 0.0),
        "occupancy": counters.get("oocore.prefetch_occupancy", 0),
        "prefetchers": pf_spans.get("count", 0),
        "async_ckpt_writes": counters.get("oocore.async_ckpt_writes", 0),
        "async_ckpt_dropped": counters.get("oocore.async_ckpt_dropped", 0),
    }

    # compressed tier (v7): stored-vs-decoded bytes through the shard
    # codec, and the serving feature-cache's spill/disk-hit traffic —
    # the numbers behind the bytes-on-disk and survives-restart claims
    codec = {
        "bytes_in": counters.get("oocore.codec_bytes_in", 0),
        "bytes_out": counters.get("oocore.codec_bytes_out", 0),
        "cache_spills": counters.get("serving.cache_spills", 0),
        "cache_disk_hits": counters.get("serving.cache_disk_hits", 0),
    }

    # storage surfaces (v11): one rollup per disk surface, built from
    # counters every schema version has carried — so the section renders
    # on pre-v11 artifacts too. When the run DOES carry v11 ``io``
    # records, the per-shard ledger rollup rides along (full view:
    # python -m sq_learn_tpu_torch.obs storage).
    cache_gets = (counters.get("serving.cache_hits", 0)
                  + counters.get("serving.cache_misses", 0))
    storage = {
        "oocore": {
            "shard_reads": counters.get("oocore.shard_reads", 0),
            "shard_read_bytes": counters.get("oocore.shard_read_bytes", 0),
            "codec_bytes_in": counters.get("oocore.codec_bytes_in", 0),
            "codec_bytes_out": counters.get("oocore.codec_bytes_out", 0),
            "rereads": counters.get("oocore.rereads", 0),
            "crc_failures": counters.get("oocore.crc_failures", 0),
            "prefetch_hits": counters.get("oocore.prefetch_hits", 0),
            "prefetch_stalls": counters.get("oocore.prefetch_stalls", 0),
        },
        "serve_cache": {
            "gets": cache_gets,
            "spills": counters.get("serving.cache_spills", 0),
            "disk_hits": counters.get("serving.cache_disk_hits", 0),
        },
        "compile_cache": {
            "hits": counters.get("serving.persistent_cache_hits", 0),
            "misses": counters.get("serving.persistent_cache_misses", 0),
        },
        "io_records": by_type.get("io", 0),
        "ledger": (_storage.surface_rollup(_storage.collect(records))
                   if by_type.get("io") else {}),
    }

    return {
        "by_type": by_type,
        "spans": by_name,
        "watchdog": watchdog,
        "slo": slo,
        "serving": serving,
        "counters": counters,
        "xla": xla,
        "ledger": {"queries": ledger_queries,
                   "wall_s": round(ledger_wall, 6)},
        "timeline": timeline,
        "probes": probes,
        "gauges": gauges,
        "sketch": sketch,
        "prefetch": prefetch,
        "codec": codec,
        # the storage-surfaces section (v11-aware, counter-backed): one
        # rollup per disk surface; "ledger" is populated only when the
        # artifact carries io records (pre-v11 runs still render)
        "storage": storage,
        # the fleet-correlation section (v10): run_id / per-host record
        # counts from the fleet envelope, the elastic window/commit
        # ledger, and the clock-sample traffic behind the merged
        # timeline (full mesh view: python -m sq_learn_tpu_torch.obs fleet)
        "fleet": fleet,
        # the statistical-observability sections (v3): per-site
        # Clopper–Pearson audit of the (ε, δ) guarantee draws, and the
        # run's accuracy-vs-theoretical-runtime sweep points
        "audit": _guarantees.audit(records),
        "tradeoffs": _frontier.collect(records),
        # the per-tenant error-budget sections (v6): rolling-window
        # burn rates + tripped alerts, and the effective (ε, δ) each
        # tenant's live draws say it was actually served
        "budgets": _budget.collect(records),
        "effective": _frontier.effective_contracts(records),
        # the control-plane section (v8): the autotuner's per-tenant
        # decision history — every route/coalescing/target change with
        # the telemetry that justified it
        "control": _control.collect(records),
    }


def render(summary, top=12):
    """Format the summary as the report text."""
    lines = []
    out = lines.append
    out("== obs run report ==")
    out("records: " + ", ".join(
        f"{t}={n}" for t, n in sorted(summary["by_type"].items(),
                                      key=lambda kv: -kv[1])))

    out("")
    out(f"-- top spans by self-time (top {top}) --")
    ranked = sorted(summary["spans"].items(),
                    key=lambda kv: -kv[1]["self_s"])[:top]
    if not ranked:
        out("  (no spans)")
    for name, agg in ranked:
        err = f"  errors={agg['errors']}" if agg["errors"] else ""
        out(f"  {agg['self_s']:9.4f}s self  {agg['total_s']:9.4f}s total  "
            f"x{agg['count']:<4d} {name}{err}")

    out("")
    out("-- compiles per site (watchdog, last observation) --")
    if not summary["watchdog"]:
        out("  (no watchdog observations)")
    for site, r in sorted(summary["watchdog"].items()):
        flag = "  OVER BUDGET" if r.get("over_budget") else ""
        out(f"  {r.get('compiles', 0):3d} / budget "
            f"{r.get('budget')!s:>4} {site}{flag}")

    out("")
    out("-- xla cost per site (max over signatures) --")
    if not summary["xla"]:
        out("  (no xla_cost records — pre-v2 run or analysis unavailable)")
    for site, agg in sorted(summary["xla"].items()):
        out(f"  {_fmt_num(agg['flops']):>10} flops  "
            f"{_fmt_bytes(agg['bytes_accessed']):>10} accessed  "
            f"{_fmt_bytes(agg['peak_bytes']):>10} peak  "
            f"sigs={agg['signatures']} {site}")

    out("")
    out("-- transfers / counters --")
    if not summary["counters"]:
        out("  (no counters)")
    for name, val in sorted(summary["counters"].items()):
        shown = _fmt_bytes(val) if "bytes" in name else _fmt_num(val)
        out(f"  {shown:>12} {name}")

    out("")
    out("-- quantum ledger vs measured classical cost --")
    lq = summary["ledger"]["queries"]
    if not lq:
        out("  (no ledger entries)")
    for k, v in sorted(lq.items()):
        out(f"  {_fmt_num(v):>10} {k} (theoretical)")
    out(f"  {summary['ledger']['wall_s']:10.4f}s simulated wall-clock")
    mfu = summary["gauges"].get("profiling.mfu")
    if isinstance(mfu, (int, float)):
        out(f"  {mfu:10.6f} measured MFU (profiling.mfu)")

    out("")
    out("-- spectral-stats cache / sketch savings --")
    sk = summary.get("sketch") or {}
    hits, misses = sk.get("cache_hits", 0), sk.get("cache_misses", 0)
    if not (hits or misses or sk.get("estimates")):
        out("  (no spectral-stats activity)")
    else:
        total = hits + misses
        rate = f" ({hits / total:.0%} hit rate)" if total else ""
        out(f"  {hits} hits / {misses} misses stats cache{rate}")
        sf, ef = sk.get("sketch_flops"), sk.get("exact_equiv_flops")
        if sk.get("estimates"):
            saved = (f", {1.0 - sf / ef:.0%} of the exact sweep saved"
                     if sf and ef else "")
            out(f"  {sk['estimates']:.0f} sketched estimate(s): "
                f"{_fmt_num(sf)} flops vs {_fmt_num(ef)} exact-equivalent"
                f"{saved}")
        out(f"  {sk.get('wall_s', 0.0):.4f}s measured in sketch.* spans "
            f"(async kernels: total, not self)")

    out("")
    out("-- guarantee audit (Clopper-Pearson on declared (eps, delta)) --")
    out(_guarantees.render(summary.get("audit", {})))

    out("")
    out("-- accuracy vs theoretical quantum runtime --")
    tr = summary.get("tradeoffs", {})
    if not tr:
        out("  (no tradeoff records)")
    else:
        for line in _frontier.render(tr).splitlines():
            out("  " + line)

    out("")
    out("-- out-of-core prefetch (shard readahead / async checkpoints) --")
    pf = summary.get("prefetch") or {}
    gets = pf.get("hits", 0) + pf.get("stalls", 0)
    if not gets and not pf.get("async_ckpt_writes"):
        out("  (no prefetch activity)")
    else:
        if gets:
            occ = pf.get("occupancy", 0) / gets
            out(f"  {pf.get('hits', 0)} hits / {pf.get('stalls', 0)} "
                f"stalls across {pf.get('prefetchers', 0)} prefetcher(s) "
                f"({pf.get('hits', 0) / gets:.0%} hit rate, avg depth "
                f"occupancy {occ:.2f})")
            out(f"  {pf.get('stall_s', 0.0):.4f}s total consumer stall "
                f"waiting on shard reads")
        if pf.get("async_ckpt_writes"):
            out(f"  {pf.get('async_ckpt_writes', 0)} async checkpoint "
                f"write(s), {pf.get('async_ckpt_dropped', 0)} superseded "
                f"before writing (latest-wins)")

    out("")
    out("-- compressed tier (shard codec / serving feature cache) --")
    cd = summary.get("codec") or {}
    if not any(cd.values()):
        out("  (no codec or spill activity)")
    else:
        if cd.get("bytes_out"):
            ratio = cd.get("bytes_in", 0) / cd["bytes_out"]
            out(f"  shard codec: {_fmt_bytes(cd.get('bytes_in', 0))} "
                f"stored -> {_fmt_bytes(cd['bytes_out'])} decoded "
                f"(bytes-on-disk ratio {ratio:.3f})")
        if cd.get("cache_spills") or cd.get("cache_disk_hits"):
            out(f"  feature cache: {cd.get('cache_spills', 0)} spill(s) "
                f"to disk, {cd.get('cache_disk_hits', 0)} digest-verified "
                f"disk hit(s)")

    out("")
    out("-- storage surfaces (oocore / feature cache / compile cache) --")
    st = summary.get("storage") or {}
    ooc = st.get("oocore") or {}
    sc = st.get("serve_cache") or {}
    cc = st.get("compile_cache") or {}
    pf_gets = ooc.get("prefetch_hits", 0) + ooc.get("prefetch_stalls", 0)
    cc_gets = cc.get("hits", 0) + cc.get("misses", 0)
    if not (ooc.get("shard_reads") or sc.get("gets") or sc.get("spills")
            or cc_gets):
        out("  (no storage-surface activity)")
    else:
        if ooc.get("shard_reads"):
            ratio_s = ""
            if ooc.get("codec_bytes_out"):
                r = ooc.get("codec_bytes_in", 0) / ooc["codec_bytes_out"]
                ratio_s = f", codec ratio {r:.3f} stored/raw"
            pf_s = (f", prefetch {ooc.get('prefetch_hits', 0) / pf_gets:.0%}"
                    f" hit rate" if pf_gets else "")
            out(f"  oocore: {ooc.get('shard_reads', 0)} shard read(s), "
                f"{_fmt_bytes(ooc.get('shard_read_bytes', 0))} moved"
                f"{ratio_s}{pf_s}, {ooc.get('rereads', 0)} reread(s), "
                f"{ooc.get('crc_failures', 0)} CRC failure(s)")
        if sc.get("gets") or sc.get("spills"):
            hit_s = (f" ({sc.get('disk_hits', 0) / sc['gets']:.0%} of "
                     f"lookups served off disk)" if sc.get("gets") else "")
            out(f"  feature cache: {sc.get('spills', 0)} spill(s), "
                f"{sc.get('disk_hits', 0)} disk hit(s){hit_s}")
        if cc_gets:
            out(f"  compile cache: {cc.get('hits', 0)} reload(s), "
                f"{cc.get('misses', 0)} cold compile(s) "
                f"({cc.get('hits', 0) / cc_gets:.0%} warm)")
        if st.get("io_records"):
            for surface, a in sorted((st.get("ledger") or {}).items()):
                out(f"  ledger[{surface}]: {a.get('entries', 0)} "
                    f"entr{'y' if a.get('entries') == 1 else 'ies'} over "
                    f"{a.get('stores', 0)} store(s), "
                    f"{a.get('reads', 0)} read(s), "
                    f"{_fmt_bytes(a.get('bytes_raw', 0))} raw / "
                    f"{_fmt_bytes(a.get('bytes_stored', 0))} stored")
            out(f"  {st['io_records']} io record(s) — per-shard heat "
                f"table: python -m sq_learn_tpu_torch.obs storage")

    out("")
    out("-- serving SLOs (p50/p99 latency, sustained QPS) --")
    slo = summary.get("slo") or []
    if not slo:
        out("  (no slo records)")
    for r in slo:
        tgt = r.get("targets") or {}
        tgt_s = (" targets p50<=" + _fmt_num(tgt.get("p50_ms"))
                 + "ms p99<=" + _fmt_num(tgt.get("p99_ms")) + "ms"
                 if tgt else "")
        flag = "  SLO VIOLATED" if r.get("violated") else ""
        tb = r.get("transfer_bytes")
        tb_s = f"  moved {tb} B" if tb else ""
        who = r.get("site")
        if r.get("tenant"):
            who = f"{who}[{r['tenant']}]"
        if (r.get("attrs") or {}).get("windowed"):
            who = f"{who} (window #{r['attrs'].get('flush_seq')})"
        out(f"  {who}: {r.get('requests', 0)} req @ "
            f"{_fmt_num(r.get('qps'))} qps  p50 {r.get('p50_ms')}ms  "
            f"p99 {r.get('p99_ms')}ms  occupancy "
            f"{r.get('batch_occupancy')}  degraded {r.get('degraded')}"
            f"{tb_s}{tgt_s}{flag}")
        stages = r.get("stages")
        if stages:
            decomp = "  ".join(f"{k}={v:.4f}s"
                               for k, v in sorted(stages.items()))
            out(f"    stages: {decomp}")

    out("")
    out("-- tenant error budgets (multi-window burn rates) --")
    out(_budget.render(summary.get("budgets") or {}))

    out("")
    out("-- effective (eps, delta) per tenant (live draws) --")
    out(_frontier.render_effective(summary.get("effective") or {}))

    out("")
    out("-- controller decisions (SLO-driven (eps, delta) autotuner) --")
    out(_control.render(summary.get("control") or {}))

    srv = summary.get("serving") or {}
    if (srv.get("aot_compiles") or srv.get("aot_cache_hits")
            or srv.get("quant_folds")):
        out("")
        out("-- serving AOT / quantized routes --")
        gets = srv.get("aot_cache_hits", 0) + srv.get("aot_cache_misses", 0)
        if gets or srv.get("aot_compiles"):
            rate = (srv.get("aot_cache_hits", 0) / gets) if gets else 0.0
            out(f"  {srv.get('aot_compiles', 0)} executable(s) warmed; "
                f"{srv.get('aot_cache_hits', 0)}/{gets} dispatches served "
                f"AOT ({rate:.0%} — 100% means zero serving-path "
                f"compiles)")
        if srv.get("persistent_cache_hits") \
                or srv.get("persistent_cache_misses"):
            out(f"  persistent compile cache: "
                f"{srv.get('persistent_cache_hits', 0)} reload(s), "
                f"{srv.get('persistent_cache_misses', 0)} cold "
                f"compile(s)")
        if srv.get("transfer_bytes"):
            out(f"  {srv.get('transfer_bytes', 0)} padded payload bytes "
                f"moved host->device")
        for fold in srv.get("quant_folds") or []:
            if isinstance(fold, dict):
                out(f"  fold {fold.get('op')}[{fold.get('mode')}]: "
                    f"tol = {fold.get('coef_const')} + "
                    f"{fold.get('coef_amax')}*amax_x ({fold.get('kind')}), "
                    f"delta_q {fold.get('delta')}")

    fl = summary.get("fleet") or {}
    if fl.get("run_ids") or fl.get("hosts") or fl.get("generations"):
        out("")
        out("-- fleet (cross-process correlation) --")
        if fl.get("run_ids"):
            out("  run_id: " + ", ".join(fl["run_ids"]))
        if fl.get("hosts"):
            out("  hosts: " + ", ".join(
                f"{h}={n}" for h, n in sorted(fl["hosts"].items(),
                                              key=lambda kv: str(kv[0]))))
        if fl.get("generations"):
            gens = ", ".join(f"g{g}" for g in fl["generations"])
            out(f"  generations: {gens}  "
                f"({fl.get('windows', 0)} window fold(s), "
                f"{fl.get('commits', 0)} commit(s))")
        if fl.get("clock_samples"):
            out(f"  {fl['clock_samples']} clock sample(s) "
                f"(merged view: python -m sq_learn_tpu_torch.obs fleet)")

    out("")
    out("-- fault / breaker / regression timeline --")
    if not summary["timeline"]:
        out("  (clean run: no faults, breaker transitions, or verdicts)")
    for r in summary["timeline"]:
        t = r["type"]
        if t == "fault":
            out(f"  {r.get('ts')}: fault {r.get('kind')} "
                f"tile={r.get('tile')}")
        elif t == "breaker":
            out(f"  {r.get('ts')}: breaker {r.get('prev')} -> "
                f"{r.get('state')} ({r.get('reason')})")
        else:
            out(f"  {r.get('ts')}: regression {r.get('gate')} "
                f"[{r.get('metric')}] -> {r.get('verdict')}")

    if summary["probes"]:
        out("")
        out("-- probes --")
        for r in summary["probes"]:
            cached = " (cached)" if r.get("cached") else ""
            out(f"  {r.get('outcome')} {r.get('latency_s', 0.0):.2f}s "
                f"platform={r.get('platform')!r}{cached}")
    return "\n".join(lines)


def main(argv):
    """``report <jsonl> [more.jsonl ...] [--json]``"""
    import sys

    as_json = "--json" in argv
    paths = [a for a in argv if a != "--json"]
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs report <jsonl> "
              "[more.jsonl ...] [--json]", file=sys.stderr)
        return 2
    records = []
    for p in paths:
        records.extend(load_jsonl(p))
    summary = summarize(records)
    if as_json:
        print(json.dumps(summary, default=repr))
    else:
        print(render(summary))
    return 0
