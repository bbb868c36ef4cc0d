"""Storage-plane ledger: per-shard heat and latency accounting, and the
tiering advisor (counterpart of ``sq_learn_tpu/obs/storage.py``).

- **the ledger**: every shard read
  (:meth:`~sq_learn_tpu_torch.oocore.store.ShardStore.read_shard`) feeds a
  per-``(surface, store, shard)`` aggregate: stored and raw bytes, the
  latency split into read, CRC, decode and injected ``cold_tier``
  seconds, prefetch hits, stalls and serial reads, retry and quarantine
  counts, and a time-decayed heat (half-life ``_HALF_LIFE_S``). A read on
  a prefetch worker lands on the shard's entry like one on the consumer.
- **pre-aggregation**: aggregates flush as cumulative ``io`` records (the
  newest per key wins, like counters) at pass end
  (:meth:`~sq_learn_tpu_torch.oocore.prefetch.ShardPrefetcher.close`)
  and at recorder close: O(#shards) lines, never one per read.
- **nothing while off**: with obs off, :func:`active` is one
  module-global read returning None; the read paths then allocate
  nothing and never read :data:`_now`.
- **the advisor** (:func:`advise`): per shard, compress, decompress or
  leave, with the bytes and wall clock it would change, from the same
  run's measured codec ratio and per-byte read, cold and decode times.

The port records the ``oocore`` surface; the serving surfaces
(``serve_cache``, ``compile_cache``) come with ``serving/``. The reader
half reads every surface of an artifact, the JAX package's included.

CLI: ``python -m sq_learn_tpu_torch.obs storage <jsonl> [...] [--json]
[--advise] [--top N]``; exits 2 when the artifacts hold no ``io``
record. Rotated sink segments (``<path>.<n>.gz``,
``SQ_OBS_ROTATE_BYTES``) are read too, oldest first.

Standard library only, like the rest of the reader half.
"""

import threading
import time

from .. import _knobs
from . import recorder as _recorder

__all__ = [
    "StorageLedger",
    "active",
    "advise",
    "collect",
    "flush",
    "main",
    "render",
    "surface_rollup",
    "surfaces_snapshot",
]

#: the ledger clock — module-level so the disabled-path test can count
#: reads by monkeypatching (instrumented paths call this ONLY when a
#: ledger is active)
_now = time.perf_counter

#: EWMA heat half-life: an access a minute old counts half of one now
_HALF_LIFE_S = 60.0

#: per-entry cumulative fields, in record order (zero values still emit
#: — a cumulative reader must see explicit zeros, not absent keys)
_INT_FIELDS = ("reads", "bytes_stored", "bytes_raw", "hits", "stalls",
               "retries", "quarantined", "spills", "disk_hits",
               "promotes", "misses")
_TIME_FIELDS = ("read_s", "crc_s", "decode_s", "cold_s", "stall_s")


class StorageLedger:
    """Run-scoped per-``(surface, store, shard)`` access aggregates.

    One instance per :class:`~sq_learn_tpu_torch.obs.recorder.Recorder`,
    created lazily at the first instrumented access (:func:`active`).
    Thread-safe: shard reads land from prefetch worker threads.
    """

    def __init__(self, rec):
        self._rec = rec
        self._lock = threading.Lock()
        self._entries = {}   # (surface, store, shard) -> aggregate dict
        self._dirty = set()  # keys touched since the last flush
        self._flushes = 0

    def _entry_locked(self, surface, store, shard, codec=None):
        key = (surface, store, shard)
        e = self._entries.get(key)
        if e is None:
            e = {f: 0 for f in _INT_FIELDS}
            e.update({f: 0.0 for f in _TIME_FIELDS})
            e.update(heat=0.0, heat_ts=None, codec=codec)
            self._entries[key] = e
        if codec is not None:
            e["codec"] = codec
        self._dirty.add(key)
        return e

    @staticmethod
    def _touch_heat(e, t):
        prev = e["heat_ts"]
        if prev is not None and t > prev:
            e["heat"] *= 0.5 ** ((t - prev) / _HALF_LIFE_S)
        e["heat"] += 1.0
        e["heat_ts"] = t

    def record_read(self, surface, store, shard, *, stored_bytes,
                    raw_bytes, read_s=0.0, crc_s=0.0, decode_s=0.0,
                    cold_s=0.0, retries=0, quarantined=0, codec=None):
        """One materialized shard read (oocore): bytes moved plus the
        decomposed latency of THIS access, retries/quarantine included.
        Safe from any thread; attribution is by key, not caller."""
        t = _now()
        with self._lock:
            e = self._entry_locked(str(surface), str(store),
                                   None if shard is None else int(shard),
                                   codec=codec)
            e["reads"] += 1
            e["bytes_stored"] += int(stored_bytes)
            e["bytes_raw"] += int(raw_bytes)
            e["read_s"] += float(read_s)
            e["crc_s"] += float(crc_s)
            e["decode_s"] += float(decode_s)
            e["cold_s"] += float(cold_s)
            e["retries"] += int(retries)
            e["quarantined"] += int(quarantined)
            self._touch_heat(e, t)

    def record_prefetch(self, store, shard, *, hit, stall_s=0.0):
        """Prefetch outcome for one consumed position: readahead hit or
        consumer stall (with the seconds the consumer waited). The
        matching :meth:`record_read` already landed from the worker."""
        with self._lock:
            e = self._entry_locked("oocore", str(store), int(shard))
            if hit:
                e["hits"] += 1
            else:
                e["stalls"] += 1
                e["stall_s"] += float(stall_s)

    def record_cache_event(self, surface, store, kind, *, stored_bytes=0,
                           raw_bytes=0, dur_s=0.0):
        """One serving-surface event: ``spill`` / ``disk_hit`` /
        ``promote`` / ``miss`` (feature cache) or ``hit`` / ``miss``
        (persistent compile cache). ``dur_s`` is the timed disk work."""
        t = _now()
        with self._lock:
            e = self._entry_locked(str(surface), str(store), None)
            if kind == "spill":
                e["spills"] += 1
                e["bytes_stored"] += int(stored_bytes)
                e["bytes_raw"] += int(raw_bytes)
            elif kind == "disk_hit":
                e["disk_hits"] += 1
                e["reads"] += 1
                e["bytes_raw"] += int(raw_bytes)
                e["read_s"] += float(dur_s)
            elif kind == "promote":
                e["promotes"] += 1
            elif kind == "hit":
                e["hits"] += 1
            else:
                e["misses"] += 1
                e["read_s"] += float(dur_s)
            self._touch_heat(e, t)

    def flush(self, reason="flush"):
        """Emit one cumulative ``io`` record per dirty key (last-wins
        reader semantics, like counters). Called at pass end and by the
        recorder's own close; O(dirty shards), never O(reads)."""
        t = _now()
        with self._lock:
            self._flushes += 1
            out = []
            for key in sorted(self._dirty,
                              key=lambda k: (k[0], k[1],
                                             -1 if k[2] is None else k[2])):
                e = self._entries[key]
                # decay the heat to the flush instant so records taken
                # at different times compare on one clock
                prev = e["heat_ts"]
                if prev is not None and t > prev:
                    e["heat"] *= 0.5 ** ((t - prev) / _HALF_LIFE_S)
                    e["heat_ts"] = t
                rec = {"type": "io", "surface": key[0], "store": key[1],
                       "shard": key[2]}
                for f in _INT_FIELDS:
                    rec[f] = int(e[f])
                for f in _TIME_FIELDS:
                    rec[f] = round(float(e[f]), 6)
                rec["serial"] = max(
                    0, e["reads"] - e["hits"] - e["stalls"]
                    - e["disk_hits"])
                rec["heat"] = round(float(e["heat"]), 6)
                if e["codec"] is not None:
                    rec["codec"] = str(e["codec"])
                rec["reason"] = str(reason)
                out.append(rec)
            self._dirty.clear()
        for rec in out:
            self._rec.record(rec, kind="io_records")
        return len(out)

    def surfaces(self):
        """Per-surface rollup for the recorder snapshot (gauge-style:
        resident/traffic vs the configured budgets and caps)."""
        with self._lock:
            agg = {}
            for (surface, _store, _shard), e in self._entries.items():
                a = agg.setdefault(surface, {
                    "entries": 0, "reads": 0, "bytes_stored": 0,
                    "bytes_raw": 0, "hits": 0, "stalls": 0, "spills": 0,
                    "disk_hits": 0, "misses": 0})
                a["entries"] += 1
                for f in ("reads", "bytes_stored", "bytes_raw", "hits",
                          "stalls", "spills", "disk_hits", "misses"):
                    a[f] += int(e[f])
        return agg


def _attach(rec):
    with _recorder._lock:
        led = getattr(rec, "_storage", None)
        if led is None:
            led = rec._storage = StorageLedger(rec)
    return led


def active():
    """The active run's :class:`StorageLedger`, or None when
    observability is off — the instrumented read paths' single check
    (one module-global read on the disabled path; the ledger is created
    lazily on the first enabled access)."""
    rec = _recorder._active
    if rec is None:
        return None
    led = rec._storage
    if led is None:
        led = _attach(rec)
    return led


def flush(reason="flush"):
    """Flush the active ledger's dirty aggregates as ``io`` records.
    No-op (0) when disabled or nothing was recorded."""
    rec = _recorder._active
    if rec is None:
        return 0
    led = rec._storage
    if led is None:
        return 0
    return led.flush(reason)


def surfaces_snapshot(rec):
    """The snapshot's per-surface traffic-vs-budget gauges: the ledger's
    rollup of the ``oocore`` surface joined with the configured RAM
    budget (a knob read; no directory scan on the snapshot path). The
    serving surfaces come with ``serving/``."""
    led = getattr(rec, "_storage", None)
    agg = led.surfaces() if led is not None else {}
    oocore = dict(agg.get("oocore", {}))
    oocore["ram_budget_bytes"] = _knobs.get_int("SQ_OOC_RAM_BUDGET_BYTES")
    return {"oocore": oocore}


# ---------------------------------------------------------------------------
# Reader half: collect / advise / render / CLI (standard library only)
# ---------------------------------------------------------------------------


def collect(records):
    """Last-wins per-``(surface, store, shard)`` view of a run's ``io``
    records (they are cumulative, like counters — the newest line per
    key is the total)."""
    entries = {}
    for r in records:
        if not isinstance(r, dict) or r.get("type") != "io":
            continue
        key = (str(r.get("surface")), str(r.get("store")), r.get("shard"))
        entries[key] = r
    surfaces = {}
    for (surface, store, shard), r in sorted(
            entries.items(),
            key=lambda kv: (kv[0][0], kv[0][1],
                            -1 if kv[0][2] is None else kv[0][2])):
        surfaces.setdefault(surface, {}).setdefault(store, {})[shard] = r
    return {"surfaces": surfaces, "records": len(entries)}


def _num(r, field):
    v = r.get(field, 0)
    return float(v) if isinstance(v, (int, float)) else 0.0


def surface_rollup(view):
    """Per-surface totals of a collected view — the compact shape the
    ``obs report`` storage section embeds (the full per-shard table is
    this module's own CLI)."""
    out = {}
    for surface, per_store in (view.get("surfaces") or {}).items():
        a = out.setdefault(surface, {
            "stores": len(per_store), "entries": 0, "reads": 0,
            "bytes_stored": 0, "bytes_raw": 0, "hits": 0, "stalls": 0,
            "spills": 0, "disk_hits": 0, "misses": 0, "read_s": 0.0,
            "cold_s": 0.0})
        for shards in per_store.values():
            for r in shards.values():
                a["entries"] += 1
                for f in ("reads", "bytes_stored", "bytes_raw", "hits",
                          "stalls", "spills", "disk_hits", "misses"):
                    a[f] += int(_num(r, f))
                a["read_s"] += _num(r, "read_s")
                a["cold_s"] += _num(r, "cold_s")
        a["read_s"] = round(a["read_s"], 6)
        a["cold_s"] = round(a["cold_s"], 6)
    return out


def advise(view):
    """Placement recommendations from one run's measured ledger.

    The measured inputs, all from the run itself (never a model):

    - ``ratio`` — stored/raw over every compressed oocore read
      (``None`` when the run observed no compressed shard: the advisor
      then refuses to project compression instead of inventing a ratio);
    - per-store ``t_io`` — (read+cold) seconds per STORED byte: what a
      byte on that store's tier actually costs to move;
    - ``t_dec`` — decode seconds per RAW byte over compressed reads.

    Per raw shard, compressing changes bytes by ``raw×ratio − stored``
    and one access by that same delta × ``t_io`` plus ``raw × t_dec``;
    per compressed shard, decompressing is the mirror image. The
    recommendation is ``compress`` / ``decompress`` when the per-access
    wallclock delta is negative, ``leave`` otherwise; ``projected_*``
    fields scale by the run's observed access count, and shards rank by
    heat so the autopilot spends its migration budget hot-first.
    """
    stores = (view.get("surfaces") or {}).get("oocore", {})
    comp_stored = comp_raw = comp_dec_s = 0.0
    t_io_store = {}
    for store, shards in stores.items():
        io_s = stored_b = 0.0
        for r in shards.values():
            io_s += _num(r, "read_s") + _num(r, "cold_s")
            stored_b += _num(r, "bytes_stored")
            if r.get("codec") not in (None, "none"):
                comp_stored += _num(r, "bytes_stored")
                comp_raw += _num(r, "bytes_raw")
                comp_dec_s += _num(r, "decode_s")
        if stored_b > 0:
            t_io_store[store] = io_s / stored_b
    ratio = (comp_stored / comp_raw) if comp_raw > 0 else None
    t_dec = (comp_dec_s / comp_raw) if comp_raw > 0 else 0.0
    notes = []
    if ratio is None:
        notes.append("no compressed shard observed this run: codec ratio "
                     "unmeasured, compression is not projected")
    shards_out = []
    for store, shards in stores.items():
        t_io = t_io_store.get(store, 0.0)
        for shard, r in shards.items():
            if shard is None:
                continue
            reads = _num(r, "reads")
            raw = _num(r, "bytes_raw") / max(reads, 1.0)
            stored = _num(r, "bytes_stored") / max(reads, 1.0)
            compressed = r.get("codec") not in (None, "none")
            action, dbytes, dt_access = "leave", 0.0, 0.0
            if not compressed and ratio is not None:
                dbytes = raw * ratio - stored
                dt_access = dbytes * t_io + raw * t_dec
                if dt_access < 0:
                    action = "compress"
            elif compressed:
                dec_s = _num(r, "decode_s") / max(reads, 1.0)
                dbytes = raw - stored
                dt_access = dbytes * t_io - dec_s
                if dt_access < 0:
                    action = "decompress"
                else:
                    dbytes, dt_access = 0.0, 0.0
            if action == "leave":
                dbytes = dt_access = 0.0
            shards_out.append({
                "surface": "oocore", "store": store, "shard": shard,
                "action": action, "heat": _num(r, "heat"),
                "reads": int(reads),
                "bytes_raw": int(_num(r, "bytes_raw")),
                "bytes_stored": int(_num(r, "bytes_stored")),
                "projected_bytes_delta": int(round(dbytes)),
                "projected_wallclock_delta_s": round(
                    dt_access * reads, 6)})
    shards_out.sort(key=lambda s: -s["heat"])
    return {"ratio": ratio, "t_dec_per_byte": t_dec,
            "t_io_per_byte": t_io_store, "shards": shards_out,
            "notes": notes}


def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def render(view, advice=None, top=20):
    """Human view: per-surface accounting, the heat×bytes shard table
    (hottest first), and — when :func:`advise` ran — the placement
    recommendations."""
    lines = []
    out = lines.append
    surfaces = view.get("surfaces") or {}
    if not surfaces:
        return "  (no io records)"
    for surface in sorted(surfaces):
        per_store = surfaces[surface]
        n_entries = sum(len(s) for s in per_store.values())
        tot = {}
        for shards in per_store.values():
            for r in shards.values():
                for f in _INT_FIELDS + _TIME_FIELDS:
                    tot[f] = tot.get(f, 0) + _num(r, f)
        out(f"  -- {surface}: {len(per_store)} store(s), "
            f"{n_entries} ledger entr{'y' if n_entries == 1 else 'ies'} --")
        out(f"    reads={int(tot.get('reads', 0))} "
            f"stored={_fmt_bytes(tot.get('bytes_stored', 0))} "
            f"raw={_fmt_bytes(tot.get('bytes_raw', 0))} "
            f"read={tot.get('read_s', 0.0):.3f}s "
            f"crc={tot.get('crc_s', 0.0):.3f}s "
            f"decode={tot.get('decode_s', 0.0):.3f}s "
            f"cold={tot.get('cold_s', 0.0):.3f}s")
        if surface == "oocore":
            out(f"    prefetch: hits={int(tot.get('hits', 0))} "
                f"stalls={int(tot.get('stalls', 0))} "
                f"stall={tot.get('stall_s', 0.0):.3f}s "
                f"retries={int(tot.get('retries', 0))} "
                f"quarantined={int(tot.get('quarantined', 0))}")
        else:
            out(f"    spills={int(tot.get('spills', 0))} "
                f"disk_hits={int(tot.get('disk_hits', 0))} "
                f"promotes={int(tot.get('promotes', 0))} "
                f"hits={int(tot.get('hits', 0))} "
                f"misses={int(tot.get('misses', 0))}")
    ranked = []
    for surface, per_store in surfaces.items():
        for store, shards in per_store.items():
            for shard, r in shards.items():
                if shard is not None:
                    ranked.append((surface, store, shard, r))
    ranked.sort(key=lambda x: -_num(x[3], "heat"))
    if ranked:
        out(f"  -- hottest shards (top {min(top, len(ranked))} of "
            f"{len(ranked)}) --")
        out("    surface  store      shard  heat     reads  stored"
            "     raw        read_s   cold_s")
        for surface, store, shard, r in ranked[:top]:
            out(f"    {surface:<8} {store[:10]:<10} {shard:>5}  "
                f"{_num(r, 'heat'):<7.3f}  {int(_num(r, 'reads')):<5} "
                f"{_fmt_bytes(_num(r, 'bytes_stored')):<9} "
                f"{_fmt_bytes(_num(r, 'bytes_raw')):<9}  "
                f"{_num(r, 'read_s'):<7.4f}  {_num(r, 'cold_s'):<7.4f}")
    if advice is not None:
        ratio = advice.get("ratio")
        out("  -- tiering advice --")
        out(f"    measured codec ratio (stored/raw): "
            f"{'unmeasured' if ratio is None else f'{ratio:.3f}'}")
        for note in advice.get("notes") or []:
            out(f"    note: {note}")
        moved = [s for s in advice.get("shards") or []
                 if s["action"] != "leave"]
        out(f"    recommendations: {len(moved)} move(s), "
            f"{len(advice.get('shards') or []) - len(moved)} leave")
        for s in moved[:top]:
            out(f"    {s['action']:<10} {s['store'][:10]:<10} "
                f"shard {s['shard']:>4}  heat={s['heat']:.3f}  "
                f"Δbytes={_fmt_bytes(s['projected_bytes_delta'])}/read  "
                f"Δwall={s['projected_wallclock_delta_s']:+.4f}s/run")
    return "\n".join(lines)


def _with_segments(paths):
    """Expand each path with its rotated gzip segments
    (``<path>.<n>.gz``, oldest first, live file last) so last-wins
    collect semantics survive ``SQ_OBS_ROTATE_BYTES`` rotation."""
    import os

    out = []
    for p in paths:
        segs = []
        n = 1
        while os.path.exists(f"{p}.{n}.gz"):
            segs.append(f"{p}.{n}.gz")
            n += 1
        out.extend(segs)
        out.append(p)
    return out


def main(argv):
    """``storage <jsonl> [more.jsonl ...] [--json] [--advise]
    [--top N]`` — render the storage-plane ledger of one or more obs
    JSONL artifacts; exits 2 when the artifacts carry ZERO ``io``
    records ("no telemetry" must never read as "healthy storage" in
    CI), 0 otherwise."""
    import json
    import sys

    as_json = "--json" in argv
    with_advice = "--advise" in argv
    top = 20
    paths = []
    it = iter(a for a in argv if a not in ("--json", "--advise"))
    for a in it:
        if a == "--top":
            try:
                top = int(next(it))
            except (StopIteration, ValueError):
                print("--top needs an integer", file=sys.stderr)
                return 2
        else:
            paths.append(a)
    if not paths:
        print("usage: python -m sq_learn_tpu_torch.obs storage <jsonl> "
              "[more.jsonl ...] [--json] [--advise] [--top N]",
              file=sys.stderr)
        return 2
    from ._files import load_jsonl

    records = []
    for p in _with_segments(paths):
        records.extend(load_jsonl(p))
    view = collect(records)
    if not view["records"]:
        if as_json:
            print(json.dumps(dict(view, error="no io telemetry")))
        print(f"no storage telemetry: zero io records in "
              f"{', '.join(paths)}", file=sys.stderr)
        return 2
    advice = advise(view) if with_advice else None
    if as_json:
        doc = dict(view)
        if advice is not None:
            doc["advice"] = advice
        print(json.dumps(doc))
    else:
        print("== storage-plane ledger (per-shard heat/latency) ==")
        print(render(view, advice=advice, top=top))
    return 0
