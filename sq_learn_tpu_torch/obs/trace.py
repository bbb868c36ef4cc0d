"""Render obs JSONL into Chrome trace-event JSON, viewable in Perfetto
(counterpart of ``sq_learn_tpu/obs/trace.py``).

Spans become duration events, counters and gauges counter tracks, and the
discrete records (faults, breaker transitions, ledger entries, guarantee
draws, trade-off points, storage ``io`` aggregates, and the JAX package's
other types when it wrote the file) instant events on lanes of their own.
Every process that opens a sink writes a ``meta`` record with its pid
first, so lines group onto pid lanes by the newest ``meta`` above them; a
file without one gets a synthetic pid, and several files merge onto
separate process lanes in one trace.

Standard library only: the CLI runs without torch.

CLI: ``python -m sq_learn_tpu_torch.obs trace run.jsonl [more.jsonl ...]
[-o out.json]`` (default output ``<first input>.trace.json``).
``SQ_OBS_TRACE=<path>`` makes :func:`~sq_learn_tpu_torch.obs.recorder.
disable` render the closing run's sink there.
"""

import json
import os

from ._files import load_jsonl

__all__ = ["load_jsonl", "to_chrome_trace", "write_trace", "main"]

#: tid lanes for non-span records — named via thread_name metadata so
#: Perfetto labels them instead of showing bare numbers
_LANES = {
    "span": (0, "spans"),
    "watchdog": (1, "compiles (watchdog)"),
    "xla_cost": (2, "xla cost"),
    "fault": (3, "faults"),
    "breaker": (4, "breaker"),
    "probe": (5, "probe"),
    "ledger": (6, "quantum ledger"),
    "regression": (7, "regression gate"),
    "guarantee": (8, "guarantee audit"),
    "tradeoff": (9, "tradeoff frontier"),
    "slo": (10, "serving slo"),
    "budget": (11, "error budgets"),
    "alert": (12, "budget alerts"),
    "control": (13, "controller decisions"),
    "elastic": (14, "elastic mesh"),
    "clock": (15, "clock samples"),
    "io": (16, "storage io"),
}

#: records that move onto a per-tenant lane when they carry a tenant
#: (the serving plane's per-tenant telemetry reads as one lane per
#: tenant: its slo windows, budget evaluations, alerts, and controller
#: decisions together)
_TENANT_TYPES = ("slo", "budget", "alert", "control")

#: first tid of the dynamically-allocated per-tenant lanes
_TENANT_TID0 = 17


def _args_of(rec, drop=("v", "schema_version", "ts", "type")):
    out = {}
    for k, v in rec.items():
        if k in drop:
            continue
        if isinstance(v, dict):
            out[k] = v
        elif isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def _instant_name(rec):
    t = rec["type"]
    if t == "watchdog":
        return (f"compile {rec.get('site')}: {rec.get('compiles')}"
                f"/{rec.get('budget')}")
    if t == "xla_cost":
        return f"xla_cost {rec.get('site')}"
    if t == "fault":
        return f"fault:{rec.get('kind')}"
    if t == "breaker":
        return f"breaker {rec.get('prev')}→{rec.get('state')}"
    if t == "probe":
        return f"probe:{rec.get('outcome')}"
    if t == "ledger":
        return f"ledger {rec.get('estimator')}.{rec.get('step')}"
    if t == "regression":
        return f"regress {rec.get('gate')}:{rec.get('verdict')}"
    if t == "guarantee":
        state = "VIOLATED" if rec.get("violated") else "ok"
        if rec.get("short_circuit"):
            state = "short-circuit"
        return f"guarantee {rec.get('site')}:{state}"
    if t == "tradeoff":
        return (f"tradeoff {rec.get('sweep')}@{rec.get('point')}: "
                f"acc={rec.get('accuracy')}")
    if t == "slo":
        who = rec.get("tenant") or rec.get("site")
        return (f"slo {who}: p99={rec.get('p99_ms')}ms "
                f"qps={rec.get('qps')}")
    if t == "budget":
        state = "ALERTING" if rec.get("alerting") else "ok"
        return (f"budget {rec.get('tenant')}@{rec.get('window_s')}s: "
                f"burn={rec.get('burn_rate')} {state}")
    if t == "alert":
        return f"ALERT {rec.get('tenant')}:{rec.get('kind')}"
    if t == "control":
        return (f"control {rec.get('tenant')}:{rec.get('action')}"
                f"@L{rec.get('level', 0)}")
    if t == "elastic":
        return (f"elastic {rec.get('event')} g{rec.get('generation')} "
                f"n={rec.get('n_hosts')}")
    if t == "clock":
        return f"clock {rec.get('peer')} via {rec.get('via', '?')}"
    if t == "io":
        shard = rec.get("shard")
        where = (f"{rec.get('store')}"
                 if shard is None else f"{rec.get('store')}[{shard}]")
        return (f"io {rec.get('surface')} {where}: "
                f"reads={rec.get('reads')} heat={rec.get('heat')}")
    return t


def to_chrome_trace(record_groups):
    """Build the trace-event dict from ``[(pid_label, records), ...]``
    groups — one group per source file. ``meta`` records inside a group
    re-key the pid lane (multi-process appenders share one file); a
    group with no ``meta`` gets a synthetic pid.
    """
    events = []
    named_pids = set()
    named_lanes = set()
    tenant_tids = {}  # (pid, tenant) -> dedicated lane tid

    def name_process(pid, label):
        if pid in named_pids:
            return
        named_pids.add(pid)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})

    def name_lane(pid, tid, label):
        if (pid, tid) in named_lanes:
            return
        named_lanes.add((pid, tid))
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": label}})

    for group_idx, (label, records) in enumerate(record_groups):
        pid = 100000 + group_idx  # synthetic until a meta names the real one
        name_process(pid, label)
        for rec in records:
            t = rec.get("type")
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            us = ts * 1e6
            if t == "meta":
                real = rec.get("pid")
                if isinstance(real, int):
                    pid = real
                    name_process(pid, f"{label} (pid {real})")
                continue
            if t == "span":
                dur = rec.get("dur_s")
                if not isinstance(dur, (int, float)):
                    continue
                tid, lane = _LANES["span"]
                name_lane(pid, tid, lane)
                events.append({
                    "ph": "X", "cat": "span", "name": str(rec.get("name")),
                    # ts is recorded at span CLOSE: start = end - duration
                    "ts": us - dur * 1e6, "dur": dur * 1e6,
                    "pid": pid, "tid": tid, "args": _args_of(rec),
                })
            elif t in ("counter", "gauge"):
                val = rec.get("value")
                if not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    continue  # non-numeric gauges have no counter track
                events.append({
                    "ph": "C", "name": str(rec.get("name")), "ts": us,
                    "pid": pid, "tid": 0, "args": {"value": val},
                })
            elif t in _LANES:
                dyn = None  # label of a dynamically-allocated lane
                if t in _TENANT_TYPES and rec.get("tenant") is not None:
                    # per-tenant lane: a tenant's slo windows, budget
                    # evaluations, and alerts read as one timeline
                    dyn = f"tenant:{rec['tenant']}"
                elif t == "elastic" \
                        and isinstance(rec.get("generation"), int) \
                        and not isinstance(rec.get("generation"), bool):
                    # per-generation lane: each shrink's new world reads
                    # as its own timeline (v9)
                    dyn = f"elastic:g{rec['generation']}"
                if dyn is not None:
                    key = (pid, dyn)
                    tid = tenant_tids.get(key)
                    if tid is None:
                        tid = _TENANT_TID0 + len(tenant_tids)
                        tenant_tids[key] = tid
                    name_lane(pid, tid, dyn)
                else:
                    tid, lane = _LANES[t]
                    name_lane(pid, tid, lane)
                events.append({
                    "ph": "i", "s": "t", "cat": t, "name": _instant_name(rec),
                    "ts": us, "pid": pid, "tid": tid, "args": _args_of(rec),
                })
            # unknown types: skipped — the trace is a view, not a validator
    def _order(e):
        # ts collides at millisecond resolution when a flush emits many
        # lines at once; the v8 monotonic seq (budget/alert/control —
        # spans carry their own) breaks the tie deterministically, and
        # the stable sort preserves file order for records without one
        seq = e.get("args", {}).get("seq")
        return (e["ph"] != "M", e.get("ts", 0.0),
                seq if isinstance(seq, int) and not isinstance(seq, bool)
                else -1)

    events.sort(key=_order)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(paths, out_path):
    """Render one or more obs JSONL files into ``out_path``; returns the
    trace dict."""
    groups = [(os.path.basename(p), load_jsonl(p)) for p in paths]
    trace = to_chrome_trace(groups)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    return trace


def main(argv):
    """``trace <jsonl> [more.jsonl ...] [-o out.json]``"""
    import sys

    out = None
    paths = []
    it = iter(argv)
    for a in it:
        if a in ("-o", "--out"):
            out = next(it, None)
        else:
            paths.append(a)
    if not paths or out is None and not paths[0]:
        print("usage: python -m sq_learn_tpu_torch.obs trace <jsonl> "
              "[more.jsonl ...] [-o out.json]", file=sys.stderr)
        return 2
    if out is None:
        out = paths[0] + ".trace.json"
    trace = write_trace(paths, out)
    print(json.dumps({"trace": out, "events": len(trace["traceEvents"]),
                      "sources": len(paths)}))
    return 0
