"""The program's own ranges in a traced run: what ``sq_learn_tpu_torch``'s
spans (``obs.span``, a profiler range of the span's name while a profiler
records) say about the window, beside the device's reading of
``trace.py``.

:func:`summarize_program` reduces a window's profiler events to, per
range name: calls, wall seconds, self seconds (wall less the time its
child ranges cover), device-idle seconds inside it (wall less the union
of device intervals overlapping it), idle seconds in no child range, and
the device seconds of what was launched inside it (joined by correlation
id, as ``trace.py`` joins the ``perfbench.*`` ranges); and the share of
the window's idle time inside any program range. A program range is a
host event with a dotted lower-case name (``qkmeans.lloyd_iter``,
``sync.validation``) other than the benchmark's ``perfbench.*``.
:func:`readings` turns that into four per-layer numbers (the Lloyd loop's
host gap, host waits per fit, init ms per fit, the predict's host gap).

One traced run of a cell with the program's table printed to standard
error, then the harness's result line on standard output:

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

The table of an obs run's JSONL (``SQ_OBS=1 SQ_OBS_PATH=<jsonl>`` around
an untraced run), per fit or predict:

    python3 perfbench/spans.py --obs <jsonl>
"""

import bisect
import collections
import json
import re
import sys

#: a program range's name: dotted lower-case words (``aten::`` ops, the
#: runtime's calls and the profiler's own events have none)
PROGRAM = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")


def _is_program(name):
    return (PROGRAM.fullmatch(name) is not None
            and not name.startswith("perfbench."))


def summarize_program(events):
    """The program's ranges over the window of a list of profiler events
    (module docstring). Returns ``{"ranges": {name: {"calls", "wall_s",
    "self_s", "idle_s", "self_idle_s", "device_s"}}, "idle_s",
    "idle_in_ranges_s", "idle_in_ranges_share"}``; ``ranges`` is empty
    when the program opened none (a program without spans)."""
    from perfbench import trace

    device, host, window = trace._records(events)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1 = window
    inside = [ev for ev in device if ev[3] > w0 and ev[2] < w1]
    busy = trace._merged([(max(ev[2], w0), min(ev[3], w1))
                          for ev in inside])
    ends = [b for _, b in busy]
    cum = [0]
    for a, b in busy:
        cum.append(cum[-1] + b - a)

    def busy_before(t):
        """Device-busy ns in [w0, t]."""
        i = bisect.bisect_right(ends, t)
        part = max(0, t - busy[i][0]) if i < len(busy) else 0
        return cum[i] + part

    def idle(a, b):
        a, b = max(a, w0), min(b, w1)
        return max(0, (b - a) - (busy_before(b) - busy_before(a)))

    spans = sorted(((ev[2], ev[3], ev[1]) for ev in host
                    if ev[3] > w0 and ev[2] < w1 and _is_program(ev[1])),
                   key=lambda s: (s[0], -s[1]))
    parent, stack = [], []
    for i, (a, b, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < b:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    wall = [b - a for a, b, _ in spans]
    idle_in = [idle(a, b) for a, b, _ in spans]
    self_ns, self_idle = list(wall), list(idle_in)
    for i, p in enumerate(parent):
        if p is not None:
            self_ns[p] -= wall[i]
            self_idle[p] -= idle_in[i]

    # each device event to the innermost range open at its launch, then
    # up to every range holding that one
    launch_at = {ev[4]: ev[2] for ev in host
                 if ev[0] in trace.LAUNCH_ACTIVITIES}
    launches = sorted((launch_at[ev[4]], ev[3] - ev[2]) for ev in inside
                      if ev[4] in launch_at)
    own = [0] * len(spans)
    stack, j = [], 0
    for t, length in launches:
        while j < len(spans) and spans[j][0] <= t:
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        if stack:
            own[stack[-1]] += length
    for i in range(len(spans) - 1, -1, -1):
        if parent[i] is not None:
            own[parent[i]] += own[i]

    ranges = collections.defaultdict(lambda: collections.Counter())
    for i, (_, _, name) in enumerate(spans):
        r = ranges[name]
        r["calls"] += 1
        r["wall_s"] += wall[i] / 1e9
        r["self_s"] += self_ns[i] / 1e9
        r["idle_s"] += idle_in[i] / 1e9
        r["self_idle_s"] += self_idle[i] / 1e9
        r["device_s"] += own[i] / 1e9
    window_idle = (w1 - w0) - cum[-1]
    in_ranges = sum(idle_in[i] for i, p in enumerate(parent) if p is None)
    return {"ranges": {name: dict(r) for name, r in ranges.items()},
            "idle_s": window_idle / 1e9, "idle_in_ranges_s": in_ranges / 1e9,
            "idle_in_ranges_share": (in_ranges / window_idle
                                     if window_idle > 0 else None)}


def _per(ranges, name, key, count):
    r = ranges.get(name)
    return None if r is None or not count else 1e3 * r[key] / count


def readings(program, kind, requests):
    """{metric: {"value", "note"}} of the four per-layer numbers the
    program's ranges give, for a job of ``kind`` ("fit" or "predict")
    that completed ``requests`` fits or predicts; {} when the run has no
    program ranges."""
    ranges = program["ranges"] if program else {}
    if not ranges or not requests:
        return {}
    out = {}
    if kind == "fit":
        steps = ranges.get("qkmeans.lloyd_iter", {}).get("calls", 0)
        gap = _per(ranges, "qkmeans.lloyd_iter", "idle_s", steps)
        if gap is not None:
            split = {name: round(_per(ranges, name, "self_idle_s", steps), 4)
                     for name in ("qkmeans.lloyd_iter", "qkmeans.gumbel",
                                  "kernels.lloyd_step", "qkmeans.e_step",
                                  "qkmeans.relocate", "qkmeans.update",
                                  "sync.qkmeans.stop_rule")
                     if name in ranges}
            out["lloyd_gap_ms"] = {
                "value": gap, "note": f"{steps} steps; idle ms a step in no "
                f"child range, by innermost range: {split}"}
        waits = {name[5:]: r["calls"] / requests
                 for name, r in ranges.items() if name.startswith("sync.")}
        out["host_waits.fit"] = {
            "value": sum(waits.values()),
            "note": "per fit, by site: " + json.dumps(
                {k: round(v, 3) for k, v in sorted(waits.items())})}
        init = ranges.get("qkmeans.fused_init")
        if init is not None:
            stats, seed = (_per(ranges, name, "wall_s", requests) or 0.0
                           for name in ("qkmeans.stats", "qkmeans.seed"))
            busy = 1 - init["idle_s"] / init["wall_s"]
            out["init_ms.fit"] = {
                "value": 1e3 * init["wall_s"] / requests,
                "note": f"stats {stats:.4g} ms, seed {seed:.4g} ms a fit; "
                f"the device busy {busy:.4f} of the init's wall"}
    elif kind == "predict":
        gap = _per(ranges, "knn.predict", "idle_s", requests)
        if gap is not None:
            split = {name: round(_per(ranges, name, "self_idle_s",
                                      requests), 4)
                     for name in ("knn.predict", "knn.validate",
                                  "sync.validation", "knn.search",
                                  "kernels.argkmin", "sync.knn.fetch",
                                  "knn.vote") if name in ranges}
            out["predict_gap_ms"] = {
                "value": gap, "note": f"idle ms a predict in no child "
                f"range, by innermost range: {split}"}
    return out


def table(program, requests, out=sys.stderr):
    """Print the program's ranges, per request, most idle first."""
    ranges = program["ranges"]
    print(f"program ranges over {requests} requests (ms a request): "
          f"idle in ranges {program['idle_in_ranges_s']:.4f} of "
          f"{program['idle_s']:.4f} s, share "
          f"{program['idle_in_ranges_share']}", file=out)
    print(f"{'range':28s} {'calls':>8s} {'wall':>9s} {'self':>9s} "
          f"{'idle':>9s} {'self idle':>9s} {'device':>9s}", file=out)
    for name, r in sorted(ranges.items(), key=lambda kv: -kv[1]["idle_s"]):
        per = 1e3 / requests
        print(f"{name:28s} {r['calls'] / requests:8.2f} "
              f"{r['wall_s'] * per:9.4f} {r['self_s'] * per:9.4f} "
              f"{r['idle_s'] * per:9.4f} {r['self_idle_s'] * per:9.4f} "
              f"{r['device_s'] * per:9.4f}", file=out)


def obs_table(path, out=sys.stderr):
    """Per span name of an obs run's JSONL: calls and ms per fit (or per
    predict, where the run has no fit), from the records' host wall
    clock."""
    from sq_learn_tpu_torch.obs._files import load_jsonl

    spans = [r for r in load_jsonl(path) if r.get("type") == "span"]
    calls, dur = collections.Counter(), collections.Counter()
    for s in spans:
        calls[s["name"]] += 1
        dur[s["name"]] += s["dur_s"]
    unit = "qkmeans.fit" if calls["qkmeans.fit"] else "knn.predict"
    n = calls[unit]
    print(f"obs spans of {path}, per {unit} ({n}): calls, ms", file=out)
    for name, d in sorted(dur.items(), key=lambda kv: -kv[1]):
        print(f"{name:28s} {calls[name] / n:8.2f} {1e3 * d / n:9.4f}",
              file=out)
    return {name: (calls[name] / n, 1e3 * d / n) for name, d in dur.items()}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--obs", help="an obs run's JSONL to tabulate")
    args = parser.parse_args(argv)
    if args.obs:
        obs_table(args.obs)
        return 0

    from perfbench import harness
    from perfbench import trace as bench_trace

    read = bench_trace.summarize
    got = {}

    def summarize(events):
        out = read(events)
        got["program"] = summarize_program(events)
        return out

    bench_trace.summarize = summarize
    try:
        result = harness.run(args.workload, args.seed, args.seconds, 1,
                             log=lambda msg: print(msg, file=sys.stderr))
    finally:
        bench_trace.summarize = read
    program = got["program"]
    _, _, traffic, _, _ = harness.load_cell(args.workload)
    kind = "fit" if "deltas" in traffic else "predict"
    unit = result["attempted"] * len(traffic.get("deltas", [0]))
    table(program, unit)
    for name, reading in readings(program, kind, unit).items():
        print(f"{name}: {reading['value']} ({reading['note']})",
              file=sys.stderr)
    calls = {n: r["calls"] for n, r in program["ranges"].items()}
    device = {n: r["device_s"] for n, r in program["ranges"].items()}
    print(f"twins: qkmeans.lloyd_iter calls "
          f"{calls.get('qkmeans.lloyd_iter')}, kernels.lloyd_step calls "
          f"{calls.get('kernels.lloyd_step')}, kernels.argkmin calls "
          f"{calls.get('kernels.argkmin')}; device s kernels.lloyd_step "
          f"{device.get('kernels.lloyd_step')}, kernels.argkmin "
          f"{device.get('kernels.argkmin')} (the benchmark's wrappers: "
          f"the trace line above)", file=sys.stderr)
    print(json.dumps({**result, "program": program}), flush=True)
    return 0


if __name__ == "__main__":
    import os

    # run.py's preamble: the checkout's root on the path in place of this
    # directory, and the run's environment (one host thread a pool)
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    sys.path.insert(0, os.path.dirname(_HERE))
    from perfbench import run  # noqa: F401

    sys.exit(main())
