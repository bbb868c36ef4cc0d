"""Perf-regression gate over a bench trajectory (counterpart of
``sq_learn_tpu/obs/regress.py``).

A fresh metric record (a JSON line carrying ``metric`` and ``value``) is
banded against the history of the same metric, per gate:

=====================  ====================================================
gate                   red when (tolerance-banded, see ``TOLERANCES``)
=====================  ====================================================
latency                value > tol × median(history values) + slack
total_transfer_bytes   obs.total_transfer_bytes over the band — a tiling
                       regression re-uploading data
peak_hbm_bytes         obs.peak_hbm_bytes over the band — the
                       process's measured peak of device memory since
                       obs.enable (earlier allocations included)
                       growing past its history
accuracy               value of a ``unit: "accuracy"`` line UNDER
                       ratio × median − slack — the lower-bounded quality
                       band (replaces the latency gate on those lines)
throughput             value of a ``unit: "qps"`` line UNDER
                       ratio × median − slack — the lower-bounded serving
                       band (replaces the latency gate on those lines)
vs_baseline            a record carrying ``vs_baseline_floor`` whose
                       ``vs_baseline`` drops UNDER floor × ratio − slack —
                       the history-free declared-floor band
=====================  ====================================================

``SQ_REGRESS_TOL_*`` and ``SQ_REGRESS_SLACK_*`` override a gate's ratio
and slack (``SQ_REGRESS_TOL_LATENCY=3``). Verdicts are ``green`` /
``red`` / ``skip`` (skip: no reference on that gate — never a silent
green). Each verdict is one schema-valid ``regression`` JSONL line
(:mod:`.schema`), so the same validator, trace and report read gate
output.

Where the port departs from the JAX package (``ROADMAP.md``, "Where
``obs regress`` departs"):

- no ``compile_count`` gate: eager torch has no retrace to count, so a
  record's ``obs.compile_count`` gets no verdict;
- a record is banded only against history records of the same
  ``backend`` field (the JAX package's lines say ``"cpu"``, a TPU, or
  nothing; the port's say :func:`port_backend`'s ``torch/<device>``), so
  a port record never meets the JAX package's trajectory and gets
  ``skip`` beside it;
- ``SCHEMA_VERSION`` is the recorder's;
- :func:`selftest` injects a regression the port can see: a doubled,
  kept-alive upload.

The comparison path is standard library only (torch is imported by
:func:`selftest` and :func:`port_backend` alone), so
``python -m sq_learn_tpu_torch.obs regress`` runs without torch.
"""

import glob
import json
import os
import time
from statistics import median

from .. import _knobs

#: the recorder's envelope version (``recorder.SCHEMA_VERSION``; a copy,
#: so that this module loads without the recorder's imports)
SCHEMA_VERSION = 11

__all__ = ["load_history", "check_record", "check_file", "selftest", "main"]

#: gate → (ratio tolerance, absolute slack), the JAX package's table less
#: its compile_count gate. Ratio bands absorb proportional drift (host
#: load for latency, bucket padding for bytes); the absolute slack keeps
#: tiny references from banning tiny noise. ``accuracy`` and
#: ``throughput`` are LOWER-bounded (red when the value drops below
#: ratio × reference − slack); ``vs_baseline`` bands a record's own
#: declared floor.
TOLERANCES = {
    "latency": (2.0, 0.05),
    "total_transfer_bytes": (1.25, 4096),
    "peak_hbm_bytes": (1.25, 1 << 20),
    "accuracy": (0.9, 0.02),
    "throughput": (0.5, 0.0),
    "vs_baseline": (1.0, 0.0),
}

#: value-gate selection by the record's unit (default: latency)
_UNIT_GATES = {"accuracy": "accuracy", "qps": "throughput"}

#: the lower-bounded gates (value must stay ABOVE ratio × ref − slack)
_LOWER_BOUNDED = ("accuracy", "throughput")

#: gates read from the record's obs object (the value gates read "value")
OBS_GATES = ("total_transfer_bytes", "peak_hbm_bytes")

#: the selftest's upload: well past the gates' slack (1 MiB of peak,
#: 4 096 bytes of transfer), streamed in tiles of _SELFTEST_TILE_BYTES
_SELFTEST_BYTES = 16 << 20
_SELFTEST_TILE_BYTES = 4 << 20
_SELFTEST_COLS = 256


def port_backend(device):
    """The ``backend`` field of the port's records run on ``device``:
    ``torch/<card name>`` on a CUDA device, ``torch/cpu`` on the CPU.
    Never equal to a JAX package line's."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return "torch/" + torch.cuda.get_device_name(device)
    return f"torch/{device.type}"


def _tolerance(gate):
    tol, slack = TOLERANCES[gate]
    env_t = _knobs.get_raw(f"SQ_REGRESS_TOL_{gate.upper()}")
    env_s = _knobs.get_raw(f"SQ_REGRESS_SLACK_{gate.upper()}")
    return (float(env_t) if env_t else tol,
            float(env_s) if env_s else slack)


def _metric_lines(path):
    """The machine-readable metric lines of a record file: JSON objects
    carrying "metric" and "value"."""
    out = []
    try:
        fh = open(path)
    except OSError:
        return out
    with fh:
        for raw in fh:
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if isinstance(rec, dict) and "metric" in rec and "value" in rec:
                out.append(rec)
    return out


def load_history(root="."):
    """{metric: [record, ...]} chronologically, from ``BENCH_r*.json``
    (each round's parsed headline line) and every
    ``bench/records/*.txt`` record under ``root``."""
    history = {}

    def add(rec):
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            history.setdefault(rec["metric"], []).append(rec)

    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            add(doc.get("parsed"))
    for path in sorted(glob.glob(os.path.join(root, "bench", "records",
                                              "*.txt"))):
        for rec in _metric_lines(path):
            add(rec)
    return history


def _number(v):
    return (float(v) if isinstance(v, (int, float))
            and not isinstance(v, bool) else None)


def _value(rec, gate):
    if gate in OBS_GATES:
        return _number((rec.get("obs") or {}).get(gate))
    return _number(rec.get("value"))


def _reference(history_recs, gate):
    """Banding reference for one gate: the median over the history
    entries that carry the number."""
    vals = [v for v in (_value(r, gate) for r in history_recs)
            if v is not None]
    return median(vals) if vals else None


def _verdict(gate, metric, verdict, cur, ref, allowed, history_n):
    return {"v": SCHEMA_VERSION, "schema_version": SCHEMA_VERSION,
            "ts": round(time.time(), 3), "type": "regression",
            "gate": gate, "metric": metric, "verdict": verdict,
            "current": cur, "reference": ref,
            "tolerance": round(allowed, 6) if allowed is not None else None,
            "history_n": history_n}


def check_record(rec, history):
    """Band one fresh metric record against ``history`` ({metric:
    [record, ...]}); returns one schema-valid ``regression`` record per
    gate. Only history records whose ``backend`` equals the fresh
    record's count.

    The value gate depends on the record's unit: seconds-valued lines get
    the UPPER-bounded ``latency`` band; ``unit: "accuracy"`` and ``unit:
    "qps"`` lines the LOWER-bounded ``accuracy``/``throughput`` bands.
    """
    metric = rec.get("metric", "?")
    past = [r for r in history.get(metric, [])
            if r.get("backend") == rec.get("backend")]
    value_gate = _UNIT_GATES.get(rec.get("unit"), "latency")
    verdicts = []
    for gate in (value_gate,) + OBS_GATES:
        cur = _value(rec, gate)
        ref = _reference(past, gate)
        tol, slack = _tolerance(gate)
        if cur is None or ref is None:
            verdict, allowed = "skip", None
        elif gate in _LOWER_BOUNDED:
            allowed = ref * tol - slack
            verdict = "red" if cur < allowed else "green"
        else:
            allowed = ref * tol + slack
            verdict = "red" if cur > allowed else "green"
        verdicts.append(_verdict(gate, metric, verdict, cur, ref, allowed,
                                 len(past)))
    floor = _number(rec.get("vs_baseline_floor"))
    if floor is not None:
        # the history-free lower band of a record's own declared floor
        cur = _number(rec.get("vs_baseline"))
        tol, slack = _tolerance("vs_baseline")
        allowed = floor * tol - slack
        verdicts.append(_verdict(
            "vs_baseline", metric,
            "skip" if cur is None else "red" if cur < allowed else "green",
            cur, floor, allowed, len(past)))
    return verdicts


def check_file(path, root="."):
    """Band every metric line of a fresh record file against the history
    under ``root``. The fresh file's own lines are excluded from the
    history it is judged against (a file inside ``bench/records/`` is
    swept into the scan)."""
    history = load_history(root)
    fresh = _metric_lines(path)
    records_dir = os.path.realpath(os.path.join(root, "bench", "records"))
    if os.path.realpath(path).startswith(records_dir):
        own = {json.dumps(r, sort_keys=True) for r in fresh}
        history = {m: [r for r in recs
                       if json.dumps(r, sort_keys=True) not in own]
                   for m, recs in history.items()}
    verdicts = []
    for rec in fresh:
        verdicts.extend(check_record(rec, history))
    return verdicts


def _selftest_run(device, host, uploads):
    """One fresh obs run of the selftest's fixed work: ``uploads`` tiled
    puts of ``host`` through the streaming engine, every copy kept alive
    until the snapshot, then one product on the device. Returns the run's
    metric record."""
    import torch

    from .. import streaming
    from . import recorder

    recorder.enable()
    try:
        copies = [streaming.streamed_resident_put(
            host, device=device, max_bytes=_SELFTEST_TILE_BYTES)
            for _ in range(uploads)]
        product = copies[0].T @ copies[-1]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        snap = recorder.snapshot()
        del copies, product
    finally:
        recorder.disable()
    return {"metric": "regress_selftest", "value": 0.01, "unit": "s",
            "vs_baseline": 1.0, "backend": port_backend(device), "obs": snap}


def selftest(device=None):
    """The self-test: a REAL injected regression must go red.

    Runs one fixed piece of work under fresh obs runs on ``device`` (None:
    the configured device, which raises where it is a card and CUDA is
    absent, as every entry point does): a
    tiled put of a host array through the streaming engine (which feeds
    ``streaming.transfer_bytes``), then one product on the device. A
    baseline run, an unchanged rerun (green or skip on every gate; on a
    card ``peak_hbm_bytes`` must be measured, not skipped), and a
    "leaked" run that uploads the array twice and keeps both copies
    alive, whose ``total_transfer_bytes`` (and on a card
    ``peak_hbm_bytes``) must go red. ``peak_hbm_bytes`` counts the memory
    already allocated on the card (R) beside the run's upload (A), so the
    leak's R + 2A clears the band 1.25 (R + A) + 1 MiB only when A exceeds
    R / 3 + 4/3 MiB: the array is R / 2 + 2 MiB, and at least 16 MiB.
    Prints one JSON line; returns 0 when the contract held, 1 otherwise.
    """
    import numpy as np
    import torch

    from .._config import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    nbytes = _SELFTEST_BYTES
    if device.type == "cuda":
        nbytes = max(nbytes,
                     torch.cuda.memory_allocated(device) // 2 + (2 << 20))
    rows = -(-nbytes // (4 * _SELFTEST_COLS))
    host = np.ones((rows, _SELFTEST_COLS), np.float32)
    _selftest_run(device, host, 1)  # warm-up: pinned ring, allocator
    baseline = _selftest_run(device, host, 1)
    clean = _selftest_run(device, host, 1)
    leaked = _selftest_run(device, host, 2)

    history = {"regress_selftest": [baseline]}
    clean_v = {v["gate"]: v["verdict"] for v in check_record(clean, history)}
    leaked_v = {v["gate"]: v["verdict"]
                for v in check_record(leaked, history)}
    must_red = ["total_transfer_bytes"]
    if device.type == "cuda":
        must_red.append("peak_hbm_bytes")
    failures = []
    if "red" in clean_v.values():
        failures.append(f"clean rerun went red: {clean_v}")
    if device.type == "cuda" and clean_v["peak_hbm_bytes"] != "green":
        failures.append(f"peak_hbm_bytes on {device} was not measured: "
                        f"{clean_v}")
    for gate in must_red:
        if leaked_v[gate] != "red":
            failures.append(f"the doubled, kept upload did not turn {gate} "
                            f"red: {leaked_v}")
    print(json.dumps({
        "regress_selftest": "fail" if failures else "ok",
        "device": str(device), "bytes": rows * _SELFTEST_COLS * 4,
        "clean": clean_v, "leaked": leaked_v,
        "peak_hbm_bytes": [r["obs"]["peak_hbm_bytes"]
                           for r in (baseline, clean, leaked)],
        "total_transfer_bytes": [r["obs"]["total_transfer_bytes"]
                                 for r in (baseline, clean, leaked)],
        "errors": failures}))
    return 1 if failures else 0


_USAGE = ("usage: python -m sq_learn_tpu_torch.obs regress <record-file> "
          "[--root DIR] [--no-exit-code] | --selftest [--device cpu|cuda]")


def main(argv):
    """``regress <record-file> [--root DIR] [--no-exit-code]`` or
    ``regress --selftest [--device cpu|cuda]`` (no ``--device``: the
    configured device). Prints one regression
    JSONL line per (metric, gate) plus a summary line; exits 1 when any
    verdict is red (unless ``--no-exit-code``, the report-only mode), 2
    on bad usage."""
    import sys

    opts = {"--root": ".", "--device": None}
    flags, paths = set(), []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it, None)
        elif a in ("--no-exit-code", "--selftest"):
            flags.add(a)
        elif a.startswith("-"):
            paths = None  # an unknown option
            break
        else:
            paths.append(a)
    root, device = opts["--root"], opts["--device"]
    if paths is not None and root is not None:
        if "--selftest" in flags and not paths \
                and device in (None, "cpu", "cuda"):
            return selftest(device)
        if "--selftest" not in flags and paths and device is None:
            return _band(paths, root, "--no-exit-code" not in flags)
    print(_USAGE, file=sys.stderr)
    return 2


def _band(paths, root, exit_code):
    verdicts = []
    for p in paths:
        verdicts.extend(check_file(p, root))
    for v in verdicts:
        print(json.dumps(v))
    tally = {"green": 0, "red": 0, "skip": 0}
    for v in verdicts:
        tally[v["verdict"]] += 1
    print(json.dumps({"regression_summary": tally,
                      "metrics": len({v["metric"] for v in verdicts})}))
    return 1 if exit_code and tally["red"] else 0
