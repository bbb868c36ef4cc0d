"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the judge, and the result line.

Everything a cell needs is found by name: its configuration's file (the
entry's ``file``) and the recipe it names (``data/<recipe>.py``),
``traffic/<traffic>.json`` and the job it names (``jobs/<job>.py``),
``limits/<cell>.json`` and, for each metric, ``metrics/<metric>.py``,
whose ``read(ctx)`` returns a number, ``{"value", "note"}``, or None when
the run has nothing for it.
"""

import contextlib
import gc
import json
import os
import sys
import time
import traceback
import types
import warnings

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: what a compared number reads when there is nothing to compare (a
#: missing answer, an index out of range): the largest float, over any limit
NO_READING = sys.float_info.max
#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "sq_learn_tpu")


class NoCard(RuntimeError):
    """The machine has fewer CUDA devices than the cell asks for."""


class Forbidden(RuntimeError):
    """The process holds a module of the JAX stack or of the JAX package."""


def _json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def _entry(spec, key, name):
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")


def load_cell(workload, root=ROOT):
    """(cell entry, configuration, traffic, limits, spec) of a workload."""
    spec = _json(root, "BENCHMARK.json")
    cell = _entry(spec, "workloads", workload)
    conf_entry = _entry(spec, "configs", cell["config"])
    config = _json(root, conf_entry["file"])
    traffic = _json(BENCH, "traffic", f"{cell['traffic']}.json")
    limits = _json(BENCH, "limits", f"{workload}.json")
    return cell, config, traffic, limits, spec


def cell_metrics(spec, workload, trace):
    """The metric entries a run of ``workload`` reports: the end-to-end ones
    with ``trace`` 0, the per-layer ones with ``trace`` 1; an entry with a
    ``workloads`` key applies to the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    from . import named

    return named.load("metrics", name).read


def forbidden_modules():
    """Top-level names in ``sys.modules`` that a run may not hold, compared
    whole (``sq_learn_tpu_torch`` is not ``sq_learn_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def check_card(chips):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def run(workload, seed, seconds, trace, *, impl="program", device=None,
        started=None, config_overrides=None, traffic_overrides=None,
        log=print, judged_out=None):
    """Run the cell once; returns the result dict (the last line's object).

    ``device`` None means the card, checked first (:class:`NoCard` without
    one). Tests pass a CPU device and small ``config_overrides`` /
    ``traffic_overrides``; ``impl="control"`` puts the plain reference,
    with TF32 products, in the program's place. ``judged_out``, a dict,
    receives every number the judge read, compared or not.
    """
    started = time.perf_counter() if started is None else started
    cell, config, traffic, limits, spec = load_cell(workload)
    config = {**config, **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    if device is None:
        check_card(cell["chips"])
        device = "cuda:0"
    import torch

    from . import data as bench_data
    from . import jobs, peaks
    from . import trace as bench_trace

    device = torch.device(device)
    on_card = device.type == "cuda"
    warnings.simplefilter("ignore")
    rows = bench_data.make(config, device)
    job = jobs.make(config, traffic, rows, seed, device, impl=impl,
                    traced=bool(trace))
    job.warm(traffic["warm_requests"])
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started
    for rec in job.recorders.values():  # the window's calls alone
        rec.calls.clear()

    gc.collect()
    gc.freeze()
    latencies, failed, attempted = [], 0, 0
    session = bench_trace.Session() if trace else contextlib.nullcontext()
    with session:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            attempted += 1
            a = time.perf_counter()
            try:
                job.request(attempted - 1)
            except Exception:  # a failed request is counted and reported
                failed += 1
                if failed == 1:
                    traceback.print_exc()
            end = time.perf_counter()
            latencies.append(end - a)
            if end >= deadline:
                break
    window_s = end - t0
    summary = None
    if trace:
        read_t = time.perf_counter()
        summary = session.summary()
        summary["read_s"] = time.perf_counter() - read_t
    del session
    gc.unfreeze()
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    calls = {name: rec.read_calls() for name, rec in job.recorders.items()}
    work = job.work()
    job.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    judge_t = time.perf_counter()
    numbers, judged = job.judge()
    judge_s = time.perf_counter() - judge_t
    checks = {}
    for name, limit in limits["limits"].items():
        value = numbers.get(name, NO_READING)
        if not value <= NO_READING:  # inf or nan: nothing to compare
            value = NO_READING
        checks[name] = {"value": value, "limit": limit}
    correct = (failed == 0 and judged > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    device_kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = types.SimpleNamespace(
        kind=job.kind, work=work, latencies=latencies, window_s=window_s,
        setup_s=setup_s, trace=summary, calls=calls,
        peaks=peaks.peaks_for(device_kind) if on_card else None)
    metrics, notes = {}, {}
    for entry in cell_metrics(spec, workload, trace):
        got = reader(entry["name"])(ctx)
        if isinstance(got, dict):
            notes[entry["name"]] = got["note"]
            got = got["value"]
        if got is not None:
            metrics[entry["name"]] = {"value": got, "unit": entry["unit"]}
    device_out = {"platform": "gpu" if on_card else "cpu",
                  "kind": device_kind, "count": 1 if on_card else 0,
                  "memory_peak_bytes": memory_peak}
    if summary is not None:
        device_out["busy_s"] = summary["busy_s"]
        device_out["window_s"] = summary["window_s"]

    if on_card:
        log(f"card: {_power_limit()}; peaks {ctx.peaks}")
    log(f"run: {workload} seed {seed} impl {impl} trace {trace}: "
        f"set-up {setup_s:.4f} s, window {window_s:.4f} s, "
        f"{attempted} requests, {failed} failed, judge {judge_s:.4f} s "
        f"over {judged} sampled answers")
    log(f"judged (worst over the sample): {numbers}")
    if work and "n_iter" in work[0]:
        log(f"n_iter: {[w['n_iter'] for w in work]}")
    launches = _launches()
    if launches:
        log(f"launches: {launches}")
    for name, note in notes.items():
        log(f"{name}: {note}")
    if summary is not None:
        log(f"trace: read in {summary['read_s']:.3f} s (after "
            f"{time.perf_counter() - started:.3f} s of the run), "
            f"{summary['device_events']} device events, range "
            f"device seconds {summary['range_device_s']}, calls "
            f"{summary['range_calls']}")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_out}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if judged_out is not None:
        judged_out.update(numbers)
    result["checks"] = checks
    return result


def _launches():
    """The program's kernel launch counters, if its kernels module is
    loaded."""
    kernels = sys.modules.get("sq_learn_tpu_torch.ops.kernels")
    if kernels is None:
        return None
    return {"lloyd_step": kernels.lloyd_step.launches,
            "argkmin": kernels.argkmin.launches,
            "argkmin_by_shape": dict(kernels.argkmin.by_shape)}


def finish(result, out=None, err=None):
    """Check the process for forbidden modules (:class:`Forbidden`), then
    print each compared number beside its limit as the last lines on
    standard error, and the result as the last line on standard
    output."""
    out, err = out or sys.stdout, err or sys.stderr
    found = forbidden_modules()
    if found:
        raise Forbidden(f"the run's process holds {found}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err,
              flush=True)
    print(json.dumps(result), file=out, flush=True)
