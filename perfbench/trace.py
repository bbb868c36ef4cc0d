"""The traced run's reading of the device: ``torch.profiler`` over the
measured window, reduced to what the per-layer readers need.

- busy: the union of the device's kernel, copy and set intervals inside the
  window range (``perfbench.window``), and the window's length;
- per profiler range (``perfbench.<function>``, the benchmark's own
  wrappers): the device seconds of every kernel, copy or set that a call
  inside one of its ranges launched (each joined to its CUDA runtime
  launch by correlation id, which holds also for kernels a library
  launches through its own runtime);
- the breakdown: the ten device operations that took most time, and the
  idle time between device intervals summed by what the host was doing at
  each gap's middle (the innermost host event open there, or "host").

The busy and idle arithmetic is that of ``chip_profile.py``'s
``_intervals`` and ``_length``, on the profiler's events instead of an
exported trace.
"""

import bisect
import collections

import torch

WINDOW = "perfbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


class Session:
    """A profiler over the device and the host for one window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.range.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self):
        return summarize(self.prof.profiler.kineto_results.events())


def _merged(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _is_host(ev):
    return ev.device_type() == torch.autograd.DeviceType.CPU


def activity(ev):
    """The event's kineto activity type: the profiler's own where it
    exposes it, else told from the device and the name (CUDA runtime and
    driver calls start with "cuda" or "cu" and a capital)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    name = ev.name()
    if _is_host(ev):
        if name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper()):
            return "cuda_runtime"
        return "cpu_op"
    if name.startswith("perfbench."):
        return "gpu_user_annotation"
    if "memcpy" in name.lower():
        return "gpu_memcpy"
    if "memset" in name.lower():
        return "gpu_memset"
    return "kernel"


def _records(events):
    """(device events, host events, window) of a list of profiler events,
    each event read once into (kind, name, start ns, end ns, correlation
    id): a profiler's events are read through one binding call a field,
    which is what a long window's reading costs."""
    window = None
    host, device = [], []
    for ev in events:
        kind = activity(ev)
        if kind in DEVICE_ACTIVITIES:
            device.append((kind, ev.name(), ev.start_ns(), ev.end_ns(),
                           ev.correlation_id()))
        elif _is_host(ev):
            rec = (kind, ev.name(), ev.start_ns(), ev.end_ns(),
                   ev.correlation_id())
            if rec[1] == WINDOW:
                window = (rec[2], rec[3])
            host.append(rec)
    return device, host, window


def summarize(events):
    """The window's device reading from a list of profiler events (see the
    module docstring). Returns a dict with ``busy_s``, ``window_s``,
    ``range_device_s`` {range name: seconds}, ``range_calls`` {range name:
    count}, ``device_ops`` and ``idle_gaps`` ([name, seconds] lists)."""
    device, host, window = _records(events)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1 = window
    inside = [ev for ev in device if ev[3] > w0 and ev[2] < w1]
    busy = _merged([(max(ev[2], w0), min(ev[3], w1)) for ev in inside])
    busy_ns = sum(b - a for a, b in busy)

    # each device event's launch: the CUDA runtime call of the same
    # correlation id; a call's device time is that of every device event
    # launched while one of its ranges was open
    launch_at = {ev[4]: ev[2] for ev in host
                 if ev[0] in LAUNCH_ACTIVITIES}
    ranges = collections.defaultdict(list)
    for ev in host:
        if ev[1].startswith("perfbench.") and ev[1] != WINDOW:
            ranges[ev[1]].append((ev[2], ev[3]))
    range_device_s, range_calls = {}, {}
    for name, spans in ranges.items():
        spans.sort()
        starts = [a for a, _ in spans]
        total = 0
        for ev in inside:
            t = launch_at.get(ev[4])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += ev[3] - ev[2]
        range_device_s[name] = total / 1e9
        range_calls[name] = len(spans)

    by_op = collections.Counter()
    for ev in inside:
        by_op[ev[1]] += ev[3] - ev[2]
    device_ops = [[name, ns / 1e9] for name, ns in by_op.most_common(10)]

    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = collections.Counter()
    spans = sorted((ev[2], ev[3], ev[1]) for ev in host
                   if ev[1] != WINDOW and ev[3] > ev[2])
    # innermost open host event at each gap's middle: the latest-starting
    # event that contains it, scanned with a stack of open events
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    stack, j = [], 0
    for mid, length in mids:
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else "host"] += length
    idle_gaps = [[name, ns / 1e9] for name, ns in idle.most_common(10)]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "range_device_s": range_device_s, "range_calls": range_calls,
            "device_ops": device_ops, "idle_gaps": idle_gaps,
            "device_events": len(inside)}
