"""Timing and roofline utilities (counterpart of
``sq_learn_tpu/utils/profiling.py``).

The reference has no profiling infrastructure beyond ad-hoc ``time.time()``
in scripts; its *theoretical* runtime accountants live on the estimators
(``QPCA.accumulate_q_runtime``, ``QKMeans.quantum_runtime_model``). This
module supplies the real-measurement side:

- :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (CUDA kernels included when a card is present).
- :class:`Timer` — wall-clock scope timer that waits for the card, so
  asynchronous launches don't fake instant results.
- :func:`benchmark` — median-of-repeats timing of a callable after a
  warm-up, synced after every call.
- :func:`lloyd_iter_flops` / :func:`matmul_flops` — FLOP accounting of
  the Lloyd step and the k-nearest search's products, and
  :func:`device_peak_flops` / :func:`mfu` — achieved fraction of the
  card's published peak for the math the work runs in.

The H100 has several peaks where the TPU had one MXU rate, so the peak
and :func:`mfu` take ``math``: ``"fp32"`` (FMAs outside the tensor cores,
what both hand-written kernels run today), ``"tf32"``, ``"bf16"``,
``"fp16"``, ``"fp8"`` or ``"int8"``. A kernel that moves to the tensor
cores names its math, or its share would read above 1.

There is ONE timing discipline: every scope this module times emits
through the run-scoped recorder (:mod:`sq_learn_tpu_torch.obs`) when a
run is active — ``Timer`` scopes land as synced spans, ``benchmark``
results as gauges with a warm-up-vs-execute split, ``mfu`` as the
``profiling.mfu`` gauge (read by ``obs.snapshot()["measured_mfu"]`` and
``python -m sq_learn_tpu_torch.obs report``). With observability off
everything behaves the same at no extra cost.
"""

import os
import time
from contextlib import contextmanager

import torch

from .. import _knobs
from .. import obs as _obs
from .._config import get_config

__all__ = ["CPU_FLOPS_PER_CORE_CYCLE", "GPU_PEAKS", "H100_SXM_HBM_BYTES_PER_S",
           "H100_SXM_PEAK_FLOPS", "MATH", "Timer", "benchmark",
           "device_peak_flops", "host_cpu_peak_flops", "lloyd_iter_flops",
           "matmul_flops", "mfu", "trace"]

#: the math kinds a peak is stated for
MATH = ("fp32", "tf32", "bf16", "fp16", "fp8", "int8")

#: published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
#: sparsity, at its 700 W limit), FLOP/s by math (OP/s for int8); fp32 is
#: the rate outside the tensor cores
H100_SXM_PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                       "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12}
#: its HBM3 rate, bytes/s
H100_SXM_HBM_BYTES_PER_S = 3.35e12

#: card name as ``torch.cuda.get_device_name`` gives it -> peak FLOP/s by
#: math. "NVIDIA H100 80GB HBM3" is the SXM part; the PCIe card has lower
#: peaks and is not listed: another card is another row
GPU_PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM_PEAK_FLOPS,
}


def matmul_flops(m, k, n):
    """FLOPs of an (m, k) @ (k, n) GEMM: one multiply + one add per MAC."""
    return 2.0 * m * k * n


def lloyd_iter_flops(n_samples, n_features, n_clusters):
    """FLOPs of one fused Lloyd iteration: the E-step distance GEMM plus
    the M-step one-hot centroid-sum GEMM (2·n·k·m each). Elementwise work
    (argmin, compares) is excluded — undercounting keeps MFU honest."""
    return (matmul_flops(n_samples, n_features, n_clusters)
            + matmul_flops(n_clusters, n_samples, n_features))


#: f32 FLOPs per core per cycle for the host-CPU peak estimate: two
#: 256-bit FMA ports × 8 lanes × 2 ops — the AVX2 dual-FMA figure. An
#: AVX-512 host's true peak is up to 2× higher, so treat CPU MFU as a
#: roofline orientation, not a utilization claim of record (the gauge is
#: tagged ``cpu_estimate`` for exactly this reason).
CPU_FLOPS_PER_CORE_CYCLE = 32.0


def _host_cpu_hz():
    """Best-effort host clock in Hz from /proc/cpuinfo (first 'cpu MHz'
    line); 2 GHz when unreadable — the estimate only needs to be
    order-correct for a finite MFU statement."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.lower().startswith("cpu mhz"):
                    return float(line.split(":", 1)[1]) * 1e6
    except (OSError, ValueError, IndexError):
        pass
    return 2.0e9


def host_cpu_peak_flops():
    """Estimated peak f32 FLOP/s of THIS host's CPU: cores × clock ×
    :data:`CPU_FLOPS_PER_CORE_CYCLE`, overridable via
    ``SQ_CPU_PEAK_FLOPS``. An estimate (clock read once, no turbo or
    AVX-512 modeling) that lets CPU runs report a finite MFU."""
    env = _knobs.get_raw("SQ_CPU_PEAK_FLOPS")
    if env:
        return float(env)
    return (os.cpu_count() or 1) * _host_cpu_hz() * CPU_FLOPS_PER_CORE_CYCLE


def _check_math(math):
    if math not in MATH:
        raise ValueError(f"math must be one of {MATH}, not {math!r}")


def _describe(device):
    """(platform, name) of ``device``: a tensor, a ``torch.device``, a
    device string, None (the configured device) or a stand-in object
    with ``type`` and ``name``. The name of a card CUDA cannot see is
    None."""
    if device is None:
        device = get_config()["device"]
    if isinstance(device, torch.Tensor):
        device = device.device
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return device.type, device.type
        if not torch.cuda.is_available():
            return "cuda", None
        return "cuda", torch.cuda.get_device_name(device)
    return getattr(device, "type", "unknown"), getattr(device, "name", None)


def device_peak_flops(device=None, math="fp32"):
    """Best-known peak FLOP/s of ``device`` (default: the configured
    device) for work in ``math``.

    A card reads :data:`GPU_PEAKS`, keyed on
    ``torch.cuda.get_device_name``. ``SQ_GPU_PEAK_FLOPS`` overrides the
    ``fp32`` rate only (the rate outside the tensor cores, for a card the
    table does not list or one held below its limit); the tensor-core
    maths keep the table's rates, so work in one math is never priced at
    another's. A CPU device takes the :func:`host_cpu_peak_flops`
    estimate whatever ``math`` is. Returns None for an unknown card (for
    ``fp32`` without the override) — callers then report raw FLOP/s
    without an MFU claim, never a guessed peak.
    """
    _check_math(math)
    platform, name = _describe(device)
    if platform == "cpu":
        return host_cpu_peak_flops()
    env = _knobs.get_raw("SQ_GPU_PEAK_FLOPS")
    if env and math == "fp32":
        return float(env)
    peaks = GPU_PEAKS.get(name)
    return None if peaks is None else peaks[math]


def mfu(flops, seconds, device=None, math="fp32"):
    """Model FLOP utilization: achieved FLOP/s over the card's peak for
    ``math``, recorded as the ``profiling.mfu`` gauge (with ``math``).

    Degrades gracefully: a CPU device falls back to the
    :func:`host_cpu_peak_flops` estimate (finite MFU, gauge tagged
    ``cpu_estimate``); an unknown card (or non-positive ``seconds``)
    returns None and records the gauge tagged ``unknown_chip`` with the
    ``reason``, so the run artifact says *why* there is no utilization
    claim instead of silently omitting one.

    The JAX package's ``site=`` argument, which takes the numerator from
    XLA's cost analysis of a compiled kernel (``obs/xla.py``), has no
    object here: the port compiles nothing, and its FLOPs are the hand
    formulas above.
    """
    _check_math(math)
    peak = device_peak_flops(device, math)
    platform, name = _describe(device)
    if not peak or seconds <= 0:
        _obs.gauge("profiling.mfu", None, unknown_chip=True,
                   device_kind=name or "unknown",
                   reason=("nonpositive_seconds" if peak and seconds <= 0
                           else "unknown_chip"), math=math)
        return None
    attrs = {"math": math}
    if platform == "cpu":
        attrs["cpu_estimate"] = True
    value = (flops / seconds) / peak
    _obs.gauge("profiling.mfu", value, **attrs)
    return value


def _cuda_devices(obj, out):
    """Collect the CUDA devices of the tensors in ``obj`` (nested tuples,
    lists and dict values) into ``out``."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    return out


def _sync(target=None):
    """Wait for the card: the cards of the tensors in ``target`` (a tensor,
    or tuples/lists/dicts of them), or the card ``target`` names (a
    ``torch.device`` or string). With no CUDA tensor or device in
    ``target``, every card this process has touched (the current one and
    those holding memory), once CUDA is initialized. CPU work needs no
    wait."""
    if isinstance(target, (str, torch.device)):
        dev = torch.device(target)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return
    devices = _cuda_devices(target, set())
    if devices:
        for dev in devices:
            torch.cuda.synchronize(dev)
        return
    if torch.cuda.is_initialized():
        current = torch.cuda.current_device()
        for i in range(torch.cuda.device_count()):
            if i == current or torch.cuda.memory_reserved(i):
                torch.cuda.synchronize(i)


class _TraceHandle:
    """What :func:`trace` yields: after the block, ``path`` is the Chrome
    trace's file and ``profile`` the finished ``torch.profiler.profile``."""

    path = None
    profile = None


@contextmanager
def trace(log_dir):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity when a card is present) and write a Chrome trace
    into ``log_dir`` (a ``utils.trace`` span in the obs recorder points at
    it). Yields a handle whose ``path`` names the trace after the block.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handle = _TraceHandle()
    os.makedirs(log_dir, exist_ok=True)
    with _obs.span("utils.trace", log_dir=str(log_dir)):
        with profile(activities=activities) as prof:
            try:
                yield handle
            finally:
                _sync()
        handle.profile = prof
        handle.path = os.path.join(
            str(log_dir), f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(handle.path)


class Timer:
    """Wall-clock scope timer that waits for the card.

    ``sync`` says what to wait for at the end of the scope (see
    :func:`_sync`): a tensor or a device, or None for every card this
    process has touched. When an obs run is active the scope also lands
    as a synced span (name from the ``name`` argument, default
    ``"utils.Timer"``).

    >>> with Timer() as t:
    ...     out = step(...)  # doctest: +SKIP
    >>> t.elapsed  # doctest: +SKIP
    """

    def __init__(self, sync=None, name=None):
        self._sync = sync
        self.name = name
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self._sync)
        self.elapsed = time.perf_counter() - self._t0
        _obs.record_span(self.name or "utils.Timer", self.elapsed)
        return False


def benchmark(fn, *args, repeats=5, warmup=1, name=None, **kwargs):
    """Median wall-clock of ``fn(*args, **kwargs)``, waiting for the card
    after every call (on the cards of its output's tensors, else on every
    card this process has touched).

    Runs ``warmup`` untimed calls first (kernel builds, allocator and
    caches), then ``repeats`` timed ones. Returns (median_seconds,
    all_times). With an obs run active, records the split as gauges: the
    warm-up wall-clock and the timed median, under
    ``benchmark.<name>.{warmup_s,median_s}``.
    """
    t0 = time.perf_counter()
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    median = times[len(times) // 2]
    if _obs.enabled():
        label = name or getattr(fn, "__name__", "fn")
        _obs.gauge(f"benchmark.{label}.warmup_s", round(warmup_s, 6),
                   warmup_calls=warmup)
        _obs.gauge(f"benchmark.{label}.median_s", round(median, 6),
                   repeats=repeats)
    return median, times
