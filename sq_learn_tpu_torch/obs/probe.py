"""Device-health probe: the subprocess-with-timeout device check, measured,
cached and fault-injectable (counterpart of ``sq_learn_tpu/obs/probe.py``).

A process whose CUDA context is wedged cannot ask that context whether it
is healthy, so the probe initializes CUDA in a throwaway subprocess under
a timeout: ``import torch``, create a tensor on the card, synchronize.
Every probe lands as a ``probe`` JSONL record plus ``probe.latency_s`` /
``probe.ok`` gauges when a recorder is active.

Three hooks ride on top of the measurement, as in the JAX package:

- **TTL cache** (``SQ_PROBE_TTL_S``, default 300 s): a result younger than
  the TTL for the same platform is reused, in-process through a module
  global and across processes through a small JSON file
  (``SQ_PROBE_CACHE``, default ``sq_probe_cache.json`` in the temporary
  directory). A cached answer is recorded with ``cached: true`` and never
  re-feeds the breaker. ``force=True`` bypasses the cache: the breaker's
  half-open trial (:func:`sq_learn_tpu_torch.resilience.supervisor.
  _probe_device`) must see a fresh probe.
- **Breaker feed**: every fresh outcome goes to
  :data:`sq_learn_tpu_torch.resilience.supervisor.breaker`; a timeout or an
  error counts toward its trip threshold like a failed transfer.
- **Fault injection**: an armed ``probe_timeout`` injector
  (:mod:`sq_learn_tpu_torch.resilience.faults`) forces the outcome
  without spawning a subprocess, so the breaker's behaviour under a wedge
  is testable on the CPU.

Outcomes: ``"ok"`` (the subprocess reached the card within the timeout),
``"timeout"`` (it did not), ``"error"`` (CUDA init failed fast: no card
or no CUDA runtime), ``"cpu"`` (the platform under test is the host CPU:
nothing to probe), ``"skipped"`` (no platform given).

Standard library only: importing this module loads no torch.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

from .. import _knobs

__all__ = ["last_probe", "probe_device", "probe_ttl_s"]

#: last probe result in this process (outcome, latency_s, platform)
last_probe = None

#: monotonic timestamp of the last FRESH (non-cached) probe, for the TTL
_last_probe_t = None

#: what the probe's subprocess runs on ``{platform}``: CUDA init, one
#: allocation and one synchronize on the card
_PROBE_CODE = ("import torch; d = torch.device({platform!r}); "
               "torch.ones(1, device=d).sum().item(); "
               "torch.cuda.synchronize(d)")


def probe_ttl_s():
    """TTL of a cached probe result (``SQ_PROBE_TTL_S``; 0 disables
    caching)."""
    return _knobs.get_float("SQ_PROBE_TTL_S")


def _cache_path():
    return _knobs.get_raw(
        "SQ_PROBE_CACHE",
        os.path.join(tempfile.gettempdir(), "sq_probe_cache.json"))


def _cache_read(platform):
    """A fresh-enough cached result for ``platform`` from the cross-process
    cache file, or None (an unreadable, stale or foreign file is a
    miss)."""
    try:
        with open(_cache_path()) as fh:
            ent = json.load(fh)
        if (ent.get("platform") == platform
                and isinstance(ent.get("ts"), (int, float))
                and time.time() - ent["ts"] < probe_ttl_s()
                and isinstance(ent.get("outcome"), str)):
            return ent
    except (OSError, ValueError, AttributeError):
        pass
    return None


def _cache_write(outcome, latency_s, platform):
    """Persist a fresh result for sibling processes: a unique temporary
    file, fsynced, then renamed over the cache, so a concurrent reader
    only ever sees a whole document. A full disk must not break the
    probe."""
    try:
        path = _cache_path()
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".",
            prefix=os.path.basename(path) + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"outcome": outcome,
                           "latency_s": round(latency_s, 3),
                           "platform": platform,
                           "ts": round(time.time(), 3)}, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            os.unlink(tmp)
            raise
    except OSError:
        pass


def _record(outcome, latency_s, platform, cached=False):
    global last_probe, _last_probe_t
    last_probe = {"outcome": outcome, "latency_s": round(latency_s, 3),
                  "platform": platform}
    if not cached:
        _last_probe_t = time.monotonic()
    from . import recorder

    rec = recorder.get_recorder()
    if rec is not None:
        ev = dict(last_probe, type="probe")
        if cached:
            ev["cached"] = True
        rec.record(ev, kind="probe_events")
        recorder.gauge("probe.latency_s", round(latency_s, 3))
        # "skipped"/"cpu" are healthy outcomes: nothing to probe ≠ failure
        recorder.gauge("probe.ok", outcome in ("ok", "cpu", "skipped"))
    if not cached:
        # fresh outcomes feed the circuit breaker (a cached answer carries
        # no new health information)
        from ..resilience.supervisor import breaker

        breaker.on_probe(outcome)
    return dict(last_probe, cached=True) if cached else last_probe


def probe_device(timeout_s=60, platform="cuda", force=False):
    """Initialize CUDA on ``platform`` (a device string such as ``"cuda"``
    or ``"cuda:1"``) in a throwaway subprocess and report, never raise,
    the outcome with its measured latency:
    ``{"outcome", "latency_s", "platform"}``.

    A ``cpu`` platform and an empty one record without spawning. A result
    younger than ``SQ_PROBE_TTL_S`` for the same platform comes from the
    cache (``cached: true``) unless ``force=True``; an armed
    ``probe_timeout`` injector forces the outcome without spawning.
    """
    platform = str(platform or "")
    if platform.split(":")[0].strip() == "cpu":
        return _record("cpu", 0.0, platform)
    if platform == "":
        return _record("skipped", 0.0, platform)
    if not force:
        if (last_probe is not None and _last_probe_t is not None
                and last_probe["platform"] == platform
                and time.monotonic() - _last_probe_t < probe_ttl_s()):
            return _record(last_probe["outcome"], last_probe["latency_s"],
                           platform, cached=True)
        ent = _cache_read(platform)
        if ent is not None:
            return _record(ent["outcome"], ent.get("latency_s", 0.0),
                           platform, cached=True)
    from ..resilience import faults as _faults

    if _faults._active is not None:
        forced = _faults._active.on_probe()
        if forced is not None:
            return _record(forced,
                           float(timeout_s) if forced == "timeout" else 0.0,
                           platform)
    t0 = time.perf_counter()
    try:
        subprocess.run(
            [sys.executable, "-c", _PROBE_CODE.format(platform=platform)],
            timeout=timeout_s, check=True, capture_output=True)
        outcome = "ok"
    except subprocess.TimeoutExpired:
        outcome = "timeout"
    except (subprocess.CalledProcessError, OSError):
        outcome = "error"
    latency = time.perf_counter() - t0
    _cache_write(outcome, latency, platform)
    return _record(outcome, latency, platform)
