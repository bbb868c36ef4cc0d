"""Deterministic fault-injection harness (counterpart of
``sq_learn_tpu/resilience/faults.py``).

Every failure mode the transfer supervisor, the circuit breaker and the
resumable streamed passes exist for is reproducible here, deterministically
and on the CPU: transfer failures and stalls, NaN-corrupted tiles,
mid-pass interrupts and probe timeouts. The grammar, the injectors and
their draws are the JAX package's, so the same ``SQ_FAULTS`` spec fails
the same tiles in both packages.

Arming
------
``SQ_FAULTS=<spec>`` arms the harness at import; :func:`arm`/:func:`disarm`
do it programmatically. With nothing armed the hot-path hooks are a single
module-attribute read (``_active is None``).

Spec grammar
------------
``spec    := fault (";" fault)*``
``fault   := kind [":" param ("," param)*]``
``param   := key "=" value``

Kinds and their params (every param optional unless noted):

``put_fail``
    Transient transfer failure: raises :class:`InjectedTransferError` from
    the supervisor's put path. ``tiles=a/b/c`` (explicit tile indices) or
    ``p=0.25`` (per-tile probability, drawn from ``seed``); ``times=N`` —
    each selected tile fails its first N attempts, then succeeds.
``put_stall``
    Transfer stall: sleeps ``s=0.25`` seconds inside the supervised
    (timed) put, so a per-tile deadline shorter than ``s`` sees a timeout.
``nan``
    Tile corruption: the selected host tile is NaN-poisoned before its
    upload — the failure ``SQ_RESILIENCE_STRICT=1`` catches with tile
    provenance. A selected integer tile records a skipped injection.
``abort``
    Mid-pass interrupt: raises :class:`InjectedInterrupt` at the tile
    boundary ``tile=K`` (before that tile stages), ``times=N`` (default 1)
    — the shape the resumable-pass checkpoints recover from.
``probe_timeout``
    The next ``n=1`` device-health probes report ``"timeout"`` without
    touching the device — feeds the circuit breaker the wedge signal.
``read_fail``, ``read_stall``, ``corrupt_shard``, ``cold_tier``
    The shard-store kinds, fired from every shard read of
    :mod:`sq_learn_tpu_torch.oocore` (on prefetch workers too):
    ``read_fail`` raises :class:`InjectedReadError` and ``read_stall``
    sleeps inside the supervised read (:meth:`FaultPlan.on_read`);
    ``cold_tier`` sleeps ``s`` plus ``per_mb`` × the stored MiB, first
    touch only by default (:meth:`~FaultPlan.on_cold`); ``corrupt_shard``
    flips bytes of the read payload, which the manifest CRC catches
    (:meth:`~FaultPlan.corrupt_read`). ``tiles=`` selects shards.
``host_fail``, ``host_stall``
    The elastic-mesh kinds (:meth:`FaultPlan.host_event`); no caller until
    the mesh (item 6).

Example: ``SQ_FAULTS="put_fail:tiles=2,times=1;probe_timeout:n=2"``.

Determinism: probabilistic selection (``p=``) draws from a splitmix64 hash
of ``(seed, tile_index, injector_index)`` — no global generator, the same
spec injects the same faults on every run and in both packages.
"""

import threading
import time
from .. import _knobs

__all__ = [
    "FaultPlan",
    "FaultSpecError",
    "InjectedFault",
    "InjectedInterrupt",
    "InjectedReadError",
    "InjectedTransferError",
    "active",
    "arm",
    "disarm",
    "get_plan",
]

_KINDS = ("put_fail", "put_stall", "nan", "abort", "probe_timeout",
          "read_fail", "read_stall", "corrupt_shard", "cold_tier",
          "host_fail", "host_stall")


class FaultSpecError(ValueError):
    """Malformed ``SQ_FAULTS`` spec."""


class InjectedFault(RuntimeError):
    """Base of every injected failure (so tests and the smoke can catch
    'anything this harness raised' without masking real bugs)."""


class InjectedTransferError(InjectedFault):
    """A transient device_put failure (the supervisor retries these)."""


class InjectedReadError(InjectedTransferError):
    """A transient shard-read failure (retried exactly like a transfer
    failure — the supervisor's transient classification is shared)."""


class InjectedInterrupt(InjectedFault):
    """A mid-pass interrupt at a tile boundary (resume recovers these)."""


def _u01(seed, *salt):
    """Deterministic uniform in [0, 1) via splitmix64 over (seed, salt) —
    keyed like the rest of the codebase, no global generator."""
    x = (int(seed) & 0xFFFFFFFFFFFFFFFF) or 0x9E3779B97F4A7C15
    for s in salt:
        x = (x + 0x9E3779B97F4A7C15 + (int(s) << 1)) & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x / 2.0 ** 64


class _Injector:
    """One parsed fault clause with its countdown state."""

    def __init__(self, index, kind, params):
        self.index = index
        self.kind = kind
        self.tiles = params.pop("tiles", None)
        # window= is the elastic-mesh spelling of tile= (the host hooks'
        # tile index is a fold-window index)
        win = params.pop("window", None)
        self.tile = params.pop("tile", win)
        self.host = params.pop("host", None)
        self.p = params.pop("p", None)
        self.times = params.pop("times", 1)
        self.seed = params.pop("seed", 0)
        self.stall_s = params.pop("s", 0.25 if kind != "cold_tier"
                                  else 0.05)
        self.per_mb = params.pop("per_mb", 0.0)
        self.count = params.pop("n", 1)
        if params:
            raise FaultSpecError(
                f"unknown param(s) {sorted(params)} for fault {kind!r}")
        #: per-tile remaining-failure countdowns (transient faults succeed
        #: once their countdown is spent). Guarded by a lock: the prefetch
        #: layer fires read-side injectors from worker threads, and a
        #: ``times=N`` countdown must spend exactly N injections no matter
        #: which thread asks (the stall sleeps themselves stay unlocked —
        #: concurrent stalls must overlap like concurrent reads do)
        self._remaining = {}
        self._lock = threading.Lock()

    def matches(self, tile_index):
        if self.tiles is not None:
            if tile_index not in self.tiles:
                return False
        elif self.tile is not None:
            if tile_index != self.tile:
                return False
        elif self.p is not None:
            if _u01(self.seed, tile_index, self.index) >= self.p:
                return False
        with self._lock:
            rem = self._remaining.setdefault(tile_index, self.times)
            if rem <= 0:
                return False
            self._remaining[tile_index] = rem - 1
            return True

    def consume(self):
        """Countdown for tile-free injectors (probe_timeout)."""
        with self._lock:
            if self.count <= 0:
                return False
            self.count -= 1
            return True


def _parse_value(key, raw):
    if key == "tiles":
        return frozenset(int(t) for t in raw.split("/"))
    if key in ("tile", "times", "seed", "n", "host", "window"):
        return int(raw)
    if key in ("p", "s", "per_mb"):
        return float(raw)
    raise FaultSpecError(f"unknown fault param {key!r}")


def parse_spec(spec):
    """Parse an ``SQ_FAULTS`` spec string into injectors (see the module
    docstring for the grammar). Raises :class:`FaultSpecError` on any
    malformed clause — an unparseable fault plan must fail loudly, not arm
    partially."""
    injectors = []
    for i, clause in enumerate(filter(None,
                                      (c.strip() for c in spec.split(";")))):
        kind, _, rest = clause.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (known: {', '.join(_KINDS)})")
        params = {}
        if rest.strip():
            for item in rest.split(","):
                key, sep, val = item.partition("=")
                if not sep:
                    raise FaultSpecError(
                        f"fault param {item!r} is not key=value")
                try:
                    params[key.strip()] = _parse_value(key.strip(),
                                                       val.strip())
                except ValueError as exc:
                    raise FaultSpecError(
                        f"bad value for {key.strip()!r}: {exc}") from None
        injectors.append(_Injector(i, kind, params))
    if not injectors:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return injectors


class FaultPlan:
    """The armed injector set plus an event log of every injection.

    The hooks below are only ever called when a plan is armed (the call
    sites read the module global first), so nothing here needs a fast
    path. Every injection is appended to :attr:`events` and — when a
    recorder is active — recorded as a ``fault`` JSONL record, so a
    fault-injected run's artifact says exactly what was done to it.
    """

    def __init__(self, spec):
        self.spec = spec
        self.injectors = parse_spec(spec)
        self.events = []

    def _record(self, kind, tile, **fields):
        ev = dict({"kind": kind, "tile": tile}, **fields)
        self.events.append(ev)
        from ..obs import recorder

        rec = recorder.get_recorder()
        if rec is not None:
            rec.record(dict(ev, type="fault"), kind="fault_events")

    def _by_kind(self, kind):
        return (inj for inj in self.injectors if inj.kind == kind)

    def on_tile(self, tile_index):
        """Tile-boundary hook (before the tile stages): mid-pass abort."""
        for inj in self._by_kind("abort"):
            if inj.matches(tile_index):
                self._record("abort", tile_index)
                raise InjectedInterrupt(
                    f"injected mid-pass interrupt at tile {tile_index}")

    def on_put(self, tile_index):
        """Pre-put hook inside the supervisor's timed attempt: transient
        failures raise, stalls sleep (so the attempt's wall-clock crosses
        the per-tile deadline)."""
        for inj in self._by_kind("put_stall"):
            if inj.matches(tile_index):
                self._record("put_stall", tile_index, stall_s=inj.stall_s)
                time.sleep(inj.stall_s)
        for inj in self._by_kind("put_fail"):
            if inj.matches(tile_index):
                self._record("put_fail", tile_index)
                raise InjectedTransferError(
                    f"injected transient transfer failure at tile "
                    f"{tile_index}")

    def on_read(self, shard_index):
        """Pre-read hook inside the supervisor's timed read attempt
        (disk-side twin of :meth:`on_put`): stalls sleep, transient
        failures raise."""
        for inj in self._by_kind("read_stall"):
            if inj.matches(shard_index):
                self._record("read_stall", shard_index, stall_s=inj.stall_s)
                time.sleep(inj.stall_s)
        for inj in self._by_kind("read_fail"):
            if inj.matches(shard_index):
                self._record("read_fail", shard_index)
                raise InjectedReadError(
                    f"injected transient shard-read failure at shard "
                    f"{shard_index}")

    def on_cold(self, shard_index, nbytes):
        """Cold-tier latency hook inside the supervised timed read
        attempt: selected shards sleep the configured per-shard profile
        (``s`` base latency + ``per_mb`` x stored MiB). First-touch by
        default (``times=1``): the cold read pays the tier, re-reads are
        warm."""
        for inj in self._by_kind("cold_tier"):
            if inj.matches(shard_index):
                delay = inj.stall_s + inj.per_mb * (int(nbytes) / 2**20)
                self._record("cold_tier", shard_index,
                             stall_s=round(delay, 6))
                time.sleep(delay)

    def corrupt_read(self, arr, shard_index):
        """Flip the first bytes of a materialized shard (returns the
        array, corrupted or not) — the payload the manifest-CRC check
        must catch. Byte-level, so any dtype corrupts."""
        import numpy as np

        for inj in self._by_kind("corrupt_shard"):
            if inj.matches(shard_index):
                self._record("corrupt_shard", shard_index)
                arr = np.array(arr, copy=True)
                view = arr.view(np.uint8).reshape(-1)
                view[:8] ^= 0xFF
        return arr

    def corrupt(self, tile, tile_index):
        """NaN-poison the selected tiles' payload (returns the tile,
        corrupted or not). Integer tiles cannot hold NaN — a selected
        non-float tile records a skipped injection instead of crashing
        the supervised put from inside the harness."""
        import numpy as np

        for inj in self._by_kind("nan"):
            if inj.matches(tile_index):
                if not np.issubdtype(np.asarray(tile).dtype, np.floating):
                    self._record("nan", tile_index,
                                 skipped="non-float dtype")
                    continue
                self._record("nan", tile_index)
                tile = np.array(tile, copy=True)
                tile.reshape(-1)[:1] = np.nan
        return tile

    def host_event(self, window_index, host_id):
        """Elastic-mesh hook at a fold-window boundary: the first armed
        ``host_fail``/``host_stall`` clause targeting ``host_id`` at this
        window wins — returns ``("fail", 0.0)`` or ``("stall", s)``, else
        None. The host filter runs BEFORE the tile countdown so a
        ``host=H`` clause spends no countdown on other hosts' queries."""
        for inj in self._by_kind("host_fail"):
            if ((inj.host is None or inj.host == int(host_id))
                    and inj.matches(window_index)):
                self._record("host_fail", window_index, host=int(host_id))
                return ("fail", 0.0)
        for inj in self._by_kind("host_stall"):
            if ((inj.host is None or inj.host == int(host_id))
                    and inj.matches(window_index)):
                self._record("host_stall", window_index,
                             host=int(host_id), stall_s=inj.stall_s)
                return ("stall", inj.stall_s)
        return None

    def on_probe(self):
        """Probe hook: a forced outcome string, or None to probe for
        real."""
        for inj in self._by_kind("probe_timeout"):
            if inj.consume():
                self._record("probe_timeout", None)
                return "timeout"
        return None


#: the armed plan, or None — hot paths read this one attribute and do
#: nothing else when it is None (the zero-overhead contract)
_active = None


def active():
    """True when a fault plan is armed."""
    return _active is not None


def get_plan():
    """The armed :class:`FaultPlan`, or None."""
    return _active


def arm(spec):
    """Arm a fault plan from a spec string; returns the plan. Re-arming
    replaces the previous plan (countdown state does not carry over)."""
    global _active
    _active = FaultPlan(spec)
    return _active


def disarm():
    """Disarm; returns the previous plan (its event log stays readable)."""
    global _active
    plan, _active = _active, None
    return plan


# SQ_FAULTS=<spec> arms at first import, mirroring SQ_OBS=1 — a subprocess
# (bench config, CI smoke) opts into faults purely through its environment.
_env_spec = _knobs.get_raw("SQ_FAULTS")
if _env_spec:
    arm(_env_spec)
