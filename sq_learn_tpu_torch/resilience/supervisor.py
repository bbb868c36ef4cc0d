"""Transfer supervisor: bounded retries, keyed backoff, per-tile deadlines
and the probe-fed circuit breaker (counterpart of
``sq_learn_tpu/resilience/supervisor.py``).

Every host→device tile of the streaming engine goes through :func:`put`;
:func:`supervised_read` is its disk-side twin for the shard stores. The
contract, in failure order, is the JAX package's:

1. **Retry with backoff.** A transient failure (an injected
   :class:`~.faults.InjectedTransferError`, an ``OSError``, or a
   ``RuntimeError`` that is not an out-of-memory error, see
   :func:`_is_transient`) is retried up to ``SQ_RETRY_MAX`` times with
   backoff ``SQ_RETRY_BACKOFF_S · 2^attempt`` times a keyed jitter in
   [1, 2) (splitmix64 over ``SQ_RETRY_SEED``, tile and attempt).
2. **Per-tile deadline.** An attempt that takes longer than
   ``SQ_TILE_DEADLINE_S`` returns its result but counts as a timeout
   against the breaker.
3. **Circuit breaker.** ``SQ_BREAKER_K`` consecutive failures or timeouts
   trip it: the transition is recorded (a ``breaker`` record and the
   ``resilience.breaker_state`` gauge under an obs run). After
   ``SQ_BREAKER_COOLDOWN_S`` it half-opens; :meth:`CircuitBreaker.preflight`
   (called at the entry of every streamed fit) then probes the device
   afresh, and a healthy outcome closes it while a failed one re-opens it.

**Where the port departs, by its ground rules.** The JAX breaker trips
into an in-process CPU escape (it re-pins ``jax_platforms`` to the CPU),
a fallback that hides the device. Here nothing moves work to the CPU:
while the breaker is ``open``, a supervised put and ``preflight`` raise
:class:`BreakerOpenError`, which names the site and the transition that
opened it. The half-open trial (:func:`_probe_device`) calls the
device-health probe (:func:`sq_learn_tpu_torch.obs.probe.probe_device`)
with ``force=True``, as the JAX breaker does: a fresh subprocess
initializes CUDA on the device under ``SQ_TILE_DEADLINE_S``, and its
outcome feeds this breaker.

With no faults armed and the breaker closed, :func:`put` is one
``perf_counter`` pair around the raw put on success; failure handling is
never skipped.
"""

import threading
import time

from .. import _knobs
from . import faults as _faults
from .faults import InjectedFault, InjectedTransferError, _u01

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "BreakerOpenError",
    "CircuitBreaker",
    "NonFiniteAccumulatorError",
    "backoff_delay",
    "breaker",
    "put",
    "supervised_read",
]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: message markers of deterministic backend RuntimeErrors: an allocation
#: that failed once fails on every retry
_NON_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory",
                          "Out of memory")


class NonFiniteAccumulatorError(RuntimeError):
    """A streamed accumulator went non-finite under
    ``SQ_RESILIENCE_STRICT=1``; the message carries the tile provenance
    (site, tile index, row range) of the first bad tile."""


class BreakerOpenError(RuntimeError):
    """The circuit breaker is open: the device failed ``SQ_BREAKER_K``
    transfers or probes in a row and has not passed a probe since. The
    message names the site that asked and the transition that opened the
    breaker. Nothing runs in the device's place."""


def _is_transient(exc):
    """Should the retry loop absorb ``exc``? Injected transfer failures and
    OS-level errors always; ``RuntimeError``s unless they are out-of-memory
    errors (they recur on every attempt). The package's own control flow
    (an injected interrupt, a non-finite accumulator, an open breaker) is
    never a transfer failure."""
    if isinstance(exc, InjectedTransferError):
        return True
    if isinstance(exc, (InjectedFault, NonFiniteAccumulatorError,
                        BreakerOpenError)):
        return False
    if isinstance(exc, OSError):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        return not any(m in msg for m in _NON_TRANSIENT_MARKERS)
    return False


def _retries():
    return _knobs.get_int("SQ_RETRY_MAX")


def _backoff_s():
    return _knobs.get_float("SQ_RETRY_BACKOFF_S")


def _deadline_s():
    return _knobs.get_float("SQ_TILE_DEADLINE_S")


def backoff_delay(attempt, tile_index=0, seed=None):
    """Backoff before retry ``attempt`` (0-based): exponential base with
    deterministic keyed jitter in [1, 2)."""
    if seed is None:
        seed = _knobs.get_int("SQ_RETRY_SEED")
    return (_backoff_s() * (2 ** attempt)
            * (1.0 + _u01(seed, tile_index, attempt)))


class CircuitBreaker:
    """Consecutive-failure circuit breaker over the transfer/probe path.

    States: ``closed`` (healthy; failures count), ``open`` (tripped;
    supervised puts raise :class:`BreakerOpenError`, cooldown ticking),
    ``half_open`` (cooldown elapsed; the next put or probe decides).
    Transitions emit a ``breaker`` record and a
    ``resilience.breaker_state`` gauge when a recorder is active, and are
    kept in :attr:`transitions`. ``clock`` is injectable so the cooldown is
    testable without sleeping.
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/resilience/
    #: supervisor.py``'s map): these attributes are only written under
    #: ``self._lock``; ``_transition`` runs with the lock held.
    _GUARDED_BY = {"_lock": ("_state", "_consecutive", "_opened_at",
                             "trips", "transitions")}
    _ASSUMES_LOCK = ("_transition",)

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = None
        self.trips = 0
        self.transitions = []
        # an RLock: preflight's probe re-enters through on_probe
        self._lock = threading.RLock()

    # -- state ---------------------------------------------------------------

    @property
    def consecutive_failures(self):
        return self._consecutive

    def state(self):
        """Current state, lazily advancing ``open`` → ``half_open`` once
        the cooldown has elapsed."""
        with self._lock:
            if (self._state == OPEN and self._opened_at is not None
                    and self._clock() - self._opened_at
                    >= self._cooldown_s()):
                self._transition(HALF_OPEN, "cooldown elapsed")
            return self._state

    def _k(self):
        return _knobs.get_int("SQ_BREAKER_K")

    def _cooldown_s(self):
        return _knobs.get_float("SQ_BREAKER_COOLDOWN_S")

    def _transition(self, new, reason):
        prev, self._state = self._state, new
        ev = {"state": new, "prev": prev, "reason": reason,
              "consecutive": self._consecutive}
        self.transitions.append(ev)
        from ..obs import recorder

        rec = recorder.get_recorder()
        if rec is not None:
            rec.record(dict(ev, type="breaker"), kind="breaker_events")
            recorder.gauge("resilience.breaker_state", new, reason=reason)

    def open_error(self, site):
        """The :class:`BreakerOpenError` for a request at ``site``."""
        last = self.transitions[-1] if self.transitions else None
        opened = (f"{last['prev']} → {last['state']}: {last['reason']}"
                  if last else "no transition recorded")
        return BreakerOpenError(
            f"circuit breaker open at {site or '<unnamed site>'} ({opened});"
            f" the device is not used until a probe passes after "
            f"SQ_BREAKER_COOLDOWN_S={self._cooldown_s()} s, and no work "
            f"moves to the CPU in its place")

    # -- inputs --------------------------------------------------------------

    def record_failure(self, reason, site=None, elapsed=None):
        """One transfer failure or timeout. Trips on the K-th consecutive
        one; in ``half_open`` a single failure re-opens."""
        with self._lock:
            self._consecutive += 1
            state = self.state()
            if state == HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN, f"half-open trial failed ({reason})")
            elif state == CLOSED and self._consecutive >= self._k():
                self._opened_at = self._clock()
                self.trips += 1
                self._transition(
                    OPEN, f"{self._consecutive} consecutive failures "
                          f"(last: {reason}{f' at {site}' if site else ''})")

    def record_timeout(self, site=None, elapsed=None):
        self.record_failure("deadline exceeded", site=site, elapsed=elapsed)

    def record_success(self):
        """One healthy transfer: resets the consecutive count; in
        ``half_open`` it closes the breaker."""
        with self._lock:
            self._consecutive = 0
            if self.state() == HALF_OPEN:
                self._transition(CLOSED, "half-open trial succeeded")

    def on_probe(self, outcome):
        """Probe outcomes feed the same state machine: ``timeout``/``error``
        count as failures, ``ok``/``cpu`` as successes."""
        if outcome in ("ok", "cpu"):
            self.record_success()
        elif outcome in ("timeout", "error"):
            self.record_failure(f"probe {outcome}")

    def preflight(self, site=None, device=None):
        """Fit-entry hook. Closed: one comparison. Half-open (cooldown
        elapsed): probe ``device`` afresh, which closes or re-opens the
        breaker. Still open after that: raise :class:`BreakerOpenError`.
        Returns the state."""
        if self._state == CLOSED:
            return CLOSED
        if self.state() == HALF_OPEN:
            # the outcome feeds on_probe; a failed probe re-opened it
            if _probe_device(device) in ("timeout", "error"):
                raise self.open_error(site)
        state = self.state()
        if state == OPEN:
            raise self.open_error(site)
        return state

    def reset(self, reason="reset"):
        """Back to a fresh closed breaker. Emits a transition record only
        if the state actually changes."""
        with self._lock:
            self._consecutive = 0
            self._opened_at = None
            if self._state != CLOSED:
                self._transition(CLOSED, reason)


#: the process-wide breaker every supervised put and probe feeds
breaker = CircuitBreaker()


def _probe_device(device=None):
    """The half-open breaker's trial: a forced (uncached) device-health
    probe of ``device`` under ``SQ_TILE_DEADLINE_S``
    (:func:`sq_learn_tpu_torch.obs.probe.probe_device`, which records it
    and feeds the outcome to :data:`breaker`). An armed ``probe_timeout``
    fault decides the trial on any device, the CPU included. Returns the
    outcome: ``ok``, ``cpu``, ``timeout`` or ``error``."""
    from ..obs import probe

    platform = "cpu" if device is None else str(device)
    plan = _faults._active
    forced = plan.on_probe() if plan is not None else None
    if forced is not None:
        return probe._record(forced, _deadline_s(), platform)["outcome"]
    return probe.probe_device(timeout_s=_deadline_s(), platform=platform,
                              force=True)["outcome"]


def put(put_fn, tile, tile_index=0, site=None):
    """Run one supervised placement ``put_fn(tile)``.

    The fast path (no faults armed, breaker closed) is a timed raw call;
    its failure handling is the same retry loop as the supervised path.
    Returns ``put_fn``'s result, or raises its terminal error after the
    retries, or :class:`BreakerOpenError` once the breaker is open.
    """
    if _faults._active is None and breaker._state == CLOSED:
        t0 = time.perf_counter()
        try:
            out = put_fn(tile)
        except Exception as exc:
            if not _is_transient(exc):
                raise
            _pre_retry(exc, site, 0, tile_index)
            return _put_supervised(put_fn, tile, tile_index, site,
                                   first_attempt=1)
        elapsed = time.perf_counter() - t0
        if elapsed > _deadline_s():
            breaker.record_timeout(site=site, elapsed=elapsed)
        elif breaker._consecutive:
            breaker.record_success()
        return out
    return _put_supervised(put_fn, tile, tile_index, site)


def _pre_retry(exc, site, attempt, tile_index):
    """Between a failed transient attempt and its retry: feed the breaker,
    count the retry, sleep the keyed backoff. Raises
    :class:`BreakerOpenError` when this failure tripped the breaker, and
    ``exc`` when the failed attempt was the last one allowed."""
    breaker.record_failure(type(exc).__name__, site=site)
    if breaker.state() == OPEN:
        raise breaker.open_error(site) from exc
    if attempt >= _retries():
        raise exc
    from ..obs import recorder

    recorder.counter_add("resilience.retries", 1)
    time.sleep(backoff_delay(attempt, tile_index))


def _supervised(attempt_fn, index, site, first_attempt):
    """The retry loop shared by puts and reads: ``attempt_fn()`` is one
    timed attempt (hooks included)."""
    deadline = _deadline_s()
    attempt = first_attempt
    while True:
        if breaker.state() == OPEN:
            raise breaker.open_error(site)
        try:
            t0 = time.perf_counter()
            out = attempt_fn()
        except Exception as exc:
            if not _is_transient(exc):
                raise
            _pre_retry(exc, site, attempt, index)  # raises on last
            attempt += 1
            continue
        elapsed = time.perf_counter() - t0
        if elapsed > deadline:
            breaker.record_timeout(site=site, elapsed=elapsed)
        else:
            breaker.record_success()
        return out


def _put_supervised(put_fn, tile, tile_index, site, first_attempt=0):
    plan = _faults._active

    def attempt():
        payload = tile
        if plan is not None:
            payload = plan.corrupt(tile, tile_index)
            plan.on_put(tile_index)  # may stall (timed) or raise
        return put_fn(payload)

    return _supervised(attempt, tile_index, site, first_attempt)


def supervised_read(read_fn, index=0, site=None):
    """Run one supervised disk read ``read_fn()`` — the shard-store twin
    of :func:`put`, with the same retries, deadline and breaker; armed
    ``read_stall``/``read_fail`` injectors hook the timed attempt.
    ``index`` is the shard index."""
    if _faults._active is None and breaker._state == CLOSED:
        t0 = time.perf_counter()
        try:
            out = read_fn()
        except Exception as exc:
            if not _is_transient(exc):
                raise
            _pre_retry(exc, site, 0, index)
            return _read_supervised(read_fn, index, site, first_attempt=1)
        elapsed = time.perf_counter() - t0
        if elapsed > _deadline_s():
            breaker.record_timeout(site=site, elapsed=elapsed)
        elif breaker._consecutive:
            breaker.record_success()
        return out
    return _read_supervised(read_fn, index, site)


def _read_supervised(read_fn, index, site, first_attempt=0):
    plan = _faults._active

    def attempt():
        if plan is not None:
            plan.on_read(index)  # may stall (timed) or raise
        return read_fn()

    return _supervised(attempt, index, site, first_attempt)
