"""Single source of truth for the environment knobs the port reads
(counterpart of ``sq_learn_tpu/_knobs.py``).

Every environment read of ``sq_learn_tpu_torch`` goes through the typed
accessors below, against a registry entry that carries the knob's name,
kind, default, scope, a one-line doc and the file whose prose describes
it. The registry holds the knobs of the planes the port has: ``obs``,
the streaming engine, the transfer supervisor, the fault harness, the
sketch engine and the out-of-core shard stores. The JAX package's other
knobs (serving, the elastic mesh, XLA's caches) come with their planes.

Runtime contract, as in the JAX package:

- Accessors validate the name against the registry and raise
  :class:`UnknownKnobError` on a miss.
- ``kind="flag"`` knobs follow one rule: a knob whose registered default
  is False is enabled only by ``"1"``; a knob whose default is True stays
  enabled unless set to ``"0"``.
- This module imports only the standard library: ``obs`` reads through it
  in processes that never load torch.
"""

import os

__all__ = [
    "Knob",
    "REGISTRY",
    "UnknownKnobError",
    "get_bool",
    "get_float",
    "get_int",
    "get_raw",
    "get_str",
    "is_set",
    "iter_knobs",
    "knob",
    "resolve",
    "setdefault",
    "snapshot",
]

_UNSET = object()


class UnknownKnobError(KeyError):
    """An environment knob was read that the registry does not declare."""


class Knob:
    """One declared environment knob (immutable value object)."""

    __slots__ = ("name", "kind", "default", "scope", "doc", "anchor")

    def __init__(self, name, kind, default, scope, doc, anchor):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "default", default)
        object.__setattr__(self, "scope", scope)
        object.__setattr__(self, "doc", doc)
        object.__setattr__(self, "anchor", anchor)

    def __setattr__(self, name, value):
        raise AttributeError("Knob entries are immutable")

    def __repr__(self):
        return (f"Knob({self.name!r}, kind={self.kind!r}, "
                f"default={self.default!r}, scope={self.scope!r})")


def _K(name, kind, default, scope, doc, anchor):
    return Knob(name, kind, default, scope, doc, anchor)


#: kinds: "flag", "int", "float", "str", "path", "spec" (a str with its own
#: grammar, parsed at the call site); scopes: "lib" (read inside the
#: port), "external" (owned upstream, read here)
_ENTRIES = [
    # -- observability ----------------------------------------------------
    _K("SQ_OBS", "flag", False, "lib",
       "Enable the run-scoped recorder with a JSONL sink at SQ_OBS_PATH.",
       "sq_learn_tpu_torch/obs/__init__.py"),
    _K("SQ_OBS_PATH", "path", "sq_obs.jsonl", "lib",
       "JSONL sink path for the SQ_OBS=1 auto-enabled recorder.",
       "sq_learn_tpu_torch/obs/__init__.py"),
    _K("SQ_OBS_AUDIT_STRICT", "flag", False, "lib",
       "A flagged (ε, δ)-guarantee audit site raises (Clopper-Pearson "
       "lower bound above the declared δ/γ).",
       "sq_learn_tpu_torch/obs/guarantees.py"),
    _K("SQ_OBS_TRACE", "path", None, "lib",
       "Render the closed run into Chrome trace-event JSON at this path.",
       "sq_learn_tpu_torch/obs/trace.py"),
    _K("SQ_OBS_ROTATE_BYTES", "int", 0, "lib",
       "Rotate the JSONL sink to gzipped <path>.<n>.gz segments at this "
       "many written bytes (0 = off).", "sq_learn_tpu_torch/obs/recorder.py"),
    # -- resilience ---------------------------------------------------------
    _K("SQ_FAULTS", "spec", None, "lib",
       "Deterministic fault-injection schedule (armed at import).",
       "sq_learn_tpu_torch/resilience/faults.py"),
    _K("SQ_RESILIENCE_STRICT", "flag", False, "lib",
       "Streamed passes raise on non-finite accumulators with tile "
       "provenance.", "sq_learn_tpu_torch/streaming.py"),
    _K("SQ_RETRY_MAX", "int", 3, "lib",
       "Supervised-put retry budget.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    _K("SQ_RETRY_BACKOFF_S", "float", 0.05, "lib",
       "Base backoff between supervised-put retries.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    _K("SQ_RETRY_SEED", "int", 0, "lib",
       "Seed of the retry-jitter draws.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    _K("SQ_TILE_DEADLINE_S", "float", 30.0, "lib",
       "Per-tile transfer deadline before a put counts as timed out; also "
       "bounds the breaker's half-open device probe.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    _K("SQ_BREAKER_K", "int", 3, "lib",
       "Consecutive failures that trip the circuit breaker.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    _K("SQ_BREAKER_COOLDOWN_S", "float", 60.0, "lib",
       "Open-state cooldown before the breaker half-opens.",
       "sq_learn_tpu_torch/resilience/supervisor.py"),
    # -- streaming engine ---------------------------------------------------
    # SQ_STREAM_TILE_BYTES and SQ_TRANSFER_CHUNK_BYTES set one value in the
    # port, the tile cap (streaming.stream_tile_bytes: the first when set,
    # else the second); both keep the JAX package's names so that one
    # environment drives both packages
    _K("SQ_STREAM_TILE_BYTES", "int", None, "lib",
       "Streamed-ingest tile size override (unset = "
       "SQ_TRANSFER_CHUNK_BYTES).", "sq_learn_tpu_torch/streaming.py"),
    _K("SQ_STREAM_MIN_BUCKET_ROWS", "int", 64, "lib",
       "Smallest padded row bucket the streaming engine mints.",
       "sq_learn_tpu_torch/streaming.py"),
    _K("SQ_STREAM_CKPT_DIR", "path", None, "lib",
       "Arm resumable streamed passes: checkpoint directory.",
       "sq_learn_tpu_torch/streaming.py"),
    _K("SQ_STREAM_CKPT_EVERY", "int", 8, "lib",
       "Checkpoint cadence in tiles for resumable streamed passes.",
       "sq_learn_tpu_torch/streaming.py"),
    _K("SQ_TRANSFER_CHUNK_BYTES", "int", 128 * 2 ** 20, "lib",
       "Largest single host→device transfer; host data above it reaches "
       "the card through the streaming engine.",
       "sq_learn_tpu_torch/streaming.py"),
    # -- sketch engine ------------------------------------------------------
    _K("SQ_SKETCH_ROWS", "float", None, "lib",
       "Row-sketch sample target for δ>0 spectral stats (0 disables, "
       "unset = auto).", "sq_learn_tpu_torch/sketch/engine.py"),
    _K("SQ_SKETCH_DELTA", "float", None, "lib",
       "δ_stat of the sketched spectral-stats bounds (0 = exact, unset = "
       "0.05).", "sq_learn_tpu_torch/sketch/engine.py"),
    _K("SQ_STATS_CACHE", "flag", True, "lib",
       "Digest-keyed spectral-stats cache (0 disables).",
       "sq_learn_tpu_torch/sketch/cache.py"),
    # -- out-of-core shard stores -------------------------------------------
    _K("SQ_OOC_SHARD_BYTES", "int", 8 << 20, "lib",
       "Shard split size for new out-of-core stores.",
       "sq_learn_tpu_torch/oocore/store.py"),
    _K("SQ_OOC_RAM_BUDGET_BYTES", "int", 0, "lib",
       "Enforced single-materialization RAM budget (0 = off); also caps "
       "readahead.", "sq_learn_tpu_torch/oocore/store.py"),
    _K("SQ_OOC_VERIFY", "str", "all", "lib",
       "Read-side CRC policy for shard stores: all | touch | off.",
       "sq_learn_tpu_torch/oocore/store.py"),
    _K("SQ_OOC_REREAD_MAX", "int", 2, "lib",
       "Quarantine re-read budget after a CRC mismatch.",
       "sq_learn_tpu_torch/oocore/store.py"),
    _K("SQ_OOC_CODEC", "str", "none", "lib",
       "Per-shard codec for NEW store builds (lz4 = LZ4 block format + "
       "byte shuffle).", "sq_learn_tpu_torch/oocore/store.py"),
    _K("SQ_OOC_PREFETCH_DEPTH", "int", None, "lib",
       "Shard readahead depth (0 = serial bit-for-bit, unset = auto: 2 "
       "multi-core / 0 single-core).",
       "sq_learn_tpu_torch/oocore/prefetch.py"),
    _K("SQ_OOC_PREFETCH_THREADS", "int", 2, "lib",
       "Prefetch worker-pool width (also sizes parallel store builds).",
       "sq_learn_tpu_torch/oocore/prefetch.py"),
    _K("SQ_OOC_ASYNC_CKPT", "flag", True, "lib",
       "Async mid-epoch fit snapshots (0 = synchronous writes).",
       "sq_learn_tpu_torch/oocore/fit.py"),
    # -- external (owned upstream; registered so reads are auditable) ------
    _K("CUDA_HOME", "path", None, "external",
       "CUDA toolkit root whose bin/nvcc builds the kernels (then "
       "/usr/local/cuda, then PATH).", "sq_learn_tpu_torch/ops/_build.py"),
]

#: name → Knob
REGISTRY = {e.name: e for e in _ENTRIES}

if len(REGISTRY) != len(_ENTRIES):  # pragma: no cover - registry bug
    raise RuntimeError("duplicate knob registration")


def resolve(name):
    """The :class:`Knob` entry for ``name``, or None when unregistered."""
    return REGISTRY.get(name)


def knob(name):
    """The :class:`Knob` entry for ``name``; raises
    :class:`UnknownKnobError` when unregistered."""
    e = resolve(name)
    if e is None:
        raise UnknownKnobError(
            f"environment knob {name!r} is not in the "
            f"sq_learn_tpu_torch._knobs registry — register it there (one "
            f"line) before reading it")
    return e


def iter_knobs():
    """Every registry entry, name-sorted."""
    return sorted(_ENTRIES, key=lambda e: (e.scope != "lib", e.name))


def is_set(name):
    """True when the (registered) knob is present in the environment."""
    knob(name)
    return name in os.environ


def get_raw(name, default=None):
    """The raw string value of a registered knob, or ``default`` when
    unset."""
    knob(name)
    return os.environ.get(name, default)


def _typed(name, default, conv):
    e = knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return e.default if default is _UNSET else default
    return conv(raw)


def get_str(name, default=_UNSET):
    """String knob value (registry default when unset)."""
    return _typed(name, default, str)


def get_int(name, default=_UNSET):
    """Integer knob value (registry default when unset)."""
    return _typed(name, default, int)


def get_float(name, default=_UNSET):
    """Float knob value (registry default when unset)."""
    return _typed(name, default, float)


def get_bool(name):
    """Flag knob value: default-False knobs enable only on ``"1"``;
    default-True knobs disable only on ``"0"``."""
    e = knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return bool(e.default)
    if e.default:
        return raw != "0"
    return raw == "1"


def setdefault(name, value):
    """``os.environ.setdefault`` for a registered knob."""
    knob(name)
    return os.environ.setdefault(name, str(value))


def snapshot(names):
    """{name: raw value or None} for registered knobs — the save half of a
    save/mutate/restore of the environment."""
    return {n: get_raw(n) for n in names}
