"""Single source of truth for the environment knobs the port reads
(counterpart of ``sq_learn_tpu/_knobs.py``).

Every environment read of ``sq_learn_tpu_torch`` goes through the typed
accessors below, against a registry entry that carries the knob's name,
kind, default, scope, a one-line doc and the file whose prose describes
it. The registry holds the knobs of the planes the port has: ``obs`` (its
fleet envelope and regression gate included), the MFU accounting of
``utils/profiling``, the streaming engine, the transfer supervisor, the
fault harness, the sketch engine, the out-of-core shard stores, the
serving plane, the multi-process world (torch.distributed's launcher
variables) and the elastic world. The JAX package's other knobs (XLA's
caches, among them ``SQ_COMPILE_CACHE_DIR``: eager torch compiles nothing
to persist) have no object here.

Runtime contract, as in the JAX package:

- Accessors validate the name against the registry and raise
  :class:`UnknownKnobError` on a miss.
- A family entry (a name ending in ``*``, such as ``SQ_REGRESS_TOL_*``)
  governs every name with its prefix (``SQ_REGRESS_TOL_LATENCY``).
- ``kind="flag"`` knobs follow one rule: a knob whose registered default
  is False is enabled only by ``"1"``; a knob whose default is True stays
  enabled unless set to ``"0"``.
- This module imports only the standard library: ``obs`` reads through it
  in processes that never load torch.
- :func:`environ` is the one way to hand the environment to a child
  process (the elastic coordinator's workers).
"""

import contextlib
import os

__all__ = [
    "Knob",
    "REGISTRY",
    "UnknownKnobError",
    "environ",
    "get_bool",
    "get_float",
    "get_int",
    "get_raw",
    "get_str",
    "is_set",
    "iter_knobs",
    "knob",
    "override",
    "resolve",
    "set_env",
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

    @property
    def is_family(self):
        """True for a family entry (a trailing ``*``): it governs every
        name that starts with its prefix."""
        return self.name.endswith("*")


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
    _K("SQ_OBS_FLEET_RUN_ID", "str", None, "lib",
       "Coordinator-minted fleet run id; when set every record carries "
       "the fleet envelope (run_id/host/pid/gen).",
       "sq_learn_tpu_torch/obs/recorder.py"),
    _K("SQ_OBS_FLEET_HOST", "str", None, "lib",
       "Stable per-process host label in the fleet envelope (default "
       "pid<pid>).", "sq_learn_tpu_torch/obs/recorder.py"),
    _K("SQ_OBS_FLEET_DIR", "path", None, "lib",
       "Fleet shard directory: with SQ_OBS=1 and SQ_OBS_PATH unset the "
       "sink lands at <dir>/obs.<host>.jsonl.",
       "sq_learn_tpu_torch/obs/recorder.py"),
    _K("SQ_OBS_FLEET_CLOCK_SAMPLES", "int", 64, "lib",
       "Max clock samples recorded per peer per generation from the "
       "store's heartbeat exchanges.",
       "sq_learn_tpu_torch/parallel/elastic.py"),
    _K("SQ_OBS_STRICT", "flag", False, "lib",
       "With the serving kernels' budgets pinned, a dispatch of a "
       "signature that was never warmed raises.",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_OBS_BUDGET_STRICT", "flag", False, "lib",
       "A tripped multi-window error-budget burn alert raises "
       "BudgetBurnError.", "sq_learn_tpu_torch/obs/budget.py"),
    _K("SQ_OBS_BUDGET_WINDOWS", "spec", "60,600", "lib",
       "Comma-separated rolling error-budget windows in seconds.",
       "sq_learn_tpu_torch/obs/budget.py"),
    _K("SQ_OBS_BUDGET_BURN", "float", 2.0, "lib",
       "Multi-window burn-rate alert threshold (must hold in EVERY "
       "window).", "sq_learn_tpu_torch/obs/budget.py"),
    _K("SQ_REGRESS_TOL_*", "float", None, "lib",
       "Per-gate tolerance override for the bench regression gate "
       "(e.g. SQ_REGRESS_TOL_LATENCY).",
       "sq_learn_tpu_torch/obs/regress.py"),
    _K("SQ_REGRESS_SLACK_*", "float", None, "lib",
       "Per-gate additive-slack override for the bench regression gate.",
       "sq_learn_tpu_torch/obs/regress.py"),
    _K("SQ_PROBE_TTL_S", "float", 300.0, "lib",
       "TTL of a cached device-health probe result (0 disables caching).",
       "sq_learn_tpu_torch/obs/probe.py"),
    _K("SQ_PROBE_CACHE", "path", None, "lib",
       "Cross-process probe-cache file (default: sq_probe_cache.json in "
       "the temp dir).", "sq_learn_tpu_torch/obs/probe.py"),
    # -- profiling ----------------------------------------------------------
    _K("SQ_CPU_PEAK_FLOPS", "float", None, "lib",
       "Host peak-FLOPs override for MFU accounting.",
       "sq_learn_tpu_torch/utils/profiling.py"),
    _K("SQ_GPU_PEAK_FLOPS", "float", None, "lib",
       "Card fp32 peak-FLOPs override for MFU accounting (the rate "
       "outside the tensor cores; the other math kinds keep the H100 "
       "table's).",
       "sq_learn_tpu_torch/utils/profiling.py"),
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
    # -- the elastic world -------------------------------------------------
    _K("SQ_ELASTIC_HEARTBEAT_S", "float", 0.5, "lib",
       "Lease-supervisor heartbeat publish cadence (store keys, per "
       "worker); `ElasticCoordinator(heartbeat_s=)` overrides it.",
       "sq_learn_tpu_torch/parallel/elastic.py"),
    _K("SQ_ELASTIC_LEASE_S", "float", 3.0, "lib",
       "Lease length: a peer silent for one lease is declared dead; "
       "`ElasticCoordinator(lease_s=)` overrides it.",
       "sq_learn_tpu_torch/parallel/elastic.py"),
    _K("SQ_ELASTIC_MAX_SHRINKS", "int", 1, "lib",
       "Host-failure budget: shrinks tolerated before the fit aborts; "
       "`ElasticCoordinator(max_shrinks=)` overrides it.",
       "sq_learn_tpu_torch/parallel/elastic.py"),
    _K("SQ_ELASTIC_WINDOW", "int", 4, "lib",
       "Commit-window width in visit-order positions (atomic fold+commit "
       "unit).", "sq_learn_tpu_torch/parallel/elastic.py"),
    _K("SQ_ELASTIC_PORT", "int", 0, "lib",
       "TCP store port of generation 0; generation G binds this + G "
       "(0 = pick a free port per generation).",
       "sq_learn_tpu_torch/parallel/elastic.py"),
    # -- serving plane ------------------------------------------------------
    _K("SQ_SERVE_MAX_WAIT_MS", "float", 2.0, "lib",
       "Micro-batch coalescing window.",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_SERVE_MAX_BATCH_ROWS", "int", 512, "lib",
       "Row cap of one padded serving batch.",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_SERVE_MIN_BUCKET_ROWS", "int", 8, "lib",
       "Smallest padded pow2 serving bucket.",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_SERVE_REGISTRY_CAP", "int", 8, "lib",
       "LRU capacity of the checkpoint-backed model registry.",
       "sq_learn_tpu_torch/serving/registry.py"),
    _K("SQ_SERVE_AOT", "flag", True, "lib",
       "Warm the bucket ladder at registry warm (0 skips).",
       "sq_learn_tpu_torch/serving/aot.py"),
    _K("SQ_SERVE_CACHE", "flag", True, "lib",
       "Digest-keyed transform result cache (0 kills it).",
       "sq_learn_tpu_torch/serving/cache.py"),
    _K("SQ_SERVE_CACHE_ENTRIES", "int", 256, "lib",
       "RAM-LRU entry cap of the serving result cache.",
       "sq_learn_tpu_torch/serving/cache.py"),
    _K("SQ_SERVE_CACHE_DIR", "path", None, "lib",
       "Arm the serving cache's compressed disk-spill tier.",
       "sq_learn_tpu_torch/serving/cache.py"),
    _K("SQ_SERVE_CACHE_DISK_ENTRIES", "int", 4096, "lib",
       "Entry bound of the disk-spill tier.",
       "sq_learn_tpu_torch/serving/cache.py"),
    _K("SQ_SERVE_QUANTIZE", "str", None, "lib",
       "Process-default serving quantization: bf16 | int8 | auto | "
       "none.", "sq_learn_tpu_torch/serving/quantize.py"),
    _K("SQ_SERVE_QUANT_DELTA", "float", 1e-3, "lib",
       "Declared audit budget δ_q of the quantization fold.",
       "sq_learn_tpu_torch/serving/quantize.py"),
    _K("SQ_SERVE_AUDIT_EVERY", "int", 8, "lib",
       "Quantization-fold guarantee-draw cadence in batches.",
       "sq_learn_tpu_torch/serving/quantize.py"),
    _K("SQ_SERVE_SLO_P50_MS", "float", None, "lib",
       "Run-level p50 latency SLO target.",
       "sq_learn_tpu_torch/serving/slo.py"),
    _K("SQ_SERVE_SLO_P99_MS", "float", None, "lib",
       "Run-level p99 latency SLO target.",
       "sq_learn_tpu_torch/serving/slo.py"),
    _K("SQ_SERVE_SLO_STRICT", "flag", False, "lib",
       "A violated SLO raises at dispatcher close.",
       "sq_learn_tpu_torch/serving/slo.py"),
    _K("SQ_SERVE_SLO_FLUSH_BATCHES", "int", 256, "lib",
       "Windowed slo/budget record flush stride in batches (0 "
       "disables).", "sq_learn_tpu_torch/serving/slo.py"),
    _K("SQ_SERVE_NATIVE", "flag", True, "lib",
       "One gather into a pooled pinned buffer per batch (0 = the "
       "per-request path, bit-identical).",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_SERVE_MEGABATCH", "flag", True, "lib",
       "Cross-tenant coalescing of same-fingerprint tenants into one "
       "kernel launch (0 = tenant-scoped batches).",
       "sq_learn_tpu_torch/serving/dispatcher.py"),
    _K("SQ_SERVE_AUTOTUNE", "flag", True, "lib",
       "SLO-driven (ε, δ) autotuner + admission control (0 pins the "
       "static serving plane bit-identically).",
       "sq_learn_tpu_torch/serving/control.py"),
    _K("SQ_SERVE_AUTOTUNE_EVERY", "int", 32, "lib",
       "Controller evaluation cadence in dispatched batches.",
       "sq_learn_tpu_torch/serving/control.py"),
    _K("SQ_SERVE_AUTOTUNE_BURN", "float", 1.5, "lib",
       "Burn rate at which the controller degrades a tenant (below the "
       "alert threshold: act BEFORE the SLO gate trips).",
       "sq_learn_tpu_torch/serving/control.py"),
    _K("SQ_SERVE_AUTOTUNE_RELAX", "float", 0.25, "lib",
       "Burn rate below which a budget counts as underspent (relax "
       "candidate).", "sq_learn_tpu_torch/serving/control.py"),
    _K("SQ_SERVE_AUTOTUNE_PATIENCE", "int", 3, "lib",
       "Consecutive underspent evaluations before the controller "
       "relaxes a tenant's served (ε, δ).",
       "sq_learn_tpu_torch/serving/control.py"),
    _K("SQ_SERVE_AUTOTUNE_DELTA_CAP", "float", 4.0, "lib",
       "Largest served-δ multiple of the declared δ the relax ladder "
       "may bank.", "sq_learn_tpu_torch/serving/control.py"),
    # -- external (owned upstream; registered so reads are auditable) ------
    _K("CUDA_HOME", "path", None, "external",
       "CUDA toolkit root whose bin/nvcc builds the kernels (then "
       "/usr/local/cuda, then PATH).", "sq_learn_tpu_torch/ops/_build.py"),
    # torch.distributed's launcher variables (torchrun sets them): the
    # counterparts of JAX_NUM_PROCESSES and jax.distributed's coordinator
    _K("WORLD_SIZE", "int", None, "external",
       "Number of processes of a multi-process world.",
       "sq_learn_tpu_torch/parallel/distributed.py"),
    _K("RANK", "int", None, "external",
       "This process's index in the multi-process world.",
       "sq_learn_tpu_torch/parallel/distributed.py"),
    _K("MASTER_ADDR", "str", None, "external",
       "Host of the world's TCP rendezvous store.",
       "sq_learn_tpu_torch/parallel/distributed.py"),
    _K("MASTER_PORT", "int", None, "external",
       "Port of the world's TCP rendezvous store.",
       "sq_learn_tpu_torch/parallel/distributed.py"),
]

#: name → Knob for exact entries; families keep their trailing ``*``
REGISTRY = {e.name: e for e in _ENTRIES}

_FAMILIES = tuple(e for e in _ENTRIES if e.is_family)

if len(REGISTRY) != len(_ENTRIES):  # pragma: no cover - registry bug
    raise RuntimeError("duplicate knob registration")


def resolve(name):
    """The :class:`Knob` entry governing ``name`` (exact match first,
    then family prefix), or None when unregistered."""
    e = REGISTRY.get(name)
    if e is not None:
        return e
    for fam in _FAMILIES:
        if name.startswith(fam.name[:-1]):
            return fam
    return None


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


def environ(**overrides):
    """A copy of this process's environment for a child process, with
    ``overrides`` applied (a None value removes the variable)."""
    env = dict(os.environ)
    for name, value in overrides.items():
        if value is None:
            env.pop(name, None)
        else:
            env[name] = str(value)
    return env


def snapshot(names):
    """{name: raw value or None} for registered knobs — the save half of a
    save/mutate/restore of the environment."""
    return {n: get_raw(n) for n in names}


def set_env(**values):
    """Set (a value) or unset (None) registered knobs in this process's
    environment — the mutate half; returns the previous raw values, so
    that ``set_env(**previous)`` restores them."""
    previous = snapshot(values)
    for name, value in values.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = str(value)
    return previous


@contextlib.contextmanager
def override(**values):
    """:func:`set_env` for the body of a ``with``, restored after it."""
    previous = set_env(**values)
    try:
        yield
    finally:
        set_env(**previous)
