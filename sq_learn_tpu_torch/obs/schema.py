"""JSONL schema of the port's obs records, and a dependency-free validator
(counterpart of ``sq_learn_tpu/obs/schema.py``, cut to the record types
the port writes).

Every line carries the JAX package's envelope ``{"v": 11,
"schema_version": 11, "ts": <unix seconds>, "type": <t>}`` plus the
fields of its type; earlier versions (1–10) still validate, any other
version is rejected.

=========  ==============================================================
type       required fields (beyond the envelope)
=========  ==============================================================
meta       pid (int), schema (int); optional segment (int — the ordinal
           of a rotated sink's segment, ``SQ_OBS_ROTATE_BYTES``)
span       name (str), seq (int), dur_s (number ≥ 0), depth (int ≥ 0),
           parent (int | null), synced (bool); optional attrs (object),
           error (str)
counter    name (str), value (number), delta (number)
gauge      name (str), value (any JSON scalar); optional attrs (object)
ledger     estimator (str), step (str), queries (object: str → number),
           budget (object: str → number); optional wall_s (number ≥ 0),
           attrs (object)
guarantee  site (str), realized (number ≥ 0), tol (number ≥ 0),
           violated (bool), fail_prob (number in [0, 1] | null);
           optional short_circuit (bool), n_total (int), attrs (object)
tradeoff   sweep (str), point (number), accuracy (number),
           q_runtime (number | null), c_runtime (number | null); optional
           wall_s (number ≥ 0), accuracy_metric (str), budget (object:
           str → number), attrs (object)
fault      kind (str), tile (int | null) — one injected fault of the
           ``SQ_FAULTS`` harness (:mod:`sq_learn_tpu_torch.resilience.
           faults`); optional host (int), stall_s (number ≥ 0)
breaker    state (str ∈ {closed, open, half_open}), prev (str),
           reason (str), consecutive (int ≥ 0) — one circuit-breaker
           transition (:mod:`sq_learn_tpu_torch.resilience.supervisor`)
io         surface (str), store (str — the store's fingerprint), shard
           (int ≥ 0 | null), reads (int ≥ 0), bytes_stored (int ≥ 0),
           bytes_raw (int ≥ 0) — one CUMULATIVE storage-ledger aggregate
           (:mod:`.storage`; the newest record per key wins); optional
           hits / stalls / serial / retries / quarantined / spills /
           disk_hits / promotes / misses (int ≥ 0), read_s / crc_s /
           decode_s / cold_s / stall_s / heat (number ≥ 0), codec (str),
           reason (str)
=========  ==============================================================

The out-of-core plane rides the generic types as the JAX package's does:
shard reads are ``counter`` records (``oocore.shard_reads``,
``oocore.shard_read_bytes``, ``oocore.crc_failures``, ``oocore.rereads``,
the v7 codec pair ``oocore.codec_bytes_in``/``oocore.codec_bytes_out``,
the prefetch and async-checkpoint counters), ``span`` records
(``oocore.create_store`` with its ``codec`` attr, ``oocore.minibatch_fit``,
``oocore.epoch``, ``oocore.assign_labels``, ``oocore.prefetch``) and read
faults ``fault`` records.

The JAX package's other types (watchdog, probe, xla_cost, regression,
slo, budget, alert, control, elastic, clock) come with the planes that
write them (``ROADMAP.md`` §1); until then a record of any of them is
rejected, with an error that names its type.
"""

import json

from .recorder import SCHEMA_VERSION

_NUM = (int, float)

#: versions this validator reads (the JAX package's, up to its v11)
KNOWN_VERSIONS = set(range(1, SCHEMA_VERSION + 1))

#: every record type the port writes, machine-readable
RECORD_TYPES = ("meta", "span", "counter", "gauge", "ledger", "guarantee",
                "tradeoff", "fault", "breaker", "io")

_BREAKER_STATES = frozenset({"closed", "open", "half_open"})


def _check(cond, errors, msg):
    if not cond:
        errors.append(msg)


def _number(v):
    return isinstance(v, _NUM) and not isinstance(v, bool)


def _int(v):
    return isinstance(v, int) and not isinstance(v, bool)


def _str_to_number(obj):
    return isinstance(obj, dict) and all(
        isinstance(k, str) and isinstance(v, _NUM) for k, v in obj.items())


def validate_record(rec):
    """Validate one decoded record; returns a list of error strings
    (empty = valid)."""
    errors = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    v = rec.get("v")
    _check(v in KNOWN_VERSIONS, errors,
           f"unknown schema version {v!r} (known: {sorted(KNOWN_VERSIONS)})")
    if "schema_version" in rec:
        _check(rec["schema_version"] == v, errors,
               f"schema_version {rec['schema_version']!r} disagrees with "
               f"v {v!r}")
    elif isinstance(v, int) and v >= 2:
        errors.append(f"v{v} records must carry schema_version")
    _check(isinstance(rec.get("ts"), _NUM), errors, "ts must be numeric")
    t = rec.get("type")
    if t == "meta":
        _check(isinstance(rec.get("pid"), int), errors, "meta.pid int")
        _check(isinstance(rec.get("schema"), int), errors, "meta.schema int")
        if "segment" in rec:
            _check(_int(rec["segment"]) and rec["segment"] >= 1, errors,
                   "meta.segment positive int")
    elif t == "span":
        _check(isinstance(rec.get("name"), str), errors, "span.name str")
        _check(isinstance(rec.get("seq"), int), errors, "span.seq int")
        _check(isinstance(rec.get("dur_s"), _NUM) and rec["dur_s"] >= 0,
               errors, "span.dur_s non-negative number")
        _check(isinstance(rec.get("depth"), int) and rec["depth"] >= 0,
               errors, "span.depth non-negative int")
        _check(rec.get("parent") is None or isinstance(rec["parent"], int),
               errors, "span.parent int or null")
        _check(isinstance(rec.get("synced"), bool), errors,
               "span.synced bool")
        _check(isinstance(rec.get("attrs", {}), dict), errors,
               "span.attrs object")
    elif t == "counter":
        _check(isinstance(rec.get("name"), str), errors, "counter.name str")
        _check(isinstance(rec.get("value"), _NUM), errors,
               "counter.value number")
        _check(isinstance(rec.get("delta"), _NUM), errors,
               "counter.delta number")
    elif t == "gauge":
        _check(isinstance(rec.get("name"), str), errors, "gauge.name str")
        _check("value" in rec, errors, "gauge.value required")
    elif t == "ledger":
        _check(isinstance(rec.get("estimator"), str), errors,
               "ledger.estimator str")
        _check(isinstance(rec.get("step"), str), errors, "ledger.step str")
        for field in ("queries", "budget"):
            _check(_str_to_number(rec.get(field)), errors,
                   f"ledger.{field} object of str → number")
        if "wall_s" in rec:
            _check(isinstance(rec["wall_s"], _NUM) and rec["wall_s"] >= 0,
                   errors, "ledger.wall_s non-negative number")
    elif t == "guarantee":
        _check(isinstance(rec.get("site"), str), errors,
               "guarantee.site str")
        for field in ("realized", "tol"):
            _check(_number(rec.get(field)) and rec[field] >= 0, errors,
                   f"guarantee.{field} non-negative number")
        _check(isinstance(rec.get("violated"), bool), errors,
               "guarantee.violated bool")
        fp = rec.get("fail_prob", None)
        _check("fail_prob" in rec
               and (fp is None or (_number(fp) and 0.0 <= fp <= 1.0)),
               errors, "guarantee.fail_prob number in [0, 1] or null")
        if "short_circuit" in rec:
            _check(isinstance(rec["short_circuit"], bool), errors,
                   "guarantee.short_circuit bool")
        if "n_total" in rec:
            _check(isinstance(rec["n_total"], int)
                   and not isinstance(rec["n_total"], bool), errors,
                   "guarantee.n_total int")
    elif t == "tradeoff":
        _check(isinstance(rec.get("sweep"), str), errors,
               "tradeoff.sweep str")
        for field in ("point", "accuracy"):
            _check(_number(rec.get(field)), errors,
                   f"tradeoff.{field} number")
        for field in ("q_runtime", "c_runtime"):
            _check(field in rec and (rec[field] is None
                                     or _number(rec[field])),
                   errors, f"tradeoff.{field} number or null")
        if rec.get("wall_s") is not None:
            _check(isinstance(rec["wall_s"], _NUM) and rec["wall_s"] >= 0,
                   errors, "tradeoff.wall_s non-negative number")
        if "budget" in rec:
            _check(_str_to_number(rec["budget"]), errors,
                   "tradeoff.budget object of str → number")
    elif t == "fault":
        _check(isinstance(rec.get("kind"), str), errors, "fault.kind str")
        _check(rec.get("tile") is None or isinstance(rec["tile"], int),
               errors, "fault.tile int or null")
        if "host" in rec:
            _check(isinstance(rec["host"], int)
                   and not isinstance(rec["host"], bool), errors,
                   "fault.host int")
        if "stall_s" in rec:
            _check(_number(rec["stall_s"]) and rec["stall_s"] >= 0, errors,
                   "fault.stall_s non-negative number")
    elif t == "breaker":
        _check(rec.get("state") in _BREAKER_STATES, errors,
               f"breaker.state in {sorted(_BREAKER_STATES)}")
        _check(isinstance(rec.get("prev"), str), errors, "breaker.prev str")
        _check(isinstance(rec.get("reason"), str), errors,
               "breaker.reason str")
        _check(isinstance(rec.get("consecutive"), int)
               and rec["consecutive"] >= 0, errors,
               "breaker.consecutive non-negative int")
    elif t == "io":
        _check(isinstance(rec.get("surface"), str), errors,
               "io.surface str")
        _check(isinstance(rec.get("store"), str), errors, "io.store str")
        sh = rec.get("shard", -1)
        _check(sh is None or (_int(sh) and sh >= 0), errors,
               "io.shard non-negative int or null")
        for field in ("reads", "bytes_stored", "bytes_raw"):
            _check(_int(rec.get(field)) and rec[field] >= 0, errors,
                   f"io.{field} non-negative int")
        for field in ("hits", "stalls", "serial", "retries", "quarantined",
                      "spills", "disk_hits", "promotes", "misses"):
            if field in rec:
                _check(_int(rec[field]) and rec[field] >= 0, errors,
                       f"io.{field} non-negative int")
        for field in ("read_s", "crc_s", "decode_s", "cold_s", "stall_s",
                      "heat"):
            if field in rec:
                _check(_number(rec[field]) and rec[field] >= 0, errors,
                       f"io.{field} non-negative number")
        for field in ("codec", "reason"):
            if field in rec:
                _check(isinstance(rec[field], str), errors,
                       f"io.{field} str")
    else:
        errors.append(
            f"unknown record type {t!r} (the port writes "
            f"{', '.join(RECORD_TYPES)})")
    if "attrs" in rec and t != "span":
        _check(isinstance(rec["attrs"], dict), errors,
               f"{t}.attrs object")
    return errors


def validate_jsonl(path, max_errors=20):
    """Validate every line of an obs JSONL file.

    Returns ``{lines, by_type, errors}`` where ``errors`` is a list of
    "line N: message" strings (truncated at ``max_errors``). An empty or
    missing file is an error — a run that recorded nothing is a broken
    run. ``.jsonl.gz`` archives open transparently.
    """
    lines = 0
    by_type = {}
    errors = []
    try:
        if str(path).endswith(".gz"):
            import gzip

            fh = gzip.open(path, "rt")
        else:
            fh = open(path)
    except OSError as exc:
        return {"lines": 0, "by_type": {}, "errors": [str(exc)]}
    with fh:
        for i, raw in enumerate(fh, 1):
            raw = raw.strip()
            if not raw:
                continue
            lines += 1
            try:
                rec = json.loads(raw)
            except ValueError as exc:
                errors.append(f"line {i}: not JSON ({exc})")
                continue
            for msg in validate_record(rec):
                if len(errors) < max_errors:
                    errors.append(f"line {i}: {msg}")
            t = rec.get("type") if isinstance(rec, dict) else None
            by_type[t] = by_type.get(t, 0) + 1
    if lines == 0:
        errors.append("file has no records")
    return {"lines": lines, "by_type": by_type, "errors": errors}
