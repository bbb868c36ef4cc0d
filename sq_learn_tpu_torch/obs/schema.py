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

The serving plane (:mod:`sq_learn_tpu_torch.serving`) writes five more:

=========  ==============================================================
slo        site (str), requests (int ≥ 0), p50_ms / p99_ms / qps (number
           ≥ 0), batch_occupancy (number in [0, 1]), degraded (int ≥ 0),
           violated (bool) — one serving run's (or one tenant's, or one
           flush window's) latency summary (:mod:`sq_learn_tpu_torch.
           serving.slo`); optional batches (int), window_s (number ≥ 0),
           transfer_bytes (int ≥ 0), targets (object: str → number),
           tenant (str), stages (object: str → number ≥ 0, seconds),
           attrs (object)
budget     tenant (str), window_s (number > 0), slo_burn / stat_burn /
           cp_lower_bound (number in [0, 1] | null), burn_rate (number
           ≥ 0 | null), alerting (bool) — one tenant × rolling-window
           error-budget evaluation (:mod:`.budget`); optional requests /
           over_p50 / over_p99 / draws / draw_violations (int ≥ 0),
           p50_ms / p99_ms / slo_burn_rate / stat_burn_rate (number ≥ 0),
           fail_prob, targets (object: str → number), site (str),
           seq (int ≥ 0)
alert      tenant (str), kind (str), threshold (number ≥ 0), burn_rates
           (object: str → number) — one tripped multi-window burn alert;
           optional site (str), seq (int ≥ 0)
control    tenant (str), action (str ∈ {plan, hold, relax, tighten,
           degrade, recover}), seq (int ≥ 0), inputs (object), decision
           (object) — one evaluation of the serving controller
           (:mod:`sq_learn_tpu_torch.serving.control`); optional site
           (str), level (int ≥ 0), predicted (object), realized (object |
           null), attrs (object)
probe      outcome (str ∈ {ok, timeout, error, cpu, skipped}), latency_s
           (number ≥ 0), platform (str) — one device-health probe
           (:mod:`.probe`); optional cached (bool)
=========  ==============================================================

The elastic world (:mod:`sq_learn_tpu_torch.parallel.elastic`) writes two
more:

=========  ==============================================================
elastic    event (str ∈ {world_up, resume, host_fail, host_stall, shrink,
           commit_refused, stale_exit, done, window, commit}), generation
           (int ≥ 0), n_hosts (int ≥ 0) — one transition of the world;
           optional host / failed_host / cursor / window /
           manifest_generation (int), detect_s / shrink_s / stall_s
           (number ≥ 0), attrs (object). ``window`` is one host's folded
           commit window, ``commit`` node 0's committed one (exactly one
           per window over the whole fleet)
clock      peer (str), sent_ts (number), recv_ts (number) — one clock
           sample carried by an exchange the world makes anyway
           (heartbeat, manifest, progress): the peer's clock when it
           published and the local clock when it was read; optional
           generation (int ≥ 0), via (str)
=========  ==============================================================

Any record may carry the ``fleet`` envelope, an object of run_id (str),
host (str), pid (int) and gen (int ≥ 0 | null), validated whenever
present.

The regression gate (:mod:`.regress`) writes one more:

==========  =============================================================
regression  gate (str), metric (str), verdict (str ∈ {green, red, skip}),
            current (number | null), reference (number | null),
            tolerance (number | null) — one tolerance-banded comparison of
            a fresh metric line against its history; optional history_n
            (int ≥ 0)
==========  =============================================================

The JAX package's other types (watchdog, xla_cost) have no object in an
eager torch port; a record of either is rejected, with an error that
names its type.
"""

import json

from .recorder import SCHEMA_VERSION

_NUM = (int, float)

#: versions this validator reads (the JAX package's, up to its v11)
KNOWN_VERSIONS = set(range(1, SCHEMA_VERSION + 1))

#: every record type the port writes, machine-readable
RECORD_TYPES = ("meta", "span", "counter", "gauge", "ledger", "guarantee",
                "tradeoff", "fault", "breaker", "io", "slo", "budget",
                "alert", "control", "probe", "elastic", "clock",
                "regression")

_BREAKER_STATES = frozenset({"closed", "open", "half_open"})

#: the serving controller's action vocabulary
#: (``sq_learn_tpu/obs/schema.py:254``)
_CONTROL_ACTIONS = frozenset({"plan", "hold", "relax", "tighten", "degrade",
                              "recover"})

_PROBE_OUTCOMES = frozenset({"ok", "timeout", "error", "cpu", "skipped"})

#: the regression gate's verdicts (``sq_learn_tpu/obs/schema.py:261``)
_REGRESSION_VERDICTS = frozenset({"green", "red", "skip"})

#: the elastic world's event vocabulary
#: (``sq_learn_tpu/obs/schema.py:199``)
_ELASTIC_EVENTS = frozenset({"world_up", "resume", "host_fail",
                             "host_stall", "shrink", "commit_refused",
                             "stale_exit", "done", "window", "commit"})


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
    elif t == "slo":
        _serving_slo(rec, errors)
    elif t == "budget":
        _serving_budget(rec, errors)
    elif t == "alert":
        _check(isinstance(rec.get("tenant"), str), errors,
               "alert.tenant str")
        _check(isinstance(rec.get("kind"), str), errors, "alert.kind str")
        th = rec.get("threshold")
        _check(_number(th) and th >= 0, errors,
               "alert.threshold non-negative number")
        obj = rec.get("burn_rates")
        _check(isinstance(obj, dict) and all(
            isinstance(k, str) and _number(vv) for k, vv in obj.items()),
            errors, "alert.burn_rates object of str → number")
        if "seq" in rec:
            _check(_int(rec["seq"]) and rec["seq"] >= 0, errors,
                   "alert.seq non-negative int")
    elif t == "control":
        _check(isinstance(rec.get("tenant"), str), errors,
               "control.tenant str")
        _check(rec.get("action") in _CONTROL_ACTIONS, errors,
               f"control.action in {sorted(_CONTROL_ACTIONS)}")
        _check(_int(rec.get("seq")) and rec.get("seq", -1) >= 0, errors,
               "control.seq non-negative int")
        for field in ("inputs", "decision"):
            _check(isinstance(rec.get(field), dict), errors,
                   f"control.{field} object")
        if "level" in rec:
            _check(_int(rec["level"]) and rec["level"] >= 0, errors,
                   "control.level non-negative int")
        if "predicted" in rec:
            _check(isinstance(rec["predicted"], dict), errors,
                   "control.predicted object")
        if "realized" in rec:
            _check(rec["realized"] is None
                   or isinstance(rec["realized"], dict), errors,
                   "control.realized object or null")
        if "site" in rec:
            _check(isinstance(rec["site"], str), errors,
                   "control.site str")
    elif t == "probe":
        _check(rec.get("outcome") in _PROBE_OUTCOMES, errors,
               f"probe.outcome in {sorted(_PROBE_OUTCOMES)}")
        _check(isinstance(rec.get("latency_s"), _NUM)
               and rec["latency_s"] >= 0, errors,
               "probe.latency_s non-negative number")
        _check(isinstance(rec.get("platform"), str), errors,
               "probe.platform str")
        if "cached" in rec:
            _check(isinstance(rec["cached"], bool), errors,
                   "probe.cached bool")
    elif t == "elastic":
        _elastic(rec, errors)
    elif t == "clock":
        _check(isinstance(rec.get("peer"), str), errors, "clock.peer str")
        for field in ("sent_ts", "recv_ts"):
            _check(_number(rec.get(field)), errors, f"clock.{field} number")
        if "generation" in rec:
            _check(_int(rec["generation"]) and rec["generation"] >= 0,
                   errors, "clock.generation non-negative int")
        if "via" in rec:
            _check(isinstance(rec["via"], str), errors, "clock.via str")
    elif t == "regression":
        _check(isinstance(rec.get("gate"), str), errors,
               "regression.gate str")
        _check(isinstance(rec.get("metric"), str), errors,
               "regression.metric str")
        _check(rec.get("verdict") in _REGRESSION_VERDICTS, errors,
               f"regression.verdict in {sorted(_REGRESSION_VERDICTS)}")
        for field in ("current", "reference", "tolerance"):
            _check(field in rec and (rec[field] is None
                                     or _number(rec[field])),
                   errors, f"regression.{field} number or null")
        if "history_n" in rec:
            _check(_int(rec["history_n"]) and rec["history_n"] >= 0,
                   errors, "regression.history_n non-negative int")
    else:
        errors.append(
            f"unknown record type {t!r} (the port writes "
            f"{', '.join(RECORD_TYPES)})")
    if "attrs" in rec and t != "span":
        _check(isinstance(rec["attrs"], dict), errors,
               f"{t}.attrs object")
    if "fleet" in rec:
        _fleet(rec["fleet"], errors)
    return errors


def _elastic(rec, errors):
    _check(rec.get("event") in _ELASTIC_EVENTS, errors,
           f"elastic.event in {sorted(_ELASTIC_EVENTS)}")
    for field in ("generation", "n_hosts"):
        _check(_int(rec.get(field)) and rec[field] >= 0, errors,
               f"elastic.{field} non-negative int")
    for field in ("host", "failed_host", "cursor", "window",
                  "manifest_generation"):
        if field in rec:
            _check(_int(rec[field]), errors, f"elastic.{field} int")
    for field in ("detect_s", "shrink_s", "stall_s"):
        if field in rec:
            _check(_number(rec[field]) and rec[field] >= 0, errors,
                   f"elastic.{field} non-negative number")


def _fleet(fl, errors):
    if not isinstance(fl, dict):
        errors.append("fleet envelope must be an object")
        return
    _check(isinstance(fl.get("run_id"), str), errors, "fleet.run_id str")
    _check(isinstance(fl.get("host"), str), errors, "fleet.host str")
    _check(_int(fl.get("pid")), errors, "fleet.pid int")
    g = fl.get("gen", None)
    _check(g is None or (_int(g) and g >= 0), errors,
           "fleet.gen non-negative int or null")


def _serving_slo(rec, errors):
    _check(isinstance(rec.get("site"), str), errors, "slo.site str")
    _check(_int(rec.get("requests")) and rec["requests"] >= 0, errors,
           "slo.requests non-negative int")
    for field in ("p50_ms", "p99_ms", "qps"):
        _check(_number(rec.get(field)) and rec[field] >= 0, errors,
               f"slo.{field} non-negative number")
    occ = rec.get("batch_occupancy")
    _check(_number(occ) and 0.0 <= occ <= 1.0, errors,
           "slo.batch_occupancy number in [0, 1]")
    _check(_int(rec.get("degraded")) and rec["degraded"] >= 0, errors,
           "slo.degraded non-negative int")
    _check(isinstance(rec.get("violated"), bool), errors, "slo.violated bool")
    if "batches" in rec:
        _check(_int(rec["batches"]), errors, "slo.batches int")
    if "transfer_bytes" in rec:
        _check(_int(rec["transfer_bytes"]) and rec["transfer_bytes"] >= 0,
               errors, "slo.transfer_bytes non-negative int")
    if "window_s" in rec:
        _check(isinstance(rec["window_s"], _NUM) and rec["window_s"] >= 0,
               errors, "slo.window_s non-negative number")
    if "targets" in rec:
        _check(_str_to_number(rec["targets"]), errors,
               "slo.targets object of str → number")
    if "tenant" in rec:
        _check(isinstance(rec["tenant"], str), errors, "slo.tenant str")
    if "stages" in rec:
        obj = rec["stages"]
        _check(isinstance(obj, dict) and all(
            isinstance(k, str) and _number(vv) and vv >= 0
            for k, vv in obj.items()), errors,
            "slo.stages object of str → non-negative number")


def _serving_budget(rec, errors):
    _check(isinstance(rec.get("tenant"), str), errors, "budget.tenant str")
    w = rec.get("window_s")
    _check(_number(w) and w > 0, errors, "budget.window_s positive number")
    for field in ("slo_burn", "stat_burn", "cp_lower_bound"):
        v_ = rec.get(field, None)
        _check(field in rec
               and (v_ is None or (_number(v_) and 0.0 <= v_ <= 1.0)),
               errors, f"budget.{field} number in [0, 1] or null")
    br = rec.get("burn_rate", None)
    _check("burn_rate" in rec and (br is None or (_number(br) and br >= 0)),
           errors, "budget.burn_rate non-negative number or null")
    _check(isinstance(rec.get("alerting"), bool), errors,
           "budget.alerting bool")
    for field in ("requests", "over_p50", "over_p99", "draws",
                  "draw_violations"):
        if rec.get(field) is not None:
            _check(_int(rec[field]) and rec[field] >= 0, errors,
                   f"budget.{field} non-negative int")
    for field in ("p50_ms", "p99_ms", "slo_burn_rate", "stat_burn_rate"):
        if rec.get(field) is not None:
            _check(_number(rec[field]) and rec[field] >= 0, errors,
                   f"budget.{field} non-negative number")
    if "targets" in rec:
        _check(_str_to_number(rec["targets"]), errors,
               "budget.targets object of str → number")
    if "seq" in rec:
        _check(_int(rec["seq"]) and rec["seq"] >= 0, errors,
               "budget.seq non-negative int")


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
