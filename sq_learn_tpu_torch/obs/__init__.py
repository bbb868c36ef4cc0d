"""Run-scoped observability (counterpart of ``sq_learn_tpu/obs``, its
research half): spans, counters and gauges, the quantum-runtime ledger,
the (ε, δ) guarantee auditor and the accuracy-vs-runtime frontier, in the
JAX package's JSONL record format.

Quickstart::

    from sq_learn_tpu_torch import obs

    obs.enable("/tmp/run.jsonl")          # or export SQ_OBS=1
    with obs.span("my.step", n=1000):
        ...
    print(obs.ledger.totals())
    print(obs.guarantees.render(obs.guarantees.audit()))
    obs.disable()                          # flush the sink

Environment: ``SQ_OBS=1`` enables at import with a JSONL sink at
``SQ_OBS_PATH`` (default ``sq_obs.jsonl``); ``SQ_OBS_AUDIT_STRICT=1``
makes a flagged guarantee site raise. The files are read by
``python -m sq_learn_tpu_torch.obs
{audit,frontier,trace,storage,report,budget,control,fleet,regress}``, and
by the JAX package's readers. :mod:`.storage` is the out-of-core plane's per-shard
ledger; :mod:`.trace` renders a run as a Chrome trace
(``SQ_OBS_TRACE``); ``SQ_OBS_ROTATE_BYTES`` rotates the sink. The
serving plane's half: :mod:`.budget` (the per-tenant error-budget
ledger), :mod:`.control` (the controller's decision history),
:mod:`.probe` (the device-health probe) and :mod:`.report` (the whole
run, for a person). The elastic world's half: the fleet envelope
(``SQ_OBS_FLEET_RUN_ID``/``SQ_OBS_FLEET_HOST``, :func:`set_fleet`,
:func:`set_generation`; ``SQ_OBS_FLEET_DIR`` shards the sinks per
process) and :mod:`.fleet`, which merges the shards of one run into a
clock-aligned timeline and reconciles its commit ledger. :mod:`.regress`
bands a fresh bench record against its history (latency, transfer bytes,
the measured peak device memory), its ``--selftest`` a real injected
regression.

Not ported: ``xla.py`` (XLA's per-compilation cost analysis) and
``watchdog.py`` (jit retrace counts) have no object in an eager torch
port.
"""

from . import (budget, control, fleet, frontier, guarantees, ledger, probe,
               regress, report, schema, storage, trace)
from .recorder import (NULL_SPAN, Recorder, counter_add, disable, enable,
                       enabled, flush, gauge, get_recorder, record_span,
                       set_fleet, set_generation, snapshot, span)

#: convenience alias: obs.ledger_record(...) == obs.ledger.record(...)
ledger_record = ledger.record

__all__ = [
    "NULL_SPAN",
    "Recorder",
    "budget",
    "control",
    "counter_add",
    "disable",
    "enable",
    "enabled",
    "fleet",
    "flush",
    "frontier",
    "gauge",
    "get_recorder",
    "guarantees",
    "ledger",
    "ledger_record",
    "probe",
    "record_span",
    "regress",
    "report",
    "schema",
    "set_fleet",
    "set_generation",
    "snapshot",
    "span",
    "storage",
    "trace",
]
