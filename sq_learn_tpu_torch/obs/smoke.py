"""Observability smoke: tiny instrumented fits on the card and the JSONL
schema check (counterpart of ``sq_learn_tpu/obs/smoke.py``).

``make obs-smoke-torch`` runs ``python -m sq_learn_tpu_torch.obs.smoke
--device cuda``: a streamed qPCA Gram fit (streaming counters), a quantum
top-k extraction (nonzero tomography shots in the ledger), a δ-means
sweep point (the fit launches the fused Lloyd kernel; its theoretical
quantum runtime lands as a ``tradeoff`` record), a tiny served tenant
with a declared SLO (per-tenant ``slo`` and error-budget ``budget``
records, and the control plane's close-time ``control`` records), a
fault-injected shrink of the elastic world's in-process simulator
(``elastic`` transition records, the ``window``/``commit`` fold-ledger
events among them, and host-targeted ``fault`` records) under a recorder
carrying a fleet identity (every record gains the ``fleet`` envelope, a
``clock`` sample lands, and :mod:`sq_learn_tpu_torch.obs.fleet` must
reconcile the artifact's commit ledger), and a tiny shard-store pass
feeding the storage ledger (per-shard ``io`` records at flush,
cumulative like counters). Then it validates the emitted JSONL against
:mod:`sq_learn_tpu_torch.obs.schema` (legacy v1–v10 records must keep
validating) and asserts that the artifact carries the signals the layer
exists for.

``--device {cuda,cpu}``: the default is the configured device, the card;
without CUDA the smoke exits 2 before writing anything. Unlike the JAX
smoke it pins no backend in-process: every fit, the served tenant and the
elastic simulator run on the device asked for. Departures, where the JAX
leg has no object in eager torch: no ``xla_cost`` records (XLA's cost
analysis of the streamed kernels) and no ``watchdog`` report (jit
retrace counts), so neither is asserted nor printed. The summary line
adds ``launches`` and ``device``.

Exit code 0 = contract holds; 1 = schema or content violation (printed);
2 = no such device.
"""

import json
import os
import shutil
import sys
import tempfile
import time

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.obs.smoke"

#: records of the versions before the current one, each of which must
#: keep validating
LEGACY = [
    {"v": 1, "ts": 0.0, "type": "counter", "name": "x", "value": 1,
     "delta": 1},
    {"v": 5, "schema_version": 5, "ts": 0.0, "type": "slo",
     "site": "s", "requests": 1, "p50_ms": 1.0, "p99_ms": 2.0,
     "qps": 3.0, "batch_occupancy": 0.5, "degraded": 0,
     "violated": False},
    {"v": 6, "schema_version": 6, "ts": 0.0, "type": "budget",
     "tenant": "t", "window_s": 60.0, "slo_burn": 0.1,
     "stat_burn": None, "cp_lower_bound": None, "burn_rate": 0.2,
     "alerting": False},
    # v7 (before the control plane): budget/alert lines had no emit seq
    {"v": 7, "schema_version": 7, "ts": 0.0, "type": "alert",
     "tenant": "t", "kind": "slo_burn",
     "burn_rates": {"60": 2.5, "600": 2.1}, "threshold": 2.0},
    # v8 (before the elastic world): the control plane's record type
    {"v": 8, "schema_version": 8, "ts": 0.0, "type": "control",
     "tenant": "t", "action": "hold", "seq": 0, "level": 0,
     "inputs": {"burn": 0.1}, "decision": {"route": "device"}},
    # v9 (before the fleet): elastic records without the fleet envelope,
    # the clock type, or the window/commit events
    {"v": 9, "schema_version": 9, "ts": 0.0, "type": "elastic",
     "event": "host_fail", "generation": 0, "n_hosts": 3,
     "failed_host": 2, "window": 3, "detect_s": 0.5},
    # v10 (before the storage ledger): fleet-enveloped clock samples, no
    # io record type yet
    {"v": 10, "schema_version": 10, "ts": 0.0, "type": "clock",
     "peer": "w1", "sent_ts": 0.0, "recv_ts": 0.001, "via": "hb",
     "generation": 0,
     "fleet": {"run_id": "r", "host": "w1", "gen": 0, "pid": 1}},
]


#: the δ-sweep point fits the first SWEEP_ROWS of :func:`fit_rows`
SWEEP_ROWS = 512


def fit_rows(rng=None):
    """The streamed fit's 2048 × 64 rows: the smoke's first draw from
    ``rng`` (default: a fresh ``default_rng(0)``, the smoke's own)."""
    import numpy as np

    rng = np.random.default_rng(0) if rng is None else rng
    return rng.normal(size=(2048, 64)).astype(np.float32)


def main(device):
    import numpy as np

    from . import disable, enable, ledger, set_fleet
    from .schema import validate_jsonl, validate_record

    path = _smoke.artifact_path("obs")
    open(path, "w").close()  # truncate any previous smoke artifact
    enable(path)
    # a fleet identity stamps every later record with the envelope the
    # fleet merge correlates shards by
    set_fleet("obs-smoke-fleet", host="sim")

    rng = np.random.default_rng(0)
    X = fit_rows(rng)

    from ..models import QPCA

    # streamed Gram-route fit: a small tile cap forces a real tile walk
    with _knobs.override(SQ_STREAM_TILE_BYTES=64 * 1024):
        QPCA(n_components=4, svd_solver="full", random_state=0,
             ingest="streamed", device=device).fit(X)

    # quantum extraction: tomography shots and PE queries land in the
    # ledger, and the estimators emit (ε, δ) guarantee draws
    QPCA(n_components=4, svd_solver="full", random_state=0,
         device=device).fit(X[:256], estimate_all=True, theta_major=1.0,
                            eps=0.1, delta=0.5, true_tomography=False)

    # a δ-sweep point joining measured accuracy with the theoretical
    # quantum runtime its budget buys
    from . import frontier, guarantees
    from ..models import QKMeans

    qk = QKMeans(n_clusters=4, n_init=1, delta=0.5,
                 true_distance_estimate=False, random_state=0,
                 device=device).fit(X[:SWEEP_ROWS])
    quantum, classical = qk.quantum_runtime_model(*X[:SWEEP_ROWS].shape)
    frontier.record_tradeoff(
        "smoke_qkmeans_delta", 0.5, accuracy=-float(qk.inertia_),
        accuracy_metric="neg_inertia",
        q_runtime=float(np.ravel(quantum)[0]), c_runtime=float(classical))

    # a tiny serving run with a declared tenant SLO: the dispatcher's
    # close must emit the per-tenant slo record and the per-tenant
    # error-budget evaluations (obs.budget)
    from ..serving import MicroBatchDispatcher, ModelRegistry

    sreg = ModelRegistry(device=device)
    sreg.register("smoke_tenant", qk, slo_p50_ms=5e3, slo_p99_ms=1e4)
    sd = MicroBatchDispatcher(sreg, background=False)
    for i in range(4):
        sd.serve("smoke_tenant", "predict", X[: 4 + i])
    sd.close()

    # a fault-injected shrink of the elastic simulator lands the
    # transition records (world_up → host_fail → shrink → resume → done)
    # and the fault records carry their host targets
    from ..oocore.store import ArraySource
    from ..parallel import elastic
    from ..resilience import faults

    esrc = ArraySource(
        np.asarray(rng.normal(size=(96, 5)), np.float64), shard_rows=8)
    faults.arm("host_stall:window=0,host=1,times=1,s=0.0;"
               "host_fail:window=1,host=2,times=1")
    try:
        eres = elastic.elastic_fit_local(esrc, 3, n_hosts=3, seed=0,
                                         epochs=1, window=4, device=device)
    finally:
        faults.disarm()

    # one clock sample through the elastic plane's emitter: the record
    # type obs.fleet aligns timelines with
    now = time.time()
    elastic._emit_clock("w1", now - 1e-3, now, 0, "hb")

    # a tiny shard-store pass feeds the storage ledger: every read lands
    # in the per-(store, shard) aggregates and the pass-end flush emits
    # cumulative io records (O(#shards), never O(#reads))
    from . import storage as obs_storage
    from ..oocore import store_from_array

    stmp = tempfile.mkdtemp(prefix="sq_obs_smoke_store_")
    try:
        sstore = store_from_array(os.path.join(stmp, "store"),
                                  np.asarray(X[:256], np.float32),
                                  shard_bytes=16 * 1024)
        for i in range(sstore.n_shards):
            sstore.read_shard(i)
            sstore.read_shard(i)  # second touch: reads must aggregate
        io_flushed = obs_storage.flush("pass_end")
    finally:
        shutil.rmtree(stmp, ignore_errors=True)

    totals = ledger.totals()
    audit = guarantees.audit()
    rec = disable()

    summary = validate_jsonl(path)
    failures = list(summary["errors"])
    by_type = summary["by_type"]
    if totals["queries"].get("tomography_shots", 0) <= 0:
        failures.append("ledger has no tomography shots")
    if rec.counters.get("streaming.transfer_bytes", 0) <= 0:
        failures.append("no streamed transfer bytes recorded")
    # the estimators audit their (ε, δ) guarantees and the δ-sweep point
    # lands as a schema-valid tradeoff record with a finite theoretical
    # quantum runtime
    if by_type.get("guarantee", 0) <= 0:
        failures.append("no guarantee records from the estimators")
    flagged = sorted(s for s, a in audit.items() if a["flagged"])
    if flagged:
        failures.append(f"guarantee audit flagged correct routines: "
                        f"{flagged}")
    if by_type.get("tradeoff", 0) <= 0:
        failures.append("no tradeoff records from the smoke sweep point")
    elif not any(isinstance(t.get("q_runtime"), (int, float))
                 for t in rec.tradeoff_records):
        failures.append("tradeoff records carry no finite theoretical "
                        "quantum runtime")
    # the serving leg's per-tenant error budgets landed, and the tenant's
    # slo record carries its declared targets
    if by_type.get("budget", 0) <= 0:
        failures.append("no budget records from the serving leg")
    if not any(r.get("tenant") == "smoke_tenant" for r in rec.slo_records):
        failures.append("no per-tenant slo record from the serving leg")
    if rec.alert_records:
        failures.append(f"burn alert fired under a generous declared "
                        f"SLO: {rec.alert_records}")
    # the serving close runs the control plane's final evaluation: a
    # quiet controller still lands records (a plan and a hold per
    # tenant), and every budget line carries the monotonic emit seq
    if by_type.get("control", 0) <= 0:
        failures.append("no control records from the serving close")
    if not any(r.get("tenant") == "smoke_tenant"
               and r.get("action") == "plan"
               for r in rec.control_records):
        failures.append("the controller never planned the served tenant")
    if not all(isinstance(r.get("seq"), int)
               for r in rec.budget_records):
        failures.append("a budget record landed without its emit seq")
    # the elastic leg survived exactly one host death, its transition
    # records landed schema-valid, and the injected faults carry their
    # host targets
    if eres["shrinks"] != 1 or eres["generation"] != 1:
        failures.append(f"elastic sim did not shrink exactly once: "
                        f"{eres['shrinks']}/{eres['generation']}")
    e_events = [r.get("event") for r in rec.elastic_records]
    for ev in ("world_up", "host_stall", "host_fail", "shrink",
               "resume", "done", "window", "commit"):
        if ev not in e_events:
            failures.append(f"no elastic {ev} record from the sim leg")
    if not any(r.get("kind") in ("host_fail", "host_stall")
               and isinstance(r.get("host"), int)
               for r in rec.fault_events):
        failures.append("no host-targeted fault records from the "
                        "elastic leg")
    # every elastic record carries the fleet envelope (run_id and live
    # generation), a clock sample landed, and the fleet merge reconciles
    # the artifact's commit ledger against itself
    if by_type.get("clock", 0) <= 0:
        failures.append("no clock records in the artifact")
    if not any(isinstance(r.get("fleet"), dict)
               and r["fleet"].get("run_id") == "obs-smoke-fleet"
               and r["fleet"].get("gen") == 1
               for r in rec.elastic_records):
        failures.append("no elastic record carries the fleet envelope "
                        "with the post-shrink generation")
    from .fleet import summarize as fleet_summarize

    fsum = fleet_summarize([path])
    if fsum["run_ids"] != ["obs-smoke-fleet"]:
        failures.append(f"fleet merge lost the run_id: {fsum['run_ids']}")
    frc = fsum["reconciliation"]
    if not frc["ok"] or frc["windows"] != 3:
        failures.append(f"fleet commit-ledger reconciliation broken: "
                        f"{frc}")
    # the shard-store pass landed one cumulative io record per shard
    # (two touches per shard, one line), and the storage CLI's
    # collect/advise run over the artifact
    if io_flushed != sstore.n_shards:
        failures.append(f"storage flush emitted {io_flushed} io records "
                        f"for {sstore.n_shards} shards")
    if by_type.get("io", 0) < sstore.n_shards:
        failures.append(f"artifact carries {by_type.get('io', 0)} io "
                        f"records; expected >= {sstore.n_shards}")
    sview = obs_storage.collect(rec.io_records)
    ooc_led = sview["surfaces"].get("oocore", {}).get(
        sstore.fingerprint, {})
    if sorted(ooc_led) != list(range(sstore.n_shards)):
        failures.append(f"io records missed shards: {sorted(ooc_led)}")
    elif not all(r.get("reads") == 2 for r in ooc_led.values()):
        failures.append("io records did not aggregate both touches "
                        "per shard")
    if obs_storage.advise(sview)["shards"] == []:
        failures.append("storage advisor returned no per-shard rows")
    for r_ in LEGACY:
        errs = validate_record(r_)
        if errs:
            failures.append(f"legacy schema version v{r_['v']} "
                            f"rejected: {errs}")

    print(json.dumps({
        "obs_smoke": "fail" if failures else "ok",
        "path": path,
        "device": str(device),
        "jsonl": by_type,
        "ledger_totals": totals,
        "audit_sites": {s: [a["violations"], a["trials"]]
                        for s, a in sorted(audit.items())},
        "budget_tenants": sorted({r.get("tenant")
                                  for r in rec.budget_records}),
        "launches": _smoke.launches(),
        "errors": failures,
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(_smoke.cli(PROG, __doc__, main))
