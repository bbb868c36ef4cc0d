"""Elastic-world smoke: survive a real host death mid-fit, bit for bit,
on the card (counterpart of ``sq_learn_tpu/parallel/elastic_smoke.py``).

``make elastic-smoke-torch`` runs ``python -m sq_learn_tpu_torch.
parallel.elastic_smoke --device cuda`` (no network beyond loopback):

1. build a tiny shard store on disk;
2. pin the topology invariance in-process: the window-synchronous fold's
   :func:`~sq_learn_tpu_torch.parallel.elastic.elastic_fit_local` at 1, 2
   and 3 logical hosts returns bit-identical state;
3. run a REAL uninterrupted 2-worker fit (separate processes, a
   coordinator-owned TCPStore, the certification's gloo group) and
   assert it equals the simulator bit for bit;
4. run a REAL 3-worker fit with a scripted SIGKILL of worker 2 once two
   windows are committed (the victim is held at window 2 by a 5 s
   ``host_stall`` so the kill lands mid-epoch however fast the windows
   run): the survivors must detect the death through their leases,
   shrink to a 2-host generation-1 world, resume from the committed
   checkpoint, and finish **bit-identical to the uninterrupted run** with
   every shard folded exactly ``epochs`` times (zero lost, zero folded
   twice);
5. validate every worker's obs JSONL and assert that the elastic
   transition records (``world_up``/``host_fail``/``resume``/``done``
   across generations 0 and 1) carry the detection latency and the
   shrink wall clock;
6. merge the run's per-process shards (coordinator and all three
   workers) into ONE fleet timeline (:mod:`sq_learn_tpu_torch.obs.
   fleet`): one coordinator-minted run id, a monotone ``ts_fleet``, the
   SIGKILLed worker's fold progress up to its last flush, a commit
   ledger that reconciles (every committed window exactly once), a
   generation-1 detect → shrink → re-init → resume critical path, and
   the merged timeline archived, schema-valid, outside the scratch
   directory: at ``SQ_OBS_PATH`` when it is set, else
   ``sq_elastic_smoke-torch.jsonl`` in the temporary directory.

``--device {cuda,cpu}``: the default is the configured device, the card.
With ``cuda`` the simulator runs on the card and worker i on ``cuda:<i %
cards>``; with ``cpu`` everything runs on the CPU. Without CUDA the
smoke exits 2 before writing anything. Unlike the JAX smoke it pins no
backend in-process. Where it departs from the JAX smoke: each worker
holds one device (the JAX workers hold two virtual CPU devices); the
heartbeat and lease are the ``SQ_ELASTIC_HEARTBEAT_S``/
``SQ_ELASTIC_LEASE_S`` knobs, set to the JAX smoke's 0.2 s and 1.5 s
unless the environment sets them; the victim's ``host_stall`` is the
port's (the JAX smoke relies on its windows being slow); the merged
timeline's place (the JAX smoke reads a bench knob the port does not
have). This process records nothing itself (a run ``SQ_OBS=1`` opened at
import is closed first). The summary line adds ``launches`` (the
workers' certifications launch the Lloyd kernel), ``device`` and
``state``, the final fold state (centers, counts, inertia, folds).

Exit code 0 = contract holds; 1 = violation (printed as JSON); 2 = no
such device.
"""

import json
import os
import shutil
import sys
import tempfile

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.parallel.elastic_smoke"

#: the fit: 240 × 6 float64 rows in 20 shards of 12 rows
EPOCHS, WINDOW, K, SEED = 2, 4, 4, 5
#: the victim and the committed cursor at which it dies (two windows)
VICTIM, KILL_CURSOR = 2, 2 * WINDOW
#: holds the victim at the window after the kill cursor
VICTIM_STALL = f"host_stall:window=2,host={VICTIM},times=1,s=5"
TIMEOUT_S = 240


def _same(a, b):
    import numpy as np

    return (np.array_equal(a["centers"], b["centers"])
            and np.array_equal(a["counts"], b["counts"]))


def main(device):
    import numpy as np

    from .. import obs
    from ..obs import fleet
    from ..obs.schema import validate_jsonl
    from ..oocore.store import open_store, store_from_array
    from . import elastic

    obs.disable()  # this process records nothing; its workers do
    _knobs.setdefault("SQ_ELASTIC_HEARTBEAT_S", "0.2")
    _knobs.setdefault("SQ_ELASTIC_LEASE_S", "1.5")
    worker_device = None if device.type == "cuda" else "cpu"

    failures = []
    base = tempfile.mkdtemp(prefix="sq_elastic_smoke_")
    summary = {"dir": base, "device": str(device)}
    launched = []
    try:
        rng = np.random.default_rng(11)
        X = np.asarray(rng.normal(size=(240, 6)), np.float64)
        store_path = os.path.join(base, "store")
        store_from_array(store_path, X, shard_bytes=6 * 48)
        src = open_store(store_path)
        n_shards = int(src.n_shards)
        summary["n_shards"] = n_shards

        # -- 1) topology invariance of the pure core -----------------------
        sims = [elastic.elastic_fit_local(src, K, n_hosts=n, seed=SEED,
                                          epochs=EPOCHS, window=WINDOW,
                                          device=device)
                for n in (1, 2, 3)]
        ref = sims[1]
        for n, sim in zip((1, 2, 3), sims):
            if not _same(ref, sim):
                failures.append(f"simulator at n_hosts={n} diverges from "
                                f"the n_hosts=2 reference")
        if not (ref["folds"] == EPOCHS).all():
            failures.append(f"simulator fold ledger broken: {ref['folds']}")
        summary["state"] = {"centers": ref["centers"].tolist(),
                            "counts": ref["counts"].tolist(),
                            "inertia": ref["inertia"],
                            "folds": ref["folds"].tolist()}

        # -- 2) real uninterrupted 2-worker run ----------------------------
        co2 = elastic.ElasticCoordinator(
            os.path.join(base, "run2"), store_path, n_workers=2,
            n_clusters=K, seed=SEED, epochs=EPOCHS, window=WINDOW,
            device=worker_device)
        r2 = co2.run(timeout_s=TIMEOUT_S)
        launched.append(r2["launches"])
        summary["uninterrupted"] = {"generation": r2["generation"],
                                    "exit_codes": r2["exit_codes"]}
        if not _same(r2, ref):
            failures.append("real 2-worker run diverges from the simulator")
        if r2["generation"] != 0 or any(c != 0
                                        for c in r2["exit_codes"].values()):
            failures.append(f"uninterrupted run not clean: "
                            f"{r2['exit_codes']}")

        # -- 3) real 3-worker run, one worker SIGKILLed mid-epoch ----------
        run3 = os.path.join(base, "run3")
        co3 = elastic.ElasticCoordinator(
            run3, store_path, n_workers=3, n_clusters=K, seed=SEED,
            epochs=EPOCHS, window=WINDOW, device=worker_device,
            kill=(VICTIM, KILL_CURSOR))
        # the workers' fault plan only: this process armed its plan at
        # import
        with _knobs.override(SQ_FAULTS=VICTIM_STALL):
            r3 = co3.run(timeout_s=TIMEOUT_S)
        launched.append(r3["launches"])
        summary["killed"] = {
            "generation": r3["generation"], "n_hosts": r3["n_hosts"],
            "shrinks": r3["shrinks"], "killed": r3["killed"],
            "exit_codes": r3["exit_codes"]}
        if r3["generation"] != 1 or r3["n_hosts"] != 2 \
                or r3["shrinks"] != 1:
            failures.append(f"kill leg did not shrink 3->2 exactly once: "
                            f"{summary['killed']}")
        if r3["exit_codes"].get(VICTIM) != -9:
            failures.append(f"victim did not die by SIGKILL: "
                            f"{r3['exit_codes']}")
        if any(r3["exit_codes"].get(w) != 0 for w in (0, 1)):
            failures.append(f"a survivor exited non-zero: "
                            f"{r3['exit_codes']}")
        # THE claim: interrupted-and-shrunk == uninterrupted, bit for bit
        if not _same(r3, ref):
            failures.append("killed run diverges from the uninterrupted "
                            "reference (bit parity broken)")
        if not (r3["folds"] == EPOCHS).all():
            failures.append(f"shards lost or double-folded across the "
                            f"shrink: {r3['folds'].tolist()}")

        # -- 4) the timeline is in the artifact ----------------------------
        recs = elastic.collect_elastic_records(run3)
        events = {(r["_worker"], r["event"], r["generation"])
                  for r in recs}
        for w in ("0", "1"):
            for needed in ((w, "world_up", 0), (w, "host_fail", 0),
                           (w, "world_up", 1), (w, "resume", 1),
                           (w, "done", 1)):
                if needed not in events:
                    failures.append(f"missing elastic record {needed}")
        if (str(VICTIM), "world_up", 0) not in events:
            failures.append("the victim never recorded joining g0")
        detect = [r["detect_s"] for r in recs
                  if r["event"] == "host_fail" and "detect_s" in r]
        shrink = [r["shrink_s"] for r in recs
                  if r["event"] == "world_up" and r["generation"] == 1
                  and "shrink_s" in r]
        if not detect or not all(d > 0 for d in detect):
            failures.append(f"no positive detection latency: {detect}")
        if not shrink or not all(s > 0 for s in shrink):
            failures.append(f"no positive shrink wall-clock: {shrink}")
        summary["detect_s"] = detect
        summary["shrink_s"] = shrink
        for w in (0, 1, 2):
            s = validate_jsonl(os.path.join(run3, f"obs.w{w}.jsonl"))
            if s["errors"]:
                failures.append(f"worker {w} JSONL schema errors: "
                                f"{s['errors'][:3]}")

        # -- 5) one fleet-wide timeline ------------------------------------
        shards = fleet.load_shards(run3)
        fsum = fleet.summarize(shards)
        summary["fleet"] = {
            "run_ids": fsum["run_ids"], "hosts": fsum["hosts"],
            "generations": fsum["generations"],
            "clock_offsets_s": fsum["clock_offsets_s"],
            "critical_path": fsum["critical_path"],
            "reconciliation": fsum["reconciliation"]}
        if len(fsum["run_ids"]) != 1:
            failures.append(f"shards disagree on the fleet run_id: "
                            f"{fsum['run_ids']}")
        if set(fsum["hosts"]) != {"coord", "w0", "w1", "w2"}:
            failures.append(f"fleet merge does not cover coordinator + "
                            f"all workers: {fsum['hosts']}")
        merged = fleet.merge(shards)
        ts_fleet = [r["ts_fleet"] for r in merged]
        if ts_fleet != sorted(ts_fleet):
            failures.append("merged timeline not monotone in ts_fleet")
        # crash-safe telemetry: the SIGKILLed worker's shard still holds
        # its fold progress up to its last flush
        if not any(r["_host"] == f"w{VICTIM}" and r.get("type") == "elastic"
                   and r.get("event") == "window" for r in merged):
            failures.append("the victim's shard lost its flushed "
                            "window records")
        # the commit ledger's obs twin: every committed window exactly
        # once across hosts and generations, no gaps
        n_windows = EPOCHS * (-(-n_shards // WINDOW))
        frc = fsum["reconciliation"]
        if not frc["ok"] or frc["windows"] != n_windows:
            failures.append(f"commit-ledger reconciliation broken "
                            f"(want {n_windows} windows): {frc}")
        cp = [p for p in fsum["critical_path"] if p["generation"] == 1]
        if not cp or not isinstance(cp[0]["total_s"], (int, float)) \
                or cp[0]["total_s"] <= 0:
            failures.append(f"no generation-1 shrink critical path: "
                            f"{fsum['critical_path']}")
        if not any(r.get("type") == "clock" and r["_host"] in
                   ("w0", "w1") for r in merged):
            failures.append("no survivor recorded a clock sample")
        # archive the merged, clock-aligned timeline before the scratch
        # directory goes away
        merged_path = _smoke.artifact_path("elastic")
        fleet.write_merged(shards, merged_path)
        sm = validate_jsonl(merged_path)
        if sm["errors"]:
            failures.append(f"merged fleet timeline schema errors: "
                            f"{sm['errors'][:3]}")
        summary["merged"] = merged_path
    finally:
        shutil.rmtree(base, ignore_errors=True)

    summary["launches"] = _smoke.launches(*launched)
    summary["elastic_smoke"] = "fail" if failures else "ok"
    summary["errors"] = failures
    print(json.dumps(summary))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(_smoke.cli(PROG, __doc__, main))
