"""Resilience smoke: a streamed fit under an injected fault schedule, on
the card (counterpart of ``sq_learn_tpu/resilience/smoke.py``).

``make faults-smoke-torch`` runs ``python -m
sq_learn_tpu_torch.resilience.smoke --device cuda``. The schedule, end to
end:

1. a **fault-free** streamed qPCA fit (the reference results);
2. the same fit under ``put_fail`` (one transient transfer failure: the
   supervisor's retry must absorb it) plus ``abort`` (a mid-pass
   interrupt after the checkpoint cursor: the pass dies as a wedge would
   kill it);
3. the **rerun**, which must resume the interrupted Gram pass from its
   checkpoint (not tile 0) and finish with results **bit-identical** to
   the fault-free fit;
4. injected **probe timeouts** that trip the circuit breaker
   (``SQ_BREAKER_K=2``), followed by a zero-cooldown half-open whose
   fresh probe of the smoke's device (a subprocess that reaches the card;
   on the CPU the healthy shortcut) closes it again: the full state
   machine, recorded;
5. schema validation of the emitted JSONL: the ``fault`` and ``breaker``
   records must validate against :mod:`sq_learn_tpu_torch.obs.schema`
   and the run must contain the signals this layer exists for.

``--device {cuda,cpu}``: the default is the configured device, the card;
without CUDA the smoke exits 2 before writing anything. Unlike the JAX
smoke it pins no backend in-process: the fits run on the device asked
for. Departure: the JAX smoke's check that the resumed fit stays within
its jit compile budgets has no object in eager torch (no retrace to
count). The summary line adds ``launches`` (the hand-written kernels'
counts: a streamed qPCA launches neither) and ``device``.

Exit code 0 = contract holds; 1 = violation (printed as JSON); 2 = no
such device.
"""

import json
import os
import sys
import tempfile

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.resilience.smoke"


def main(device):
    import numpy as np

    from ..obs import disable, enable, get_recorder
    from ..obs.probe import probe_device
    from ..obs.schema import validate_jsonl
    from . import breaker, faults
    from .faults import InjectedInterrupt

    path = _smoke.artifact_path("faults")
    open(path, "w").close()  # truncate any previous smoke artifact
    enable(path)

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 64)).astype(np.float32)

    ckpt_dir = tempfile.mkdtemp(prefix="sq_faults_smoke_")
    knobs = {
        "SQ_STREAM_TILE_BYTES": str(64 * 1024),   # 8 tiles of 256 rows
        "SQ_STREAM_CKPT_DIR": ckpt_dir,
        "SQ_STREAM_CKPT_EVERY": "2",
        "SQ_BREAKER_K": "2",
        "SQ_BREAKER_COOLDOWN_S": "0",
        "SQ_RETRY_BACKOFF_S": "0.01",
    }
    saved = _knobs.set_env(**knobs)

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    from ..models import QPCA

    def fit():
        return QPCA(n_components=4, svd_solver="full", random_state=0,
                    ingest="streamed", device=device).fit(X)

    try:
        reference = fit()  # fault-free

        # transient transfer failure + mid-pass interrupt: the first
        # attempt must die AT the injected interrupt (after the tile-4
        # checkpoint), having already absorbed the tile-1 put failure
        plan = faults.arm("put_fail:tiles=1,times=1;abort:tile=5,times=1")
        try:
            fit()
        except InjectedInterrupt:
            pass
        else:
            check(False, "injected mid-pass interrupt did not surface")
        check(any(ev["kind"] == "put_fail" for ev in plan.events),
              "no transient transfer failure was injected")
        check(any(ev["kind"] == "abort" for ev in plan.events),
              "no mid-pass interrupt was injected")
        check(any(f.endswith(".npz") for f in os.listdir(ckpt_dir)),
              "interrupted pass left no checkpoint behind")

        # rerun (faults consumed): must RESUME the Gram pass and agree
        # with the fault-free fit bit for bit
        resumed = fit()
        check(get_recorder().counters.get("resilience.resumed_passes", 0)
              >= 1, "rerun did not resume from the checkpoint")
        for attr in ("mean_", "components_", "singular_values_",
                     "explained_variance_", "left_sv"):
            a = np.asarray(getattr(resumed, attr))
            b = np.asarray(getattr(reference, attr))
            check(np.array_equal(a, b),
                  f"resumed fit diverged from fault-free fit on {attr}")
        check(not os.listdir(ckpt_dir),
              "completed pass left its checkpoint behind")

        # breaker: two injected probe timeouts trip it (K=2); the
        # zero-cooldown half-open trial (a fresh probe of this device)
        # closes it again
        faults.arm("probe_timeout:n=2")
        probe_device(platform="cuda", force=True)
        probe_device(platform="cuda", force=True)
        check(breaker.trips >= 1, "probe timeouts did not trip the breaker")
        state = breaker.preflight("smoke", device=device)
        check(state == "closed",
              f"half-open trial did not close the breaker (state={state})")
        seen = [t["state"] for t in breaker.transitions]
        check("open" in seen and "closed" in seen,
              f"breaker transitions incomplete: {seen}")
    finally:
        faults.disarm()
        breaker.reset("smoke teardown")
        _knobs.set_env(**saved)
        for f in os.listdir(ckpt_dir):
            os.remove(os.path.join(ckpt_dir, f))
        os.rmdir(ckpt_dir)

    rec = disable()
    summary = validate_jsonl(path)
    failures.extend(summary["errors"])
    check_types = summary["by_type"]
    if check_types.get("fault", 0) < 3:
        failures.append(f"expected >=3 fault records, got {check_types}")
    if check_types.get("breaker", 0) < 3:  # open, half_open, closed
        failures.append(f"expected >=3 breaker records, got {check_types}")

    print(json.dumps({
        "faults_smoke": "fail" if failures else "ok",
        "path": path,
        "device": str(device),
        "jsonl": check_types,
        "fault_events": len(rec.fault_events),
        "breaker_events": len(rec.breaker_events),
        "launches": _smoke.launches(),
        "errors": failures,
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(_smoke.cli(PROG, __doc__, main))
