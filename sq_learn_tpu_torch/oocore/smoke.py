"""Out-of-core smoke: the shard-store contract end to end, on the card
(counterpart of ``sq_learn_tpu/oocore/smoke.py``).

``make oocore-smoke-torch`` runs ``python -m sq_learn_tpu_torch.oocore.
smoke --device cuda``:

1. build a tiny deterministic synthetic shard store AND its
   ``codec="lz4"`` compressed twin (same seed, same shard split: the
   decoded rows are bit-identical by construction);
2. a **fault-free** multi-epoch mini-batch fit on the SERIAL read path
   over the UNCOMPRESSED store (``SQ_OOC_PREFETCH_DEPTH=0``): the
   reference every later leg must reproduce bit for bit;
3. the same fit over the **compressed store** under ``read_fail`` (one
   transient shard-read failure: the supervisor's retry absorbs it) plus
   ``corrupt_shard`` (a corrupted STORED payload the compressed-bytes CRC
   must catch BEFORE the decoder runs, quarantine, and recover through
   the bounded re-read) **with the shard readahead at depth 3**, bit-equal
   to the uncompressed serial reference;
4. a REAL subprocess kill ON THE COMPRESSED STORE: a child process on the
   parent's device runs the same fit with mid-epoch checkpoints and
   readahead, under injected read stalls; the parent SIGKILLs it the
   moment the first checkpoint lands, and a clean rerun **resumes from
   the checkpoint** and finishes bit-identical to the reference;
5. the labelling pass (:func:`~sq_learn_tpu_torch.oocore.assign_labels`)
   of the uncompressed store under the reference centers: one launch of
   the fused Lloyd kernel per 1024-row tile on the card, held against the
   float64 distances computed on the host (labels equal wherever the two
   nearest centers are farther apart than the float32 error, inertia
   within rtol 1e-4);
6. schema validation of the emitted JSONL: the read-side ``fault``
   records, the ``oocore.*`` counters (the codec byte pair included) and
   the readahead hit/stall counters, plus the storage ledger
   (:mod:`sq_learn_tpu_torch.obs.storage`): cumulative per-shard ``io``
   records covering every compressed shard, the ``corrupt_shard``
   quarantine attributed to its owning shard although it fired on a
   readahead thread, and O(#shards) lines per flush, never O(#reads).

``FIT`` and ``STORE`` are the JAX smoke's, verbatim. ``--device
{cuda,cpu}``: the default is the configured device, the card; without
CUDA the smoke exits 2 before writing anything. Unlike the JAX smoke it
pins no backend in-process, and the child runs on the parent's device.
Leg 5 is the port's own: the JAX smoke's fit leaves labelling to the
estimator, and the port's labelling pass is where the store plane
launches the Lloyd kernel. The summary line adds ``launches`` (the
resumed child's counts summed in; the killed child reports nothing) and
``device``.

Exit code 0 = contract holds; 1 = violation (printed as JSON); 2 = no
such device.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.oocore.smoke"

#: one fit configuration, shared verbatim by every leg (reference,
#: faulted, killed child, resumed child): parity only means anything if
#: the schedule fingerprint is identical
FIT = dict(n_clusters=6, batch_rows=256, max_epochs=4, seed=5)
STORE = dict(n_samples=6000, n_features=32, n_classes=6, seed=11)
#: the labelling pass's tile, as the store-backed estimator labels
LABEL_ROWS = 1024
#: labels may differ only where the two nearest centers' float64 squared
#: distances are closer than this share of the nearest (float32 error)
LABEL_TIE_RTOL = 1e-4
INERTIA_RTOL = 1e-4


def _child(store_path, out_path, device):
    """Child mode: run the fit on ``device`` (checkpointing via the
    inherited ``SQ_STREAM_CKPT_DIR``) and save the result with the child's
    kernel launches."""
    import numpy as np

    from . import minibatch_epoch_fit, open_store

    out = minibatch_epoch_fit(open_store(store_path), device=device, **FIT)
    launched = _smoke.launches()
    np.savez(out_path, centers=out["centers"], counts=out["counts"],
             resumed_from=np.asarray(out["resumed_from"]),
             lloyd_step=np.asarray(launched["lloyd_step"]),
             argkmin=np.asarray(launched["argkmin"]))
    return 0


def _label_check(store, centers, device, check):
    """Leg 5: the store's labels on ``device`` against the host's float64
    distances."""
    import numpy as np

    from . import assign_labels

    labels, inertia = assign_labels(store, centers, batch_rows=LABEL_ROWS,
                                    device=device)
    X = np.concatenate([store.read_shard(i) for i in range(store.n_shards)])
    C = np.asarray(centers, np.float64)
    d2 = ((X.astype(np.float64)[:, None, :] - C[None]) ** 2).sum(-1)
    order = np.sort(d2, axis=1)
    decided = order[:, 1] - order[:, 0] > LABEL_TIE_RTOL * order[:, 0]
    want = d2.argmin(axis=1)
    check(labels.shape == (store.shape[0],)
          and np.array_equal(labels[decided], want[decided]),
          f"labelling pass disagrees with the float64 argmin on "
          f"{int(np.sum(labels[decided] != want[decided]))} decided rows")
    exact = float(order[:, 0].sum())
    check(abs(inertia - exact) <= INERTIA_RTOL * exact,
          f"labelling pass inertia {inertia} against float64 {exact}")


def main(device):
    import numpy as np

    from ..obs import disable, enable, get_recorder
    from ..obs.schema import validate_jsonl
    from ..resilience import faults
    from . import create_synthetic_store, minibatch_epoch_fit, open_store

    path = _smoke.artifact_path("oocore")
    open(path, "w").close()
    enable(path)

    tmp = tempfile.mkdtemp(prefix="sq_oocore_smoke_")
    store_path = os.path.join(tmp, "store")
    ckpt_dir = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt_dir)
    out_path = os.path.join(tmp, "resumed.npz")

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    store = create_synthetic_store(store_path, shard_bytes=64 * 1024,
                                   **STORE)
    # the compressed twin: same seed + shard split => decoded rows are
    # bit-identical; everything from here on reads THIS store, pinned
    # against the uncompressed serial reference
    cstore_path = os.path.join(tmp, "store_lz4")
    cstore = create_synthetic_store(cstore_path, shard_bytes=64 * 1024,
                                    codec="lz4", **STORE)
    check(cstore.codec == "lz4", "compressed twin did not record codec")
    check(cstore.stored_nbytes < cstore.nbytes,
          "compressed twin stored no fewer bytes than raw")
    # the reference runs the SERIAL read path: the prefetched legs below
    # must reproduce it bit for bit (depth-0-vs-depth-d acceptance pin)
    with _knobs.override(SQ_OOC_PREFETCH_DEPTH=0):
        reference = minibatch_epoch_fit(store, device=device, **FIT)

    # -- read faults UNDER PREFETCH, over the COMPRESSED store: transient
    # failure + stored-payload corruption fire on worker threads (the CRC
    # catches the corruption BEFORE decode), absorbed with bit parity
    # against the uncompressed serial run ----------------------------------
    plan = faults.arm("read_fail:tiles=1,times=1;"
                      "corrupt_shard:tiles=2,times=1")
    with _knobs.override(SQ_OOC_PREFETCH_DEPTH=3, SQ_OOC_PREFETCH_THREADS=2):
        faulted = minibatch_epoch_fit(open_store(cstore_path),
                                      device=device, **FIT)
    faults.disarm()
    check(any(ev["kind"] == "read_fail" for ev in plan.events),
          "no transient read failure was injected")
    check(any(ev["kind"] == "corrupt_shard" for ev in plan.events),
          "no shard corruption was injected")
    check(np.array_equal(faulted["centers"], reference["centers"]),
          "fault-injected compressed prefetched fit diverged from the "
          "uncompressed serial fit")
    rec = get_recorder()
    check(rec.counters.get("oocore.rereads", 0) >= 1,
          "corrupted shard was not re-read")
    check(rec.counters.get("oocore.crc_failures", 0) >= 1,
          "manifest CRC did not catch the corruption")
    check(rec.counters.get("oocore.codec_bytes_out", 0)
          >= cstore.nbytes,
          "codec counters did not account one epoch of decoded bytes")
    pf_gets = (rec.counters.get("oocore.prefetch_hits", 0)
               + rec.counters.get("oocore.prefetch_stalls", 0))
    check(pf_gets >= store.n_shards,
          f"prefetcher served {pf_gets} shard reads; expected at least "
          f"one epoch's worth ({store.n_shards})")

    # -- the real kill: SIGKILL mid-epoch ON THE COMPRESSED STORE, then
    # resume ------------------------------------------------------------
    env = _smoke.child_env(
        SQ_STREAM_CKPT_DIR=ckpt_dir,
        SQ_STREAM_CKPT_EVERY="2",
        SQ_OBS="0",
        # prefetch ON in the killed child: the SIGKILL lands mid-epoch AND
        # mid-prefetch (workers mid-stall or mid-decode), and the resume
        # must still be bit for bit
        SQ_OOC_PREFETCH_DEPTH="3",
        SQ_OOC_PREFETCH_THREADS="2",
        # every shard read stalls 0.1 s so the parent reliably catches the
        # child mid-epoch
        SQ_FAULTS="read_stall:p=1,s=0.1,times=999")
    cmd = [sys.executable, "-m", "sq_learn_tpu_torch.oocore.smoke",
           "--child", cstore_path, out_path, "--device", device.type]
    child = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)

    def _ckpts():
        # the atomic-write temporary ("*.npz.tmp.npz") is transient: only
        # a completed rename counts as "a checkpoint landed"
        return [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                if f.endswith(".npz") and not f.endswith(".tmp.npz")]

    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and child.poll() is None:
        if _ckpts():
            break
        time.sleep(0.01)
    if child.poll() is None:
        child.send_signal(signal.SIGKILL)
    rc = child.wait()
    ckpt_file = (sorted(_ckpts()) or [None])[0]
    check(rc == -signal.SIGKILL,
          f"child was not SIGKILLed mid-fit (rc={rc}; a 0 means it "
          f"finished before the kill: stalls too short)")
    check(ckpt_file is not None and os.path.exists(ckpt_file),
          "killed child left no checkpoint behind")
    check(not os.path.exists(out_path),
          "killed child somehow wrote its result")
    cursor = None
    if ckpt_file:
        with np.load(ckpt_file, allow_pickle=False) as npz:
            cursor = int(npz["__cursor__"])
        check(cursor >= 1, f"checkpoint cursor {cursor} is pre-first-batch")

    env_resume = dict(env)
    env_resume.pop("SQ_FAULTS")  # clean rerun: no stalls, same ckpt dir
    rc = subprocess.run(cmd, env=env_resume, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL, timeout=600).returncode
    check(rc == 0, f"resume run failed (rc={rc})")
    child_launches = {}
    if rc == 0:
        with np.load(out_path, allow_pickle=False) as npz:
            check(int(npz["resumed_from"]) >= 1,
                  "rerun did not resume from the checkpoint")
            check(np.array_equal(npz["centers"], reference["centers"]),
                  "resumed fit diverged from the uninterrupted fit")
            check(np.array_equal(npz["counts"], reference["counts"]),
                  "resumed counts diverged from the uninterrupted fit")
            child_launches = {k: int(npz[k])
                              for k in ("lloyd_step", "argkmin")}
    check(not os.listdir(ckpt_dir),
          "completed fit left checkpoint files behind")

    # -- the labelling pass through the Lloyd kernel ------------------------
    _label_check(store, reference["centers"], device, check)
    shutil.rmtree(tmp, ignore_errors=True)

    rec = disable()
    summary = validate_jsonl(path)
    failures.extend(summary["errors"])
    by_type = summary["by_type"]
    if by_type.get("fault", 0) < 2:
        failures.append(f"expected >=2 fault records, got {by_type}")

    # the storage ledger saw every compressed shard, aggregated the whole
    # fit into cumulative io records (one line per shard per flush, NOT
    # per read), and the worker-thread quarantine landed on the shard that
    # owns it
    from ..obs import storage as obs_storage

    sview = obs_storage.collect(rec.io_records)
    cshards = (sview["surfaces"].get("oocore", {})
               .get(cstore.fingerprint, {}))
    check(sorted(cshards) == list(range(cstore.n_shards)),
          f"io records did not cover the compressed store's shards: "
          f"{sorted(cshards)}")
    check(all(r.get("codec") == "lz4" for r in cshards.values()),
          "compressed-store io records lost their codec tag")
    check(all(r.get("reads", 0) >= FIT["max_epochs"]
              for r in cshards.values()),
          "io records did not aggregate every epoch's reads")
    check(any(r.get("quarantined", 0) >= 1 for r in cshards.values()),
          "corrupt_shard quarantine not attributed to its owning shard")
    per_key = {}
    for r in rec.io_records:
        k = (r.get("surface"), r.get("store"), r.get("shard"))
        per_key[k] = per_key.get(k, 0) + 1
    worst = max(per_key.values(), default=0)
    check(worst <= FIT["max_epochs"] + 2,
          f"io records flood the sink ({worst} lines for one shard: "
          f"per-read emission, not pre-aggregation)")

    print(json.dumps({
        "oocore_smoke": "fail" if failures else "ok",
        "path": path,
        "device": str(device),
        "jsonl": by_type,
        "kill_cursor": cursor,
        "fault_events": len(rec.fault_events),
        "codec_ratio": round(cstore.stored_nbytes / cstore.nbytes, 3),
        "launches": _smoke.launches(child_launches),
        "errors": failures,
    }))
    return 1 if failures else 0


def cli(argv=None):
    ap = _smoke.argument_parser(PROG, __doc__)
    ap.add_argument("--child", nargs=2, metavar=("STORE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = _smoke.resolve(PROG, args.device)
    if args.child:
        return _smoke.run(lambda dev: _child(*args.child, dev), device)
    return _smoke.run(main, device)


if __name__ == "__main__":
    sys.exit(cli())
