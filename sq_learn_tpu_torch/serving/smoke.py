"""Serving smoke: the serving plane's contracts end to end, on the card, in
seconds (counterpart of ``sq_learn_tpu/serving/smoke.py``).

``make serve-smoke-torch`` runs ``python -m sq_learn_tpu_torch.serving.
smoke --device cuda``:

1. fit two tiny tenants (a q-means predict/transform surface and an SVD
   projection surface), **checkpoint them to disk**, and register the
   checkpoint directories, so every resolve takes the digest-verified
   load path, plus a bf16 and an int8 **quantized** registration of the
   same checkpoints;
2. **warm the whole ladder first** (``registry.warm``: digest-verified
   loads and every (kernel, bucket, dtype) signature run once on the
   device), then pin the serving kernels to a flat budget of **0**
   unwarmed signatures under ``SQ_OBS_STRICT=1``: from here on one
   dispatch of an unwarmed signature raises, and every dispatcher must
   end with zero AOT misses;
3. a deterministic micro-batched load (mixed tenants, ops, request
   sizes and input dtypes) through the dispatcher; every response must
   row-match the estimator's own predict/transform surface;
4. a repeated identical transform request: the digest-keyed result
   cache must hit;
5. a fault leg: one transient injected transfer failure absorbed by the
   supervised placement, responses bit-equal to the clean run's;
6. a quantized leg under ``SQ_OBS_AUDIT_STRICT=1``: bf16/int8 responses
   within the declared fold of the exact float64 reference on EVERY
   request;
7. a **cross-tenant megabatch leg**: a second tenant registered from the
   SAME checkpoint (equal fingerprint) submits interleaved with the
   first; the dispatcher must coalesce them into shared kernel launches
   (``serving.megabatches`` ≥ 1), every response must match the
   estimator bit for bit, and the per-tenant slo records must sum
   exactly to the run aggregate;
8. a **feature-cache spill leg**: with ``SQ_SERVE_CACHE_DIR`` armed and
   a 2-entry RAM LRU, an eviction spills a transform result to the
   compressed disk tier; re-requesting it serves a digest-verified disk
   hit bit-equal to compute, and a FRESH process on the same device
   (empty RAM cache, no warm-up, budgets pinned 0 under
   ``SQ_OBS_STRICT=1``) replays the same bytes and serves ≥ 1 disk hit
   with ZERO AOT misses: the working set survives a restart;
9. a **forced SLO violation**: a tenant registered with an impossible
   p99 target burns its error budget in every window (``alerting``
   budget records, an ``alert`` record, a violated per-tenant ``slo``
   record at close), and ``SQ_OBS_BUDGET_STRICT=1`` escalates the same
   close to a raised ``BudgetBurnError`` after the records land;
10. SLO emission and schema validation: the run's JSONL must validate
    and carry ≥ 1 ``slo``, ``fault``, ``guarantee``, ``budget`` and
    ``alert`` record.

``--device {cuda,cpu}``: the default is the configured device, the card;
without CUDA the smoke exits 2 before writing anything. Unlike the JAX
smoke it pins no backend in-process, and the spill process runs on the
parent's device. Departures, where the JAX leg has no object in eager
torch: the watchdog's flat budget of 0 jit compiles becomes **zero AOT
misses after the warm-up** (``MicroBatchDispatcher.aot_stats()["misses"]
== 0``, in this process and in the spill process); the persistent
compile cache and its second-process hit (``persistent_probe``) are not
ported. The summary line adds ``launches`` (the serving kernels are plain
torch; the tenants' fits may launch the Lloyd kernel) and ``device``.

Exit code 0 = contract holds; 1 = violation (printed as JSON); 2 = no
such device.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

from .. import _knobs, _smoke

PROG = "python -m sq_learn_tpu_torch.serving.smoke"


def _host(values):
    """An estimator's output as a host array (a transform on the card
    returns a tensor there)."""
    import numpy as np

    return (values.cpu().numpy() if hasattr(values, "cpu")
            else np.asarray(values))


def _crc(rows):
    import numpy as np

    return zlib.crc32(np.ascontiguousarray(rows).tobytes())


def spill_probe(ckpt_dir, rows_path, device):
    """Second-process feature-cache leg: a FRESH process (empty RAM
    cache, no warm-up, budgets pinned 0 under the inherited
    ``SQ_OBS_STRICT=1``) registers the same checkpoint on ``device``,
    replays the same request bytes, and must serve them as a
    digest-verified disk hit from the parent's ``SQ_SERVE_CACHE_DIR``
    without touching a kernel. Prints one JSON line the parent asserts
    on."""
    import numpy as np

    from . import MicroBatchDispatcher, ModelRegistry, pin_compile_budgets
    from . import cache as serve_cache

    pin_compile_budgets(0)
    reg = ModelRegistry(device=device)
    reg.register("probe", ckpt_dir)
    rows = np.load(rows_path)
    d = MicroBatchDispatcher(reg, background=False)
    out = d.serve("probe", "transform", rows)
    d.close()
    print(json.dumps({"spill_probe": {
        **serve_cache.stats(),
        "aot_misses": d.aot_stats()["misses"],
        "out_crc": _crc(out),
        "launches": _smoke.launches(),
    }}))
    return 0


def tenant_rows(rng=None):
    """The tenant's 600 × 16 training rows, 4 blobs 6 apart: the smoke's
    first draw from ``rng`` (default: a fresh ``default_rng(0)``, the
    smoke's own)."""
    import numpy as np

    rng = np.random.default_rng(0) if rng is None else rng
    return (rng.normal(size=(600, 16))
            + 6.0 * rng.integers(0, 4, size=(600, 1))).astype(np.float32)


def main(device):
    import numpy as np

    from ..models import QKMeans, TruncatedSVD
    from ..obs import disable, enable, get_recorder
    from ..obs.schema import validate_jsonl
    from ..resilience import faults
    from ..resilience.supervisor import breaker
    from ..utils.checkpoint import save_estimator
    from . import MicroBatchDispatcher, ModelRegistry, aot, \
        pin_compile_budgets
    from . import cache as serve_cache
    from . import quantize as quant

    path = _smoke.artifact_path("serve")
    open(path, "w").close()
    enable(path)

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    #: every dispatcher after the warm-up, for the zero-miss contract
    dispatchers = []

    def dispatcher(reg, **kw):
        d = MicroBatchDispatcher(reg, background=False, **kw)
        dispatchers.append(d)
        return d

    rng = np.random.default_rng(0)
    X = tenant_rows(rng)
    m = X.shape[1]
    qkm = QKMeans(n_clusters=4, random_state=0, device=device).fit(X)
    svd = TruncatedSVD(n_components=4, random_state=0, device=device).fit(X)

    tmp = tempfile.mkdtemp(prefix="sq_serve_smoke_")
    alpha_dir = save_estimator(qkm, os.path.join(tmp, "alpha"))
    beta_dir = save_estimator(svd, os.path.join(tmp, "beta"))
    reg = ModelRegistry(device=device)
    reg.register("alpha", alpha_dir)
    reg.register("beta", beta_dir)
    reg.register("alpha_q", alpha_dir, quantize="bf16")
    reg.register("beta_q", beta_dir, quantize="int8")

    # -- the warm-up FIRST, then the zero-miss contract is armed for
    # everything that follows
    warm = reg.warm(buckets=aot.bucket_ladder(8, 512))
    check(all(v == "loaded" for v in warm.values()),
          f"warm did not load every tenant: {warm}")
    check(aot.cache_size() > 0, "the warm-up ran no signature")
    pin_compile_budgets(0)
    strict = _knobs.set_env(SQ_OBS_STRICT=1, SQ_SERVE_AUDIT_EVERY=1)

    sizes = [1, 3, 8, 21, 64]
    requests = []
    for i in range(40):
        rows = rng.normal(size=(sizes[i % len(sizes)], m))
        rows = rows.astype(np.float32 if i % 2 else np.float64)
        tenant, op = [("alpha", "predict"), ("alpha", "transform"),
                      ("beta", "transform")][i % 3]
        requests.append((tenant, op, rows))

    def run_load():
        serve_cache.clear()
        d = dispatcher(reg, max_batch_rows=128)
        futs = [d.submit(t, op, rows) for t, op, rows in requests]
        d.flush()
        outs = [f.result(timeout=30) for f in futs]
        slo = d.close()
        return outs, slo, d

    clean, slo, d0 = run_load()
    check(len(clean) == len(requests), "a request was lost")
    check(slo["requests"] == len(requests),
          f"slo counted {slo['requests']} of {len(requests)} requests")
    check(slo["p99_ms"] >= slo["p50_ms"] >= 0.0, "percentiles disordered")
    check(slo["transfer_bytes"] > 0, "slo recorded no transfer bytes")
    check(d0.aot_stats()["misses"] == 0,
          f"warmed load missed the AOT cache: {d0.aot_stats()}")

    # parity against the estimators' own surfaces
    for (tenant, op, rows), out in zip(requests, clean):
        r32 = rows.astype(np.float32)
        if tenant == "alpha" and op == "predict":
            ref = _host(qkm.predict(r32))
            check(np.array_equal(out, ref),
                  "predict response != estimator predict")
        elif tenant == "alpha":
            ref = _host(qkm.transform(r32))
            check(np.allclose(out, ref, atol=1e-4),
                  "transform response != estimator transform")
        else:
            ref = _host(svd.transform(r32))
            check(np.allclose(out, ref, atol=1e-4),
                  "projection response != estimator transform")

    # repeated identical transform: the digest-keyed cache must hit
    rec = get_recorder()
    probe_rows = requests[1][2]
    d = dispatcher(reg)
    first = d.serve("alpha", "transform", probe_rows)
    hits0 = serve_cache.stats()["hits"]
    second = d.serve("alpha", "transform", probe_rows)
    d.close()
    check(serve_cache.stats()["hits"] == hits0 + 1,
          "repeated identical transform did not hit the result cache")
    check(rec.counters.get("serving.cache_hits", 0) >= 1,
          "close() did not flush the aggregated cache counters")
    check(np.array_equal(first, second), "cache hit diverged from compute")

    # fault leg: one transient transfer failure, absorbed: bit parity
    faults.arm("put_fail:tiles=0,times=1")
    try:
        with _knobs.override(SQ_RETRY_BACKOFF_S=0.001):
            faulted, _, _ = run_load()
    finally:
        faults.disarm()
        breaker.reset("serve smoke teardown")
    check(all(np.array_equal(a, b) for a, b in zip(clean, faulted)),
          "faulted responses are not bit-equal to the clean run")

    # quantized leg under strict audit: every response within the
    # declared fold of the float64 reference
    with _knobs.override(SQ_OBS_AUDIT_STRICT=1):
        dq = dispatcher(reg, max_batch_rows=128)
        for tenant in ("alpha_q", "beta_q"):
            model = reg.resolve(tenant)
            for op in sorted(model.ops):
                for rows in (requests[0][2], requests[3][2]):
                    out = dq.serve(tenant, op, rows)
                    fold = model.quant_folds[op]
                    amax = float(np.max(np.abs(rows)))
                    realized = quant.realized_errors(
                        fold.kind, model.base_kernel(op), rows, out,
                        model.host_params)
                    check(realized <= fold.tol(amax),
                          f"{tenant}/{op}: realized quantization error "
                          f"{realized} exceeds declared fold "
                          f"{fold.tol(amax)}")
        dq.close()

    # cross-tenant megabatch leg: "alpha2" serves the SAME checkpoint as
    # "alpha" (equal fingerprint), so interleaved traffic from both must
    # coalesce into shared launches with exact per-tenant attribution,
    # on the signatures the warm-up ran
    reg.register("alpha2", alpha_dir)
    mega_reqs = [("alpha" if i % 2 else "alpha2", "predict", rows)
                 for i, (_t, _op, rows) in enumerate(requests[:24])]
    serve_cache.clear()
    dm = dispatcher(reg, max_batch_rows=128)
    mega_futs = dm.submit_many(mega_reqs)
    dm.flush()
    mega_outs = [f.result(timeout=30) for f in mega_futs]
    tenant_sums = dm.slo.tenant_summaries()
    mega_slo = dm.close()
    check(dm.megabatches() >= 1,
          "equal-fingerprint tenants never shared a kernel launch")
    check(get_recorder().counters.get("serving.megabatches", 0) >= 1,
          "close() did not flush the serving.megabatches counter")
    for (t, op, rows), out in zip(mega_reqs, mega_outs):
        ref = _host(qkm.predict(rows.astype(np.float32)))
        check(np.array_equal(out, ref),
              f"megabatched {t} response != estimator predict")
    check(set(tenant_sums) >= {"alpha", "alpha2"},
          f"per-tenant attribution missing a tenant: {set(tenant_sums)}")
    check(sum(s["requests"] for s in tenant_sums.values())
          == mega_slo["requests"] == len(mega_reqs),
          "per-tenant slo records do not reconcile to the run aggregate")
    check(sum(s["transfer_bytes"] for s in tenant_sums.values())
          <= mega_slo["transfer_bytes"],
          "per-tenant transfer bytes exceed the aggregate")

    # feature-cache spill leg: with a spill dir armed and a 2-entry RAM
    # LRU, three distinct transform payloads force an eviction to disk;
    # re-requesting the evicted payload must come back as a
    # digest-verified DISK hit, bit-equal to the computed response. Then
    # a FRESH process replays the same bytes against the same dir
    spill_dir = os.path.join(tmp, "feature_cache")
    spill_knobs = _knobs.set_env(SQ_SERVE_CACHE_DIR=spill_dir,
                                 SQ_SERVE_CACHE_ENTRIES=2)
    serve_cache.clear()
    spill_rows = [requests[1][2], requests[4][2], requests[7][2]]
    dsp = dispatcher(reg)
    spill_ref = [dsp.serve("alpha", "transform", r) for r in spill_rows]
    check(serve_cache.stats()["spills"] >= 1,
          "RAM-LRU eviction spilled nothing to the disk tier")
    dh0 = serve_cache.stats()["disk_hits"]
    again = dsp.serve("alpha", "transform", spill_rows[0])
    dsp.close()
    check(serve_cache.stats()["disk_hits"] == dh0 + 1,
          "evicted payload did not come back as a disk hit")
    check(np.array_equal(again, spill_ref[0]),
          "disk hit diverged from the computed response")
    check(get_recorder().counters.get("serving.cache_spills", 0) >= 1,
          "close() did not flush the spill counter")
    rows_path = os.path.join(tmp, "spill_probe_rows.npy")
    np.save(rows_path, spill_rows[0])
    sp = subprocess.run(
        [sys.executable, "-m", "sq_learn_tpu_torch.serving.smoke",
         "--spill-probe", alpha_dir, rows_path, "--device", device.type],
        capture_output=True, text=True, timeout=300,
        env=_smoke.child_env(SQ_SERVE_CACHE_DIR=spill_dir, SQ_OBS="0",
                             SQ_OBS_STRICT="1"))
    probe_stats = {}
    for line in sp.stdout.splitlines():
        try:
            probe_stats = json.loads(line)["spill_probe"]
            break
        except (ValueError, KeyError):
            continue
    check(sp.returncode == 0,
          f"spill probe failed rc={sp.returncode}: {sp.stderr[-500:]}")
    check(probe_stats.get("disk_hits", 0) >= 1,
          f"second process served no disk hit ({probe_stats})")
    check(probe_stats.get("aot_misses", -1) == 0,
          f"second process missed the AOT cache ({probe_stats})")
    check(probe_stats.get("out_crc") == _crc(spill_ref[0]),
          "second process's disk-hit rows differ from the computed "
          "response")
    _knobs.set_env(**spill_knobs)

    # forced-violation leg: a tenant with an impossible p99 target burns
    # its whole latency budget in every window; the close must emit
    # alerting budget records and an alert record, and
    # SQ_OBS_BUDGET_STRICT=1 must escalate the same close to a raise
    # (records land BEFORE the raise). Same checkpoint as alpha, so the
    # warmed signatures are shared and the zero-miss contract holds.
    # autotune=False: this leg asserts the alert FIRES; the control plane
    # exists to prevent exactly that (its own contract is the control
    # smoke), so the static plane is pinned here
    from ..obs.budget import BudgetBurnError

    reg.register("hot", alpha_dir, slo_p99_ms=1e-6)
    dv = dispatcher(reg, max_batch_rows=128, autotune=False)
    for _ in range(6):
        dv.serve("hot", "predict", requests[0][2])
    dv.close()
    rec2 = get_recorder()
    check(any(r.get("alerting") and r.get("tenant") == "hot"
              for r in rec2.budget_records),
          "forced SLO violation produced no alerting budget record")
    check(any(a.get("tenant") == "hot" for a in rec2.alert_records),
          "forced SLO violation fired no alert record")
    check(any(r.get("tenant") == "hot" and r.get("violated")
              for r in rec2.slo_records),
          "forced violation left no violated per-tenant slo record")
    alerts_before = len(rec2.alert_records)
    raised = False
    with _knobs.override(SQ_OBS_BUDGET_STRICT=1):
        dv2 = dispatcher(reg, max_batch_rows=128, autotune=False)
        dv2.serve("hot", "predict", requests[0][2])
        try:
            dv2.close()
        except BudgetBurnError:
            raised = True
    check(raised, "SQ_OBS_BUDGET_STRICT=1 did not raise on a tripped "
                  "burn alert")
    check(len(rec2.alert_records) > alerts_before,
          "the strict raise did not land its alert record first")

    # the zero-miss contract held through every leg: no dispatcher after
    # the warm-up ran an unwarmed signature
    misses = sum(d.aot_stats()["misses"] for d in dispatchers)
    hits = sum(d.aot_stats()["hits"] for d in dispatchers)
    check(misses == 0,
          f"serving path ran {misses} unwarmed signatures after the "
          f"warm-up")
    _knobs.set_env(**strict)
    shutil.rmtree(tmp, ignore_errors=True)

    disable()
    summary = validate_jsonl(path)
    check(not summary["errors"], f"schema errors: {summary['errors'][:5]}")
    for kind in ("slo", "fault", "guarantee", "budget", "alert"):
        check(summary["by_type"].get(kind, 0) >= 1,
              f"expected >=1 {kind} record, got {summary['by_type']}")

    print(json.dumps({
        "serve_smoke": "fail" if failures else "ok",
        "path": path,
        "device": str(device),
        "requests": len(requests),
        "slo": {k: slo[k] for k in ("requests", "p50_ms", "p99_ms", "qps",
                                    "batch_occupancy", "degraded",
                                    "transfer_bytes")},
        "aot": {"signatures": aot.cache_size(), "hits": hits,
                "misses": misses,
                "spill_probe_misses": probe_stats.get("aot_misses"),
                "spill_probe_disk_hits": probe_stats.get("disk_hits")},
        "jsonl": summary["by_type"],
        "launches": _smoke.launches(probe_stats.get("launches")),
        "errors": failures,
    }))
    return 1 if failures else 0


def cli(argv=None):
    ap = _smoke.argument_parser(PROG, __doc__)
    ap.add_argument("--spill-probe", nargs=2, metavar=("CKPT", "ROWS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = _smoke.resolve(PROG, args.device)
    if args.spill_probe:
        return _smoke.run(lambda dev: spill_probe(*args.spill_probe, dev),
                          device)
    return _smoke.run(main, device)


if __name__ == "__main__":
    sys.exit(cli())
