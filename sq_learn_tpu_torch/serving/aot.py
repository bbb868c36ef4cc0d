"""Ladder warm-up: every serving signature runs once before traffic
(counterpart of ``sq_learn_tpu/serving/aot.py``).

The JAX package compiles each serving kernel ahead of time, per (bucket,
dtype, model shape) signature, so no request pays an XLA lowering. Eager
torch compiles nothing, but a first call still pays: the cuBLAS handle
and its workspace, the caching allocator's first blocks of each size, the
first launch of each kernel. This module moves those costs to warm time
over the same product the JAX package walks:

- **The ladder is enumerable.** The dispatcher pads every batch to the
  pow2 bucket ladder between ``SQ_SERVE_MIN_BUCKET_ROWS`` and
  ``SQ_SERVE_MAX_BATCH_ROWS``; each model serves a fixed kernel set with
  fixed param shapes, in its one transfer dtype. :func:`warm_model` walks
  kernel set × :func:`bucket_ladder` × :func:`serve_dtypes` and runs each
  signature once, eagerly, on the model's device (zeros of the
  signature's shapes), synchronized. ``SQ_SERVE_AOT=0`` (or
  ``warm(aot=False)`` on the registry) skips the walk.
- **Dispatches look up the warmed signature.** :func:`lookup` resolves a
  dispatch to its warmed kernel, keyed by device and the exact
  ``(kernel, ((shape, dtype), ...))`` signature of
  :meth:`~sq_learn_tpu_torch.serving.registry.ServingModel.aot_signature`
  (the JAX package's key). A miss still serves, through the same kernel;
  the dispatcher counts it, and once budgets are pinned
  (:func:`~sq_learn_tpu_torch.serving.dispatcher.pin_compile_budgets`) a
  miss is an ``aot_cache_miss`` that raises under ``SQ_OBS_STRICT=1``.

Obs counters keep the JAX package's names: ``serving.aot_compiles``
(signatures warmed), ``serving.aot_cache_hits`` /
``serving.aot_cache_misses`` (dispatch-time lookups, flushed by the
dispatcher at close).

Not ported: ``enable_persistent_cache`` / ``persistent_cache_stats`` (XLA's
persistent compile cache): eager torch compiles nothing to persist.
"""

import threading

import torch

from .. import _knobs
from .. import obs as _obs

__all__ = ["bucket_ladder", "cache_size", "clear", "lookup", "serve_dtypes",
           "warm", "warm_model"]

_lock = threading.Lock()

#: (device, kernel name, ((shape, dtype name), ...)) → kernel. Two tenants
#: with equal shapes share one entry, so a megabatch of same-fingerprint
#: tenants resolves to the entry a single-tenant batch would
_warmed = {}


def bucket_ladder(min_rows=None, max_rows=None):
    """The dispatcher's padded-shape ladder: pow2 buckets from the serving
    floor up to (and always including) the batch row cap."""
    lo = (_knobs.get_int("SQ_SERVE_MIN_BUCKET_ROWS") if min_rows is None
          else int(min_rows))
    hi = (_knobs.get_int("SQ_SERVE_MAX_BATCH_ROWS") if max_rows is None
          else int(max_rows))
    b, out = max(1, lo), []
    while b < hi:
        out.append(b)
        b <<= 1
    out.append(hi)
    return out


def serve_dtypes(model):
    """The transfer dtypes worth warming for a model: its single
    quantized dtype, or the one canonical float a request arrives in
    (float32 and float64 requests both serve as float32, as in the JAX
    package with 64-bit mode off)."""
    if model.quantize is not None:
        return [model.transfer_dtype("float32")]
    return ["float32"]


def _key(model, kernel_name, sig):
    return (str(model.device), kernel_name, sig)


def lookup(model, op, bucket, dtype):
    """The warmed kernel serving ``(model, op)`` at ``(bucket, dtype)``,
    or None when that signature was never warmed on the model's
    device."""
    kernel_name, sig = model.aot_signature(op, bucket, dtype)
    return _warmed.get(_key(model, kernel_name, sig))


def _operands(lead, device):
    """Zeros of the request operand ``lead[0]`` on ``device``, and the
    int8 route's batch scale (1.0) when ``lead`` carries one."""
    from .quantize import torch_dtype

    shape, dtype = lead[0]
    args = [torch.zeros(shape, dtype=torch_dtype(dtype), device=device)]
    if len(lead) == 2:
        args.append(1.0)
    return args


def warm_model(model, *, buckets=None, dtypes=None):
    """Run every signature of ``model``'s serving ladder (kernel set ×
    buckets × transfer dtypes) once on its device. Idempotent per
    signature; returns ``{"compiled": n, "cached": m}`` (the JAX
    package's keys: ``compiled`` counts the signatures warmed now)."""
    from .quantize import KERNELS

    if buckets is None:
        buckets = bucket_ladder()
    if dtypes is None:
        dtypes = serve_dtypes(model)
    compiled = cached = 0
    for op in model.ops:
        for dtype in dtypes:
            for bucket in buckets:
                kernel_name, sig = model.aot_signature(op, bucket, dtype)
                key = _key(model, kernel_name, sig)
                with _lock:
                    if key in _warmed:
                        cached += 1
                        continue
                _, params = model.ops[op]
                operands = _operands(sig[:len(sig) - len(params)],
                                     model.device)
                kernel = KERNELS[kernel_name]
                kernel(*operands, *params)
                if model.device.type == "cuda":
                    torch.cuda.synchronize(model.device)
                with _lock:
                    _warmed[key] = kernel
                compiled += 1
    if compiled:
        _obs.counter_add("serving.aot_compiles", compiled)
    return {"compiled": compiled, "cached": cached}


def warm(models, *, buckets=None, dtypes=None, threads=None):
    """Warm several models' ladders on a bounded pool, joined before it
    returns. Returns the summed :func:`warm_model` stats."""
    models = list(models)
    nthreads = max(1, min(4, len(models)) if threads is None
                   else int(threads))
    with _obs.span("serving.aot.warm", models=len(models),
                   threads=nthreads):
        if nthreads <= 1 or len(models) <= 1:
            stats = [warm_model(m, buckets=buckets, dtypes=dtypes)
                     for m in models]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    nthreads, thread_name_prefix="sq-serve-aot") as ex:
                stats = list(ex.map(
                    lambda m: warm_model(m, buckets=buckets, dtypes=dtypes),
                    models))
    return {"compiled": sum(s["compiled"] for s in stats),
            "cached": sum(s["cached"] for s in stats)}


def kernel_sizes():
    """Signatures warmed per kernel name."""
    with _lock:
        out = {}
        for _dev, name, _sig in _warmed:
            out[name] = out.get(name, 0) + 1
        return out


def cache_size():
    """Warmed signature count (tests and the smoke read this)."""
    with _lock:
        return len(_warmed)


def clear():
    """Forget every warmed signature (tests; a fresh warm re-runs them)."""
    with _lock:
        _warmed.clear()
