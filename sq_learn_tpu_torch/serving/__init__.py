"""Online serving on the card: async micro-batching dispatch over a
multi-tenant fitted-model registry, with p50/p99 SLO accounting
(counterpart of ``sq_learn_tpu/serving``).

- :class:`~.dispatcher.MicroBatchDispatcher` coalesces concurrent
  predict/transform requests into padded pow2 buckets, copies each batch
  once through the transfer supervisor on its own CUDA stream, launches
  one kernel and scatters the rows back per request. An OPEN breaker or
  exhausted retries fail the batch's futures; nothing runs on the CPU.
- :class:`~.registry.ModelRegistry`: tenant id → servable model,
  checkpoint-backed (either package's checkpoints), LRU residency, params
  placed once on the registry's device.
- :mod:`~.cache`: digest-keyed transform-result cache with a compressed
  disk spill tier in the JAX package's file format.
- :class:`~.slo.SloTracker`: per-run, per-tenant and windowed ``slo``
  records, feeding the error-budget ledger (:mod:`sq_learn_tpu_torch.obs.
  budget`).
- :mod:`~.aot`: the ladder warm-up (every serving signature run once
  before traffic), and the pinned budget of unwarmed dispatches.
- :mod:`~.quantize`: bf16/int8 routes with the quantization error folded
  into the tenant's (ε, δ) and audited live; payloads bit-equal to the
  JAX package's.
- :mod:`~.control`: the SLO-driven (ε, δ) autotuner and admission
  controller (``control`` records).

Quickstart::

    from sq_learn_tpu_torch import serving

    reg = serving.ModelRegistry()                  # device="cuda"
    reg.register("tenant-a", "/models/tenant_a_qkmeans")
    reg.warm()
    with serving.MicroBatchDispatcher(reg) as d:
        labels = d.submit("tenant-a", "predict", X_rows).result()

The names below load on first use (this package imports torch; ``obs``
stays a standard-library tool). The plane's contract smokes are
``python -m sq_learn_tpu_torch.serving.smoke`` and ``...serving.
control_smoke`` (``--device {cuda,cpu}``, the card by default). Not
ported: the ``native/`` gather and scatter, and the persistent compile
cache (``ROADMAP.md``).
"""

import importlib

#: the package's names, by the module that defines them
_EXPORTS = {
    ".control": ("Controller",),
    ".dispatcher": ("MicroBatchDispatcher", "kernel_cache_sizes",
                    "pin_compile_budgets", "serve_max_batch_rows",
                    "serve_max_wait_ms", "serve_min_bucket_rows"),
    ".registry": ("ModelRegistry", "ServingModel"),
    ".slo": ("SloTracker", "SloViolation"),
}
_ORIGIN = {name: module for module, names in _EXPORTS.items()
           for name in names}
_MODULES = ("aot", "cache", "control", "dispatcher", "quantize", "registry",
            "slo")

__all__ = sorted([*_ORIGIN, *_MODULES])


def __getattr__(name):
    """Load an exported name, or a submodule, on first use."""
    if name in _ORIGIN:
        value = getattr(importlib.import_module(_ORIGIN[name], __name__),
                        name)
    elif name in _MODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted({*globals(), *__all__})
