"""Multi-tenant fitted-model registry with LRU residency (counterpart of
``sq_learn_tpu/serving/registry.py``).

Fitted models arrive as :func:`~sq_learn_tpu_torch.utils.checkpoint.
save_estimator` directories (either package's: a checkpoint the JAX
package wrote loads through :mod:`sq_learn_tpu_torch.convert`) or as
in-memory fitted estimators. This module is the routing table between
tenant ids and servable device state:

- :meth:`ModelRegistry.register` binds a tenant to a checkpoint directory
  or a fitted estimator. Re-registering replaces the binding and evicts
  the resident copy.
- :meth:`ModelRegistry.resolve` returns the tenant's resident
  :class:`ServingModel`, loading (digest-verified) and wrapping on a
  miss, LRU-evicting beyond ``SQ_SERVE_REGISTRY_CAP`` (8) resident
  models.

:class:`ServingModel` is what the dispatcher batches against: it reads
the fitted surface (``cluster_centers_`` → predict/transform against
centers; ``components_`` (+ optional ``mean_``) → projection transform)
into per-op kernel bindings whose params are placed ONCE, on the
registry's device, at residency (the model's canonical dtype, or the
registration's ``quantize`` mode: bf16/int8 params and the fold of
:mod:`~sq_learn_tpu_torch.serving.quantize`). The host copies that
digests, folds and audits read are ``.cpu()`` copies. The ``fingerprint``
(the checkpoint's ``state_digest``, or the JAX recipe's CRC32 over the
params' contiguous host bytes, suffixed with the quantize mode) keys the
result cache and the batch groups, so the same parameters give the same
fingerprint and cache keys in both packages.

The registry's device is ``"cuda"`` unless the caller passes another (the
tests pass ``device="cpu"``); it raises when CUDA is absent. Registry
traffic is observable: ``serving.registry_loads`` /
``serving.registry_evictions`` counters, a ``serving.registry.resolve``
span around each cold load, a ``serving.quant_fold`` gauge per quantized
residency.
"""

import collections
import json
import os
import threading
import zlib

import numpy as np
import torch

from .. import _knobs
from .. import obs as _obs
from .._config import resolve_device
from ..utils.checkpoint import load_estimator
from . import quantize as _quant

__all__ = ["ModelRegistry", "ServingModel"]


def _params_digest(arrays):
    """The JAX recipe (``sq_learn_tpu/serving/registry.py:65-69``): CRC32
    over each param's contiguous host bytes, chained."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(a)).tobytes(), crc)
    return f"{crc:08x}"


def _host(v):
    """A fitted attribute as a host numpy array (a ``.cpu()`` copy of a
    tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def canonical_dtype(dtype):
    """The numpy float dtype a request or a param of float ``dtype`` is
    served in: float64 folds into float32, as in the JAX package with
    64-bit mode off."""
    dtype = np.dtype(dtype)
    return np.dtype(np.float32) if dtype == np.float64 else dtype


def _dtype_name(t):
    """The dtype name of a tensor, as the JAX package's ``str`` of its
    dtype reads (``float32``, ``bfloat16``, ``int8``)."""
    return str(t.dtype).rpartition(".")[2]


class ServingModel:
    """One tenant's resident, batch-servable form of a fitted estimator.

    ``ops`` maps op name → ``(kernel name, device params)`` where the
    kernel name resolves against :data:`sq_learn_tpu_torch.serving.
    quantize.KERNELS` and the params are tensors placed once, here, on
    ``device``: canonical-dtype for the exact route, quantized (bf16, or
    int8 + () float32 scales) under a ``quantize`` mode. Raises
    :class:`TypeError` for estimators with no servable surface rather
    than guessing.
    """

    __slots__ = ("estimator", "ops", "n_features", "dtype", "fingerprint",
                 "cacheable", "quantize", "host_params", "quant_folds",
                 "slo_p50_ms", "slo_p99_ms", "device",
                 "_base_kernels", "_param_sigs", "_group_keys", "_aot_sigs")

    def __init__(self, estimator, fingerprint=None, quantize=None,
                 slo_p50_ms=None, slo_p99_ms=None, device=None):
        self.estimator = estimator
        self.device = resolve_device(device)
        self.quantize = _quant.resolve_mode(quantize)
        #: the tenant's DECLARED latency targets (registration-time;
        #: None = defer to the dispatcher's run-level targets) — the
        #: per-tenant slo records and the error-budget ledger
        #: (obs.budget) burn against these
        self.slo_p50_ms = None if slo_p50_ms is None else float(slo_p50_ms)
        self.slo_p99_ms = None if slo_p99_ms is None else float(slo_p99_ms)
        self.ops = {}
        self.quant_folds = {}
        self._base_kernels = {}
        if hasattr(estimator, "cluster_centers_"):
            centers = _host(estimator.cluster_centers_)
            self.dtype = canonical_dtype(centers.dtype)
            self.n_features = int(centers.shape[1])
            self.host_params = [centers]
            self._bind("predict", "predict_centers", [centers])
            self._bind("transform", "transform_centers", [centers])
        elif hasattr(estimator, "components_"):
            comps = _host(estimator.components_)
            self.dtype = canonical_dtype(comps.dtype)
            mean = getattr(estimator, "mean_", None)
            mean = (np.zeros(comps.shape[1], comps.dtype) if mean is None
                    else _host(mean))
            self.n_features = int(comps.shape[1])
            self.host_params = [mean, comps]
            self._bind("transform", "transform_components", [mean, comps])
        else:
            raise TypeError(
                f"{type(estimator).__name__} has no servable fitted "
                "surface (expected cluster_centers_ or components_)")
        #: deterministic ops eligible for the serving result cache —
        #: transform is a pure function of the fitted state (under a
        #: fixed quantize mode, which the fingerprint carries); predict
        #: may carry a δ>0 noise model, so it never caches
        self.cacheable = frozenset({"transform"})
        if self.device.type == "cuda":
            # the params were placed on the default stream; the
            # dispatcher's worker reads them from its own
            torch.cuda.synchronize(self.device)
        base = (str(fingerprint) if fingerprint
                else _params_digest(self.host_params))
        self.fingerprint = (base if self.quantize is None
                            else f"{base}:q={self.quantize}")
        #: shape-invariant per-op precomputes (the per-request/-batch
        #: hot paths read these as dict lookups, never rebuild them)
        self._param_sigs = {
            op: tuple(tuple(int(d) for d in p.shape)
                      for p in params)
            for op, (_, params) in self.ops.items()}
        self._group_keys = {}
        self._aot_sigs = {}

    def _bind(self, op, base_kernel, host_arrays):
        """Bind one op: exact-route device params, or the quantized
        params + the declared fold of the quantize module."""
        self._base_kernels[op] = base_kernel
        if self.quantize is None:
            self.ops[op] = (base_kernel, tuple(
                torch.from_numpy(np.ascontiguousarray(
                    np.asarray(a).astype(self.dtype))).to(self.device)
                for a in host_arrays))
            return
        kernel = _quant.QUANT_KERNELS[(base_kernel, self.quantize)]
        params, amaxes = _quant.quantize_params(host_arrays, self.quantize,
                                                self.device)
        self.ops[op] = (kernel, params)
        fold = _quant.fold_for(
            op, base_kernel, self.quantize, self.n_features, amaxes,
            estimator_delta=getattr(self.estimator, "delta", None))
        self.quant_folds[op] = fold
        _obs.gauge("serving.quant_fold", fold.as_dict(),
                   estimator=type(self.estimator).__name__)

    def op(self, name):
        """(kernel name, device params) for ``name``; KeyError lists the
        ops this model actually serves."""
        try:
            return self.ops[name]
        except KeyError:
            raise KeyError(
                f"op {name!r} not served by {type(self.estimator).__name__}"
                f" (available: {sorted(self.ops)})") from None

    def base_kernel(self, name):
        """The op's f32 kernel family (``predict_centers``, ...) — the
        audit-reference selector, invariant under quantization."""
        return self._base_kernels[name]

    def param_signature(self, name):
        """Shape signature of the op's params — the watchdog
        allowed-signature component that keeps two tenants with
        different model shapes from sharing one compile budget slot.
        Precomputed: the dispatcher reads this per batch."""
        return self._param_sigs[name]

    def transfer_dtype(self, request_dtype):
        """The name of the dtype a request batch crosses the host→device
        boundary in: the model's quantized dtype (merging f32/f64 streams
        into one bucket ladder), or the request's own dtype."""
        if self.quantize is None:
            return np.dtype(request_dtype).name
        return _quant.transfer_dtype(self.quantize)

    def group_key(self, op, request_dtype):
        """The dispatcher's batch group key for (op, request dtype) —
        memoized: one dict lookup per submit instead of a per-request
        tuple rebuild (the model-shape portion is invariant per model,
        carried by the content fingerprint). Two tenants sharing a
        fingerprint serve byte-identical params, so co-batching them is
        sound by construction — the megabatch path rides exactly
        this key (one kernel launch per fingerprint, never per tenant),
        with per-tenant attribution handled downstream by the
        dispatcher; ``SQ_SERVE_MEGABATCH=0`` makes the dispatcher prefix
        the key with the tenant name, forcing single-tenant batches.
        Tenants with different quantize modes can never merge: the
        fingerprint carries the mode and the key carries the transfer
        dtype."""
        got = self._group_keys.get((op, request_dtype))
        if got is None:
            got = (self.fingerprint, op,
                   str(self.transfer_dtype(request_dtype)))
            self._group_keys[(op, request_dtype)] = got
        return got

    def aot_signature(self, op, bucket, dtype):
        """(kernel name, call signature) of this op at a padded
        ``bucket`` with transfer dtype ``dtype``: the operands' ``(shape,
        dtype name)`` pairs in call order, the JAX package's signature
        (``sq_learn_tpu/serving/registry.py:311``), with the int8
        route's () float32 batch scale. :func:`sq_learn_tpu_torch.
        serving.aot.warm_model` warms from it and
        :func:`~sq_learn_tpu_torch.serving.aot.lookup` resolves
        dispatches with it. Memoized per (op, bucket, dtype)."""
        memo_key = (op, int(bucket), str(dtype))
        got = self._aot_sigs.get(memo_key)
        if got is None:
            kernel_name, params = self.ops[op]
            sig = [((int(bucket), self.n_features), str(dtype))]
            if self.quantize == "int8":
                sig.append(((), "float32"))
            sig.extend((tuple(int(d) for d in p.shape), _dtype_name(p))
                       for p in params)
            got = (kernel_name, tuple(sig))
            self._aot_sigs[memo_key] = got
        return got


def _is_path(source):
    return isinstance(source, (str, os.PathLike))


class ModelRegistry:
    """tenant id → servable model, with bounded LRU residency."""

    def __init__(self, capacity=None, device="cuda"):
        #: where every resident model's params are placed (raises when
        #: CUDA is asked for and absent; the tests pass device="cpu")
        self.device = resolve_device(device)
        self._capacity = (_knobs.get_int("SQ_SERVE_REGISTRY_CAP")
                          if capacity is None else int(capacity))
        if self._capacity < 1:
            raise ValueError(f"registry capacity must be >= 1, "
                             f"got {self._capacity}")
        self._lock = threading.RLock()
        self._sources = {}
        self._quantize = {}
        self._slo_targets = {}
        #: tenant → declared accuracy headroom (slo_eps, slo_delta) —
        #: the controller's opt-in: route changes need ε headroom,
        #: (ε, δ) relaxation needs δ headroom (serving.control)
        self._contracts = {}
        #: tenant → controller-applied quantize mode (admission
        #: control's route step; absent = serve the registered route)
        self._route_override = {}
        #: the registry's one Controller, created lazily by
        #: :meth:`controller` and ONLY under an active recorder — with
        #: SQ_OBS unset this stays None (the disabled-path pin)
        self._controller = None
        self._resident = collections.OrderedDict()

    def register(self, tenant, source, quantize="env", *,
                 slo_p50_ms=None, slo_p99_ms=None, slo_eps=None,
                 slo_delta=None):
        """Bind ``tenant`` to a checkpoint directory or fitted estimator.
        Replaces any previous binding and evicts the resident copy.

        ``quantize`` selects the tenant's serving route: ``None`` (the
        exact float32 kernels), ``'bf16'``/``'int8'``/
        ``'auto'`` (the quantized route with its declared fold), or the
        default ``"env"`` — defer to ``SQ_SERVE_QUANTIZE`` at resolve
        time (unset = exact).

        ``slo_p50_ms``/``slo_p99_ms`` DECLARE the tenant's latency SLO:
        its per-tenant ``slo`` records and its error-budget burn
        (:mod:`sq_learn_tpu.obs.budget`) are judged against these
        instead of the dispatcher's run-level targets (None = inherit
        them).

        ``slo_eps``/``slo_delta`` DECLARE accuracy headroom for the
        autotuner (:mod:`~sq_learn_tpu.serving.control`): ``slo_eps``
        is the tolerated relative per-element representation error
        (route changes — the plan-time frontier pick and the quantize
        degrade step — happen only inside it), ``slo_delta`` the
        declared failure budget δ the controller may relax toward its
        cap when the tenant's error budget is persistently underspent.
        Both default to None: a tenant that declares nothing is never
        re-routed and never re-contracted — its responses are
        controller-invariant by construction."""
        tenant = str(tenant)
        if quantize != "env":
            _quant.resolve_mode(quantize)  # validate eagerly, at bind time
        if not _is_path(source) and not hasattr(source, "get_params"):
            raise TypeError("source must be a checkpoint path or a fitted "
                            f"estimator, got {type(source).__name__}")
        with self._lock:
            self._sources[tenant] = source
            self._quantize[tenant] = quantize
            self._slo_targets[tenant] = (slo_p50_ms, slo_p99_ms)
            self._contracts[tenant] = (
                None if slo_eps is None else float(slo_eps),
                None if slo_delta is None else float(slo_delta))
            self._route_override.pop(tenant, None)
            self._resident.pop(tenant, None)
            ctl = self._controller
        if ctl is not None:
            # re-registration replans: the binding (and possibly the
            # declared headroom) changed under the controller
            ctl.plan(tenant, replan=True)
        return self

    def unregister(self, tenant):
        with self._lock:
            self._sources.pop(str(tenant), None)
            self._quantize.pop(str(tenant), None)
            self._slo_targets.pop(str(tenant), None)
            self._contracts.pop(str(tenant), None)
            self._route_override.pop(str(tenant), None)
            self._resident.pop(str(tenant), None)

    def tenants(self):
        with self._lock:
            return sorted(self._sources)

    def resident_tenants(self):
        with self._lock:
            return list(self._resident)

    def __contains__(self, tenant):
        with self._lock:
            return str(tenant) in self._sources

    def resolve(self, tenant):
        """The tenant's resident :class:`ServingModel` (LRU-touch),
        loading on miss. Unknown tenants raise KeyError; a checkpoint
        whose digest mismatches raises straight through — serving a
        model whose state cannot be trusted is worse than a 500."""
        tenant = str(tenant)
        with self._lock:
            model = self._resident.get(tenant)
            if model is not None:
                self._resident.move_to_end(tenant)
                return model
            try:
                source = self._sources[tenant]
            except KeyError:
                raise KeyError(f"tenant {tenant!r} is not registered "
                               f"(known: {sorted(self._sources)})") from None
            quantize = self._quantize.get(tenant, "env")
            override = self._route_override.get(tenant)
            slo_p50_ms, slo_p99_ms = self._slo_targets.get(tenant,
                                                           (None, None))
        if override is not None:
            # admission control re-routed the tenant (serving.control):
            # the override wins over the registration and the env
            quantize = override
        elif quantize == "env":
            quantize = _quant.serve_quantize()
        # load OUTSIDE the lock: a cold checkpoint read must not stall
        # every concurrent resolve of already-resident tenants
        with _obs.span("serving.registry.resolve", tenant=tenant,
                       cold=True):
            if _is_path(source):
                fingerprint = self._checkpoint_digest(source)
                est = load_estimator(source, device=self.device)
            else:
                fingerprint = None
                est = source
            model = ServingModel(est, fingerprint, quantize=quantize,
                                 slo_p50_ms=slo_p50_ms,
                                 slo_p99_ms=slo_p99_ms, device=self.device)
        _obs.counter_add("serving.registry_loads", 1)
        with self._lock:
            # another thread may have raced the same cold load; last
            # writer wins either way (the models are equivalent)
            self._resident[tenant] = model
            self._resident.move_to_end(tenant)
            while len(self._resident) > self._capacity:
                evicted, _ = self._resident.popitem(last=False)
                _obs.counter_add("serving.registry_evictions", 1)
                _obs.gauge("serving.registry_evicted", evicted)
        return model

    def contract(self, tenant):
        """The tenant's declared accuracy headroom ``(slo_eps,
        slo_delta)`` — (None, None) when nothing was declared (the
        controller then never touches its route or its contract)."""
        with self._lock:
            return self._contracts.get(str(tenant), (None, None))

    def declared_targets(self, tenant):
        """The tenant's REGISTERED latency targets ``(slo_p50_ms,
        slo_p99_ms)`` — the declaration, not the controller's
        renegotiation (that lives on the controller state and in the
        ``control`` records)."""
        with self._lock:
            return self._slo_targets.get(str(tenant), (None, None))

    def current_route(self, tenant):
        """The quantize mode the tenant currently serves under:
        the controller's route override when one is applied, else the
        registration (``"env"`` resolved through ``SQ_SERVE_QUANTIZE``).
        Normalized: ``'bf16' | 'int8' | None`` (exact)."""
        with self._lock:
            override = self._route_override.get(str(tenant))
            quantize = self._quantize.get(str(tenant), "env")
        if override is not None:
            return _quant.resolve_mode(override)
        if quantize == "env":
            return _quant.serve_quantize()
        return _quant.resolve_mode(quantize)

    def set_route_override(self, tenant, mode):
        """Apply (or with ``mode=None`` clear) the controller's route
        override and evict the resident model — the next resolve
        rebuilds with the new quantize mode, minting a NEW fingerprint,
        so the result cache and the megabatch group keys can never mix
        routes. Counted into ``serving.control_reroutes``."""
        tenant = str(tenant)
        if mode is not None:
            mode = _quant.resolve_mode(mode)
        with self._lock:
            if mode is None:
                self._route_override.pop(tenant, None)
            else:
                self._route_override[tenant] = mode
            self._resident.pop(tenant, None)
        _obs.counter_add("serving.control_reroutes", 1)
        _obs.gauge("serving.control_route",
                   {"tenant": tenant, "mode": mode or "registered"})

    def controller(self, create=True, **opts):
        """The registry's one :class:`~sq_learn_tpu_torch.serving.control.
        Controller`, created lazily — and ONLY under an active recorder:
        with ``SQ_OBS`` unset this always returns None and allocates
        nothing (the disabled-path rule, pinned by test).
        ``opts`` configure the controller on FIRST creation (the bench
        and the tests tune thresholds per instance, never via env
        mutation); ``create=False`` only peeks."""
        with self._lock:
            ctl = self._controller
        if ctl is not None or not create:
            return ctl
        if not _obs.enabled():
            return None
        from . import control as _control

        with self._lock:
            if self._controller is None:
                self._controller = _control.Controller(self, **opts)
            return self._controller

    def warm(self, tenants=None, threads=None, aot=None, buckets=None):
        """Load cold checkpoints on a bounded thread pool and (by default)
        warm each loaded model's serving ladder
        (:func:`sq_learn_tpu_torch.serving.aot.warm_model`: kernel set ×
        pow2 buckets × transfer dtypes, each signature run once on the
        registry's device), so a tenant's first request finds a resident
        model whose kernels already ran at its shape.

        ``tenants`` defaults to every registered tenant; only the LAST
        ``capacity`` of them warm (earlier ones report
        ``"skipped_capacity"``). Loads run on ``threads`` (default
        min(4, n)) workers through :meth:`resolve`; the pool is joined
        before this returns. ``aot=False`` (or ``SQ_SERVE_AOT=0``) skips
        the ladder; ``buckets`` overrides the knob-derived ladder.
        Returns ``{tenant: "resident" | "loaded" | "skipped_capacity" |
        "error: ..."}``: a failed load never aborts the rest.
        """
        from . import aot as _aot

        if aot is None:
            aot = _knobs.get_bool("SQ_SERVE_AOT")
        with self._lock:
            known = list(self._sources)
            resident = set(self._resident)
        sel = known if tenants is None else [str(t) for t in tenants]
        out = {t: "skipped_capacity" for t in sel[:-self._capacity]}
        sel = sel[-self._capacity:]
        nthreads = max(1, min(4, len(sel)) if threads is None
                       else int(threads))
        with _obs.span("serving.registry.warm", tenants=len(sel),
                       threads=nthreads, aot=bool(aot)):
            def load(tenant):
                status = "resident" if tenant in resident else None
                try:
                    model = self.resolve(tenant)
                except Exception as exc:
                    return tenant, f"error: {exc}"
                if status is None:
                    _obs.counter_add("serving.registry_warm_loads", 1)
                    status = "loaded"
                if aot:
                    _aot.warm_model(model, buckets=buckets)
                return tenant, status

            if nthreads <= 1 or len(sel) <= 1:
                results = [load(t) for t in sel]
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                        nthreads,
                        thread_name_prefix="sq-serve-warm") as ex:
                    results = list(ex.map(load, sel))
        out.update(dict(results))
        ctl = self.controller(create=False)
        if ctl is not None:
            # plan at warm time: every successfully warmed tenant gets
            # its frontier pick (and its ``plan`` record) before the
            # first request
            for t, status in out.items():
                if status in ("resident", "loaded"):
                    ctl.plan(t)
        return out

    @staticmethod
    def _checkpoint_digest(path):
        """The checkpoint's recorded state digest (None for v1
        checkpoints — the ServingModel falls back to a params CRC)."""
        try:
            with open(os.path.join(path, "meta.json")) as fh:
                return json.load(fh).get("state_digest")
        except Exception:
            return None
