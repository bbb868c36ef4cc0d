"""Quantized serving: fewer bytes across the host→device boundary, the
error folded into the tenant's (ε, δ) (counterpart of
``sq_learn_tpu/serving/quantize.py``).

The three serving kernels (center-argmin predict, center-distance
transform, (x − μ)·Vᵀ projection) are row-independent, and their
quantization error is bounded by the params' dynamic range, so serving in
bf16 or int8 is a declared, audited degrade of the tenant's contract:

- **Representation error.** Round-to-nearest into bf16 (8 significand
  bits) perturbs every element by at most ``2⁻⁸·|x|``; symmetric int8 at
  scale ``s = amax/127`` by at most ``s/2 = amax/254``. Propagated through
  each kernel:

  =====================  ==================================================
  op                     per-entry bound on the quantized output
  =====================  ==================================================
  transform (centers)    ``|d̃ − d| ≤ √m·(q_x + q_c)``
  transform (projection) ``|ỹ − y| ≤ m·amax_V·r·(2 + r)·(amax_x+amax_μ)``
  predict                the returned label's exact distance is within
                         ``2·√m·(q_x + q_c)`` of the exact minimum
  =====================  ==================================================

  where ``r`` is the mode's relative step (bf16 ``2⁻⁸``, int8 ``1/254``),
  ``q_x = r·amax_x`` (request rows), ``q_c/q_μ/q_V = r·amax_param``. Param
  terms are computed once at residency; the row term is linear in the
  batch's ``amax_x``, so the bound is two coefficients (:class:`QuantFold`).
- **Conservative fold.** A tenant whose estimator declares (ε, δ) serves at
  (ε + ε_q(amax_x), δ + δ_q), ``δ_q`` = ``SQ_SERVE_QUANT_DELTA`` (1e-3).
- **Live audit.** Under observability, every ``SQ_SERVE_AUDIT_EVERY``-th
  quantized batch replays its head request through the float64 host
  reference (:func:`reference`) and records one ``guarantee`` draw at
  ``serving.quant.<kernel>`` (:func:`audit_batch`).
- **``quantize=None`` is the exact route**: nothing here runs.

The quantized payloads are bit-equal to the JAX package's: bf16 rounds to
nearest even (torch's CPU cast, which is ``ml_dtypes``' rounding), int8
uses the same numpy ``rint`` (half to even) and clip. On the host a bf16
batch is stored as int16 (numpy has no bfloat16) and viewed as
``torch.bfloat16`` once on the card. The quantized kernels dequantize to
float32 on the card and compute in float32, as the JAX ones do: the
transfer is quantized, the arithmetic is not.

Modes: ``'bf16'`` | ``'int8'`` | ``'auto'`` (→ bf16) | ``None``. Per tenant
through ``ModelRegistry.register(..., quantize=...)``; process default
``SQ_SERVE_QUANTIZE``.
"""

import math

import numpy as np
import torch

from .. import _knobs
from .. import obs as _obs

__all__ = ["DEFAULT_QUANT_DELTA", "KERNELS", "QUANT_KERNELS", "REL_STEP",
           "QuantFold", "audit_batch", "fold_for", "host_dtype",
           "int8_scale", "quant_delta", "quantize_params", "quantize_rows",
           "realized_errors", "reference", "resolve_mode", "serve_quantize",
           "torch_dtype", "transfer_dtype"]

#: relative per-element representation error of round-to-nearest into
#: each mode: bf16 keeps 8 significand bits (|δ| ≤ 2⁻⁸·|x|); symmetric
#: int8 at scale amax/127 rounds within half a step (|δ| ≤ amax/254)
REL_STEP = {"bf16": 2.0 ** -8, "int8": 1.0 / 254.0}

#: default audit budget δ_q of the quantization claim
DEFAULT_QUANT_DELTA = 1e-3

#: transfer dtype name → (host storage dtype, torch dtype on the card):
#: bfloat16 crosses as its 16 bits in an int16 array, viewed on arrival
_DTYPES = {
    "float32": (np.dtype(np.float32), torch.float32),
    "float16": (np.dtype(np.float16), torch.float16),
    "bfloat16": (np.dtype(np.int16), torch.bfloat16),
    "int8": (np.dtype(np.int8), torch.int8),
}


def serve_quantize():
    """Process-default serving quantization mode (``SQ_SERVE_QUANTIZE``:
    ``bf16`` | ``int8`` | ``auto`` | unset/``none``/``0`` = off)."""
    return resolve_mode(_knobs.get_raw("SQ_SERVE_QUANTIZE") or None)


def resolve_mode(quantize):
    """Normalize a ``quantize`` argument to ``'bf16' | 'int8' | None``;
    ``'auto'`` is bf16 (no scale estimate to get wrong)."""
    if quantize is None:
        return None
    mode = str(quantize).lower()
    if mode in ("none", "0", "off", ""):
        return None
    if mode == "auto":
        return "bf16"
    if mode not in REL_STEP:
        raise ValueError(
            f"quantize must be one of 'auto', 'bf16', 'int8', or None, "
            f"got {quantize!r}")
    return mode


def quant_delta():
    """The fold's declared audit budget δ_q (``SQ_SERVE_QUANT_DELTA``)."""
    return _knobs.get_float("SQ_SERVE_QUANT_DELTA")


def transfer_dtype(mode):
    """The name of the dtype quantized request batches cross the
    host→device boundary in (the JAX package's ``str`` of its dtype)."""
    return "bfloat16" if mode == "bf16" else "int8"


def host_dtype(name):
    """The numpy dtype a batch of transfer dtype ``name`` is stored in on
    the host."""
    return _DTYPES[str(name)][0]


def torch_dtype(name):
    """The torch dtype a batch of transfer dtype ``name`` has on the
    card."""
    return _DTYPES[str(name)][1]


# ---------------------------------------------------------------------------
# Host-side quantization (the bytes that cross the boundary)
# ---------------------------------------------------------------------------


def _bf16_bits(a, out):
    """Round ``a`` to nearest-even bfloat16 into the int16 array ``out``
    (same shape)."""
    torch.from_numpy(out).view(torch.bfloat16).copy_(
        torch.from_numpy(np.ascontiguousarray(a)))
    return out


def quantize_rows(rows, mode, out=None, scale=None):
    """Quantize a host row block into ``out`` (or a fresh array) and
    return it. bf16 ignores ``scale`` and writes int16-stored bfloat16
    bits; int8 needs the caller's symmetric batch scale (``amax/127`` over
    the whole batch: one scale per dispatch)."""
    if out is None:
        out = np.empty(rows.shape, host_dtype(transfer_dtype(mode)))
    if mode == "bf16":
        _bf16_bits(rows, out)
    else:
        out[...] = np.clip(np.rint(rows / scale), -127, 127)
    return out


def int8_scale(amax):
    """Symmetric int8 scale for a dynamic range of ``amax`` (1.0 for an
    all-zero block: any scale represents zeros exactly)."""
    return float(amax) / 127.0 if amax > 0 else 1.0


def quantize_params(arrays, mode, device):
    """Quantize fitted params once, at residency, and place them on
    ``device``. Returns ``(device_params, amaxes)``: bf16 gives one
    bfloat16 tensor per input; int8 an ``(int8 tensor, () float32
    scale)`` pair per input, flattened in order to match the quantized
    kernels' signatures. ``amaxes`` feed :func:`fold_for`."""
    device_params, amaxes = [], []
    for a in arrays:
        a = np.asarray(a, np.float64)
        amax = float(np.max(np.abs(a))) if a.size else 0.0
        amaxes.append(amax)
        if mode == "bf16":
            bits = _bf16_bits(a, np.empty(a.shape, np.int16))
            device_params.append(
                torch.from_numpy(bits).view(torch.bfloat16).to(device))
        else:
            s = int8_scale(amax)
            q = np.clip(np.rint(a / s), -127, 127).astype(np.int8)
            device_params.append(torch.from_numpy(q).to(device))
            device_params.append(
                torch.tensor(np.float32(s), device=device))
    return tuple(device_params), amaxes


# ---------------------------------------------------------------------------
# The serving kernels: plain torch, full float32 (TF32 off, the registry's
# device resolution sets it). Each is written once over its compute dtype;
# the float32 form serves and the float64 form on the CPU is its reference
# (:func:`reference_kernel`), used by the tests.
# ---------------------------------------------------------------------------


def _centers_d2(tile, centers):
    xsq = torch.sum(tile * tile, dim=1)
    csq = torch.sum(centers * centers, dim=1)
    return xsq[:, None] + csq[None, :] - 2.0 * (tile @ centers.T)


def _predict(d2):
    # torch.argmin returns the first minimum on ties, as jnp.argmin does
    return torch.argmin(d2, dim=1).to(torch.int32)


def _distances(d2):
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _deq(x, scale=None, dtype=torch.float32):
    t = x.to(dtype)
    return t if scale is None else t * scale


def predict_centers(tile, centers):
    """Closest-center labels of a padded request batch. Row-wise: a zero
    padding row gets a label like any other and is sliced away. A
    float16 batch computes in the params' dtype, as jax promotes it."""
    return _predict(_centers_d2(tile.to(centers.dtype), centers))


def transform_centers(tile, centers):
    """Center distances (the q-means transform) of a padded batch:
    ``sqrt(max(‖x‖² + ‖c‖² − 2·x·cᵀ, 0))`` in the JAX order."""
    return _distances(_centers_d2(tile.to(centers.dtype), centers))


def transform_components(tile, mean, components):
    """Projection ``(x − μ)·Vᵀ`` (the qPCA/SVD surface) of a padded
    batch."""
    return (tile.to(mean.dtype) - mean) @ components.T


def predict_centers_bf16(tile, centers, dtype=torch.float32):
    return _predict(_centers_d2(_deq(tile, dtype=dtype),
                                _deq(centers, dtype=dtype)))


def transform_centers_bf16(tile, centers, dtype=torch.float32):
    return _distances(_centers_d2(_deq(tile, dtype=dtype),
                                  _deq(centers, dtype=dtype)))


def transform_components_bf16(tile, mean, components, dtype=torch.float32):
    return ((_deq(tile, dtype=dtype) - _deq(mean, dtype=dtype))
            @ _deq(components, dtype=dtype).T)


def predict_centers_i8(tile, xscale, centers, cscale, dtype=torch.float32):
    return _predict(_centers_d2(_deq(tile, xscale, dtype),
                                _deq(centers, cscale, dtype)))


def transform_centers_i8(tile, xscale, centers, cscale, dtype=torch.float32):
    return _distances(_centers_d2(_deq(tile, xscale, dtype),
                                  _deq(centers, cscale, dtype)))


def transform_components_i8(tile, xscale, mean, mscale, components, cscale,
                            dtype=torch.float32):
    return ((_deq(tile, xscale, dtype) - _deq(mean, mscale, dtype))
            @ _deq(components, cscale, dtype).T)


#: kernel name → function: the float32 trio plus the quantized variants
KERNELS = {
    "predict_centers": predict_centers,
    "transform_centers": transform_centers,
    "transform_components": transform_components,
    "predict_centers_bf16": predict_centers_bf16,
    "transform_centers_bf16": transform_centers_bf16,
    "transform_components_bf16": transform_components_bf16,
    "predict_centers_i8": predict_centers_i8,
    "transform_centers_i8": transform_centers_i8,
    "transform_components_i8": transform_components_i8,
}

#: (base op kernel, mode) → quantized kernel name
QUANT_KERNELS = {
    ("predict_centers", "bf16"): "predict_centers_bf16",
    ("transform_centers", "bf16"): "transform_centers_bf16",
    ("transform_components", "bf16"): "transform_components_bf16",
    ("predict_centers", "int8"): "predict_centers_i8",
    ("transform_centers", "int8"): "transform_centers_i8",
    ("transform_components", "int8"): "transform_components_i8",
}


def reference_kernel(name, tile, *args):
    """Kernel ``name`` in float64 on the CPU over the same (possibly
    quantized) operands: every tensor argument moves to the CPU and,
    for the float32 kernels, widens to float64; the quantized kernels
    dequantize straight to float64."""
    host = [a.detach().cpu() if isinstance(a, torch.Tensor)
            else torch.tensor(a) for a in (tile, *args)]
    if name in QUANT_KERNELS.values():
        return KERNELS[name](*host, dtype=torch.float64)
    return KERNELS[name](*(a.double() for a in host))


# ---------------------------------------------------------------------------
# The fold: declared per-request error bounds, computed at residency
# ---------------------------------------------------------------------------


class QuantFold:
    """One op's declared quantization bound, as coefficients:
    ``tol(amax_x) = coef_const + coef_amax · amax_x`` bounds the realized
    per-entry error of the quantized op (for predict, the exact decision
    margin across which the label can flip); ``delta`` is δ_q."""

    __slots__ = ("op", "mode", "coef_const", "coef_amax", "delta", "kind")

    def __init__(self, op, mode, coef_const, coef_amax, delta, kind):
        self.op = op
        self.mode = mode
        self.coef_const = float(coef_const)
        self.coef_amax = float(coef_amax)
        self.delta = float(delta)
        self.kind = kind  # 'abs' (transforms) | 'margin' (predict)

    def tol(self, amax_x):
        """The declared bound for a batch of dynamic range ``amax_x``,
        plus the float-noise allowance of a float32 kernel audited against
        a float64 reference."""
        bound = self.coef_const + self.coef_amax * float(amax_x)
        return bound + 1e-4 * max(1.0, bound)

    def as_dict(self):
        return {"op": self.op, "mode": self.mode,
                "coef_const": round(self.coef_const, 9),
                "coef_amax": round(self.coef_amax, 9),
                "delta": self.delta, "kind": self.kind}


def fold_for(op, kernel_name, mode, m, param_amaxes, estimator_delta=None):
    """The op's :class:`QuantFold` from the params' dynamic range.
    ``param_amaxes`` follows the op's host-param order: ``[centers]`` for
    the center ops, ``[mean, components]`` for the projection."""
    r = REL_STEP[mode]
    dq = quant_delta()
    if kernel_name in ("predict_centers", "transform_centers"):
        amax_c = param_amaxes[0]
        # |d̃ − d| ≤ ‖δx‖₂ + ‖δc‖₂ ≤ √m·(r·amax_x + r·amax_c)
        coef_amax = math.sqrt(m) * r
        coef_const = math.sqrt(m) * r * amax_c
        if kernel_name == "predict_centers":
            # argmin flips only across a margin ≤ 2× the distance bound
            coef_amax, coef_const = 2 * coef_amax, 2 * coef_const
            return QuantFold(op, mode, coef_const, coef_amax, dq, "margin")
        return QuantFold(op, mode, coef_const, coef_amax, dq, "abs")
    # projection: |ỹ − y| ≤ m·amax_V·r·(2 + r)·(amax_x + amax_μ)
    amax_mu, amax_v = param_amaxes
    k = m * amax_v * r * (2.0 + r)
    return QuantFold(op, mode, k * amax_mu, k, dq, "abs")


# ---------------------------------------------------------------------------
# Live audit (guarantee draws against exact float64 host references)
# ---------------------------------------------------------------------------


def _audit_every():
    """Audit stride in batches (``SQ_SERVE_AUDIT_EVERY``, default 8)."""
    return max(1, _knobs.get_int("SQ_SERVE_AUDIT_EVERY"))


def reference(op_kind, rows, host_params):
    """Exact float64 host reference of one serving op: the distance
    matrix for both center ops (predict's claim is about distances), the
    projection for ``transform_components``."""
    x = np.asarray(rows, np.float64)
    if op_kind in ("predict_centers", "transform_centers"):
        c = np.asarray(host_params[0], np.float64)
        d2 = (np.sum(x * x, axis=1)[:, None] + np.sum(c * c, axis=1)[None, :]
              - 2.0 * (x @ c.T))
        return np.sqrt(np.maximum(d2, 0.0))
    mean = np.asarray(host_params[0], np.float64)
    comps = np.asarray(host_params[1], np.float64)
    return (x - mean) @ comps.T


def realized_errors(kind, base_kernel, rows, out, host_params):
    """Realized error of a served quantized response against the exact
    reference: max-abs for the transforms, the exact decision margin of
    the returned labels for predict."""
    ref = reference(base_kernel, rows, host_params)
    if kind == "margin":
        labels = np.asarray(out).astype(int)
        picked = ref[np.arange(ref.shape[0]), labels]
        return float(np.max(picked - np.min(ref, axis=1)))
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref)))


def audit_batch(model, op, head_rows, head_out, amax_x, seq, tenant=None):
    """One live guarantee draw for a dispatched quantized batch (head
    request only, every :func:`_audit_every`-th batch): realized error
    against the declared fold at ``serving.quant.<kernel>``, attributed to
    ``tenant``. Returns ``{realized, tol, violated, fail_prob}`` or None
    when no draw was taken. Strict mode's violation propagates; any other
    audit trouble never fails a dispatch that already succeeded."""
    if not _obs.guarantees.enabled() or seq % _audit_every():
        return None
    fold = model.quant_folds.get(op)
    if fold is None:
        return None
    try:
        base = model.base_kernel(op)
        realized = realized_errors(fold.kind, base, head_rows, head_out,
                                   model.host_params)
        tol = fold.tol(amax_x)
        attrs = dict(estimator=type(model.estimator).__name__,
                     mode=fold.mode, amax_x=round(float(amax_x), 6))
        if tenant is not None:
            attrs["tenant"] = str(tenant)
        _obs.guarantees.observe(
            f"serving.quant.{base}", [realized], tol,
            fail_prob=fold.delta, **attrs)
        return {"realized": realized, "tol": tol,
                "violated": bool(realized > tol),
                "fail_prob": fold.delta}
    except _obs.guarantees.GuaranteeViolationError:
        raise
    except (ValueError, TypeError, IndexError):
        return None
