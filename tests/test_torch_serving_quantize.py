"""The port's quantized serving routes (``sq_learn_tpu_torch.serving.
quantize``) against the JAX package's, on the CPU.

- bf16 and int8 payloads, batch scales, quantized params and folds are
  bit-equal to the JAX package's (bf16 compared as its 16 bits).
- The payload a quantized batch crosses in is the JAX ``quantize_rows`` of
  its requests, the tail zeroed, and a bf16 batch moves half the bytes of
  the float32 one.
- Every served quantized response lies inside its declared fold against
  the float64 reference, and ``audit_batch`` flags the same violations as
  the JAX package's on the same served outputs.
"""

import numpy as np
import pytest
import torch

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import serving as jserving
from sq_learn_tpu.serving import quantize as jquant
from sq_learn_tpu_torch import obs, serving
from sq_learn_tpu_torch.serving import quantize as quant

from _torch_serving_helpers import jax_tenants, request_stream, reset_serving


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return jax_tenants(tmp_path_factory.mktemp("tenants"))


@pytest.fixture(autouse=True)
def _hygiene():
    reset_serving()
    yield
    reset_serving()


def _bits(a):
    """The raw 16 bits of a bf16 payload of either package."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_payloads_and_scales_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(37, 12))
            * np.exp(rng.normal(size=(37, 1)) * 3)).astype(np.float32)
    rows[0, :3] = [0.0, -0.0, 1e-30]  # zeros and a subnormal-range value
    assert np.array_equal(_bits(quant.quantize_rows(rows, "bf16")),
                          _bits(jquant.quantize_rows(rows, "bf16")))
    amax = float(np.max(np.abs(rows)))
    assert quant.int8_scale(amax) == jquant.int8_scale(amax)
    assert quant.int8_scale(0.0) == jquant.int8_scale(0.0) == 1.0
    s = quant.int8_scale(amax)
    ours = quant.quantize_rows(rows, "int8", scale=s)
    assert ours.dtype == np.int8
    assert np.array_equal(ours, jquant.quantize_rows(rows, "int8", scale=s))
    assert quant.transfer_dtype("bf16") == str(jquant.transfer_dtype("bf16"))
    assert quant.transfer_dtype("int8") == str(jquant.transfer_dtype("int8"))
    for mode in ("bf16", "int8", "auto", None, "none"):
        assert quant.resolve_mode(mode) == jquant.resolve_mode(mode)
    with pytest.raises(ValueError):
        quant.resolve_mode("fp8")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["km", "svd", "pca"])
def test_params_and_folds_equal_jax(tenants, name, mode):
    ckpt = tenants[name][1]
    jreg = jserving.ModelRegistry()
    jreg.register("t", ckpt, quantize=mode)
    reg = serving.ModelRegistry(device="cpu")
    reg.register("t", ckpt, quantize=mode)
    ours, theirs = reg.resolve("t"), jreg.resolve("t")
    assert ours.fingerprint == theirs.fingerprint
    assert ours.fingerprint.endswith(f":q={mode}")
    for op in ours.ops:
        (kname, params), (jname, jparams) = ours.op(op), theirs.op(op)
        assert kname == jname
        assert len(params) == len(jparams)
        for p, jp in zip(params, jparams):
            assert tuple(p.shape) == tuple(np.shape(jp))
            assert np.array_equal(_bits(p) if p.dtype == torch.bfloat16
                                  else p.numpy(), _bits(np.asarray(jp)))
        assert ours.quant_folds[op].as_dict() == \
            theirs.quant_folds[op].as_dict()
        assert ours.group_key(op, np.dtype(np.float64)) == \
            theirs.group_key(op, np.dtype(np.float64))
        for bucket in (8, 64, 512):
            assert ours.aot_signature(op, bucket, ours.transfer_dtype(
                "float32")) == jserving.aot._key(*theirs.aot_signature(
                    op, bucket, theirs.transfer_dtype(np.float32)))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_batch_payload_is_jax_quantize_rows(tenants, mode):
    reg = serving.ModelRegistry(device="cpu")
    reg.register("t", tenants["km"][1], quantize=mode)
    seen = []
    d = serving.MicroBatchDispatcher(
        reg, background=False, autotune=False, max_batch_rows=32,
        tap=lambda *a: seen.append(a))
    reqs = request_stream(n=20)
    futs = [d.submit("t", "predict", X) for X in reqs]
    d.flush()
    for f in futs:
        f.result(timeout=10)
    d.close()
    i = 0
    for kernel, padded, extra, _params, _out, results in seen:
        suffix = "bf16" if mode == "bf16" else "i8"
        assert kernel == f"predict_centers_{suffix}"
        group = [np.asarray(X, np.float32) for X in reqs[i:i + len(results)]]
        assert [len(r) for r in results] == [len(g) for g in group]
        i += len(results)
        scale = None
        if mode == "int8":
            scale = jquant.int8_scale(max(float(np.abs(g).max())
                                          for g in group))
            assert extra == (float(np.float32(scale)),)
        expected = np.concatenate([_bits(jquant.quantize_rows(
            g, mode, scale=scale)) for g in group])
        got = _bits(padded)
        assert np.array_equal(got[:expected.shape[0]], expected)
        assert not got[expected.shape[0]:].any()
    assert i == len(reqs)


def test_bf16_route_halves_the_bytes(tenants):
    bytes_moved = {}
    for mode in (None, "bf16", "int8"):
        reg = serving.ModelRegistry(device="cpu")
        reg.register("t", tenants["pca"][1], quantize=mode)
        d = serving.MicroBatchDispatcher(reg, background=False,
                                         autotune=False)
        for X in request_stream(n=30):
            d.submit("t", "transform", X)
        d.flush()
        bytes_moved[mode] = d.close()["transfer_bytes"]
    # float64 requests cast to float32 and merge into one transfer dtype
    assert bytes_moved["bf16"] * 2 == bytes_moved[None]
    assert bytes_moved["int8"] * 4 == bytes_moved[None]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("case", ["km-predict", "km-transform",
                                  "pca-transform"])
def test_served_responses_inside_their_fold(tenants, mode, case):
    name, op = case.split("-")
    reg = serving.ModelRegistry(device="cpu")
    reg.register("t", tenants[name][1], quantize=mode)
    model = reg.resolve("t")
    fold = model.quant_folds[op]
    reqs = request_stream(n=40)
    amax = max(float(np.abs(np.asarray(X, np.float32)).max()) for X in reqs)
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False)
    futs = [d.submit("t", op, X) for X in reqs]
    d.flush()
    for X, f in zip(reqs, futs):
        realized = quant.realized_errors(
            fold.kind, model.base_kernel(op), np.asarray(X, np.float32),
            f.result(timeout=10), model.host_params)
        assert realized <= fold.tol(amax)
    d.close()


def test_audit_batch_flags_what_jax_flags(tenants):
    ckpt = tenants["km"][1]
    jreg, reg = jserving.ModelRegistry(), serving.ModelRegistry(device="cpu")
    jreg.register("t", ckpt, quantize="int8")
    reg.register("t", ckpt, quantize="int8")
    ours, theirs = reg.resolve("t"), jreg.resolve("t")
    rows = np.asarray(request_stream(n=3)[2], np.float32)
    amax = float(np.abs(rows).max())
    served = theirs.estimator.predict(rows)
    wrong = (served + 1) % 3  # labels off by one cluster: a violation
    far = np.full((rows.shape[0], 3), 1e3, np.float32)
    obs.enable()
    jobs.enable()
    try:
        for op, out in (("predict", served), ("predict", wrong),
                        ("transform", far)):
            a = quant.audit_batch(ours, op, rows, out, amax, 0, tenant="t")
            b = jquant.audit_batch(theirs, op, rows, out, amax, 0,
                                   tenant="t")
            assert a["violated"] == b["violated"]
            assert a["tol"] == b["tol"]
            assert a["realized"] == pytest.approx(b["realized"], rel=1e-12)
        assert [a["violated"] for a in (
            quant.audit_batch(ours, "predict", rows, wrong, amax, 0),
            quant.audit_batch(ours, "transform", rows, far, amax, 0))] == \
            [True, True]
        # off-stride batches draw nothing, in both packages
        assert quant.audit_batch(ours, "predict", rows, served, amax, 3) \
            is None
        assert jquant.audit_batch(theirs, "predict", rows, served, amax,
                                  3) is None
        sites = {r["site"] for r in obs.get_recorder().guarantee_records}
        assert sites == {r["site"]
                         for r in jobs.get_recorder().guarantee_records}
    finally:
        obs.disable()
        jobs.disable()


def test_reference_kernels_are_float64_twins(tenants):
    """Each serving kernel's float64 reference on the CPU agrees with the
    float32 kernel to float32 accuracy on the same operands."""
    reg = serving.ModelRegistry(device="cpu")
    for mode in (None, "bf16", "int8"):
        reg.register(f"t{mode}", tenants["pca"][1], quantize=mode)
        reg.register(f"k{mode}", tenants["km"][1], quantize=mode)
    x = torch.from_numpy(np.asarray(request_stream(n=5)[4], np.float32))
    for tenant in reg.tenants():
        model = reg.resolve(tenant)
        for op, (kname, params) in model.ops.items():
            tile = x
            extra = ()
            if model.quantize == "bf16":
                tile = torch.from_numpy(quant.quantize_rows(
                    x.numpy(), "bf16")).view(torch.bfloat16)
            elif model.quantize == "int8":
                s = quant.int8_scale(float(x.abs().max()))
                tile = torch.from_numpy(quant.quantize_rows(
                    x.numpy(), "int8", scale=s))
                extra = (float(np.float32(s)),)
            out = quant.KERNELS[kname](tile, *extra, *params)
            ref = quant.reference_kernel(kname, tile, *extra, *params)
            assert ref.dtype in (torch.float64, torch.int32)
            if kname.startswith("predict"):
                assert (out == ref).float().mean() > 0.9
            else:
                np.testing.assert_allclose(out.numpy(), ref.numpy(),
                                           rtol=1e-4, atol=1e-4)
