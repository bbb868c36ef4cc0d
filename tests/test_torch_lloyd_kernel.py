"""The port's fused Lloyd step against the JAX package's Pallas kernel.

``lloyd_step_reference`` (the plain torch version the CPU runs, and the
yardstick of the CUDA kernel on the card) is held against
``lloyd_step_pallas(..., interpret=True)`` on the same numpy inputs. The
δ-window cases feed both sides JAX's own Gumbel draw: the Pallas wrapper
draws ``jax.random.gumbel(key, (n_p, k_p))`` with n padded to the 512-row
tile and k to the 128-lane width, so the test takes the same draw and
slices it. Tolerances: labels equal; floats at rtol 1e-4 (float32 sums
taken in another order); bf16 allows ≤1 % label flips (a point on a
Voronoi boundary may flip under bf16 rounding of the two products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.ops.pallas_kernels import lloyd_step_pallas
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.ops import _build, kernels
from sq_learn_tpu_torch.ops.kernels import (launch_plan, lloyd_step,
                                            lloyd_step_reference,
                                            lloyd_step_work)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _round_up(x, m):
    return (x + m - 1) // m * m


def _problem(n=700, m=17, k=5, seed=11, weights="ones"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    C = X[rng.choice(n, k, replace=False)]
    if weights == "ones":
        w = np.ones(n, np.float32)
    elif weights == "zero_head":
        w = np.ones(n, np.float32)
        w[:100] = 0.0
    else:
        w = rng.uniform(0.1, 3.0, n).astype(np.float32)
    xsq = (X.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return X, w, C, xsq


def _jax(X, w, C, xsq, **kw):
    out = lloyd_step_pallas(jnp.asarray(X), jnp.asarray(w), jnp.asarray(C),
                            jnp.asarray(xsq), interpret=True, **kw)
    return [np.asarray(a) for a in out]


def _torch(X, w, C, xsq, *, x_dtype=torch.float32, gumbel=None,
           window=0.0):
    out = lloyd_step_reference(
        torch.from_numpy(X).to(x_dtype), torch.from_numpy(w),
        torch.from_numpy(xsq), torch.from_numpy(C)[None],
        gumbel=None if gumbel is None else torch.from_numpy(gumbel)[None],
        window=window)
    return [a[0].numpy() for a in out]


def _assert_floats(t_out, j_out):
    _, mind_t, sums_t, counts_t, inertia_t = t_out
    _, mind_j, sums_j, counts_j, inertia_j = j_out
    np.testing.assert_allclose(mind_t, mind_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sums_t, sums_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts_t, counts_j, rtol=1e-4)
    np.testing.assert_allclose(inertia_t, inertia_j, rtol=1e-4)


@pytest.mark.parametrize("n,m,k,weights", [
    (700, 17, 5, "ones"),          # the classic case, deliberately unaligned
    (700, 17, 5, "zero_head"),     # zero-weight rows drop out of every sum
    (700, 17, 5, "uniform"),       # weighted samples
    (530, 130, 129, "uniform"),    # m and k across the 128-lane boundary
])
def test_classic_matches_pallas(n, m, k, weights):
    X, w, C, xsq = _problem(n, m, k, weights=weights)
    j_out = _jax(X, w, C, xsq)
    t_out = _torch(X, w, C, xsq)
    np.testing.assert_array_equal(t_out[0], j_out[0])
    _assert_floats(t_out, j_out)


@pytest.mark.parametrize("window", [0.5, 5.0])
def test_delta_window_matches_pallas_on_shared_draw(window):
    X, w, C, xsq = _problem(seed=3)
    key = jax.random.PRNGKey(7)
    n, k = X.shape[0], C.shape[0]
    gum = np.asarray(jax.random.gumbel(
        key, (_round_up(n, 512), _round_up(k, 128)), jnp.float32))[:n, :k]
    j_out = _jax(X, w, C, xsq, key=key, window=window)
    t_out = _torch(X, w, C, xsq, gumbel=np.ascontiguousarray(gum),
                   window=window)
    np.testing.assert_array_equal(t_out[0], j_out[0])
    _assert_floats(t_out, j_out)
    if window == 5.0:  # the wide window really moves labels off the argmin
        d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        assert (t_out[0] != d2.argmin(1)).any()


def test_bf16_matches_pallas_bf16():
    X, w, C, xsq = _problem(seed=5)
    j_out = _jax(X, w, C, xsq, compute_dtype="bfloat16")
    t_out = _torch(X, w, C, xsq, x_dtype=torch.bfloat16)
    flips = np.mean(t_out[0] != j_out[0])
    assert flips <= 0.01, f"{flips:.1%} labels flipped"
    for a in t_out[1:]:
        assert a.dtype == np.float32
    # bf16 operands, f32 accumulation: sums at ~1e-2 relative
    np.testing.assert_allclose(t_out[2], j_out[2], rtol=2e-2, atol=1.0)
    np.testing.assert_allclose(t_out[4], j_out[4], rtol=2e-2)


def test_wrapper_cpu_path_is_the_reference_batched():
    """On CPU tensors the wrapper is the plain version, restart-batched:
    each restart's slice equals a one-restart call, and the launch count
    does not move."""
    X, w, _, xsq = _problem()
    rng = np.random.default_rng(1)
    C = torch.from_numpy(X[rng.choice(700, (3, 5))])
    before = lloyd_step.launches
    out = lloyd_step(torch.from_numpy(X), torch.from_numpy(w),
                     torch.from_numpy(xsq), C)
    assert lloyd_step.launches == before
    for r in range(3):
        one = lloyd_step_reference(torch.from_numpy(X), torch.from_numpy(w),
                                   torch.from_numpy(xsq), C[r:r + 1])
        for a, b in zip(out, one):
            torch.testing.assert_close(a[r], b[0], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("bad", ["x_dtype", "centers_shape", "weights",
                                 "window_without_noise", "noise_shape",
                                 "active_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    X = torch.zeros(10, 4)
    w, xsq, C = torch.ones(10), torch.zeros(10), torch.zeros(2, 3, 4)
    kw = {}
    if bad == "x_dtype":
        X = X.double()
    elif bad == "centers_shape":
        C = torch.zeros(3, 4)
    elif bad == "weights":
        w = torch.ones(9)
    elif bad == "window_without_noise":
        kw = {"window": 0.5}
    elif bad == "noise_shape":
        kw = {"window": 0.5, "gumbel": torch.zeros(2, 10, 4)}
    elif bad == "active_shape":
        kw = {"active": torch.ones(3, dtype=torch.bool)}
    else:
        X, w, xsq, C = (t.to("meta") for t in (X, w, xsq, C))
    with pytest.raises(ValueError):
        lloyd_step(X, w, xsq, C, **kw)


@pytest.mark.parametrize("n,R,sms", [(70_000, 10, 132), (700, 3, 132),
                                     (5, 1, 132), (100_000, 1, 8)])
def test_launch_plan_covers_every_row_once(n, R, sms):
    nblocks, rows = launch_plan(n, R, sms)
    assert nblocks >= 1 and rows >= 1
    assert (nblocks - 1) * rows < n <= nblocks * rows


def test_work_counts():
    nbytes, ops = lloyd_step_work(70_000, 784, 10, 10, torch.float32, 0.5)
    assert ops == 2 * 70_000 * 784 * 10 * 10 + 2 * 70_000 * 784 * 10
    # X once (219.5 MB), the Gumbel operand (28 MB) and the (R, n) labels
    # and distances (5.6 MB) make up nearly all of the bytes
    assert 253e6 < nbytes < 255e6


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(_build.KernelBuildError, match="lloyd.cu"):
        _build.build("lloyd")
    assert not list(tmp_path.glob("*.so"))


def test_build_reuses_a_library_of_the_same_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    path = _build.library_path("lloyd")
    assert path.startswith(str(tmp_path))
    open(path, "wb").close()

    def no_compiler():
        raise AssertionError("an up-to-date library must not be rebuilt")

    monkeypatch.setattr(_build, "_nvcc", no_compiler)
    assert _build.build("lloyd") == path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,window,m,k", [
    (torch.float32, 0.0, 130, 7),     # m % 4 != 0: the scalar-load path
    (torch.float32, 0.5, 132, 20),    # two center groups, δ-window pick
    (torch.bfloat16, 0.0, 132, 7),
    (torch.float32, 0.0, 4096, 20),   # k·m too large for shared memory
])
def test_cuda_kernel_matches_reference(cuda_device, x_dtype, window, m, k):
    X, w, _, xsq = _problem(2000, m, 5, weights="uniform")
    rng = np.random.default_rng(2)
    C = torch.from_numpy(X[rng.choice(2000, (3, k))]).to(cuda_device)
    Xd = torch.from_numpy(X).to(cuda_device, x_dtype)
    wd = torch.from_numpy(w).to(cuda_device)
    xd = torch.from_numpy(xsq).to(cuda_device)
    g = None
    if window:
        g = torch.from_numpy(rng.gumbel(size=(3, 2000, k)).astype(
            np.float32)).to(cuda_device)
    before = lloyd_step.launches
    out = lloyd_step(Xd, wd, xd, C, gumbel=g, window=window)
    torch.cuda.synchronize()
    assert lloyd_step.launches == before + 1
    ref = lloyd_step_reference(Xd, wd, xd, C, gumbel=g, window=window)
    flips = (out[0] != ref[0]).float().mean().item()
    assert flips <= (0.01 if x_dtype == torch.bfloat16 else 0.0)
    # d2 cancels ‖x‖² + ‖c‖² against 2·x·c: a few float32 ulps of those
    # terms separate two summation orders (a row that is its own center
    # lands near 0 from either side)
    scale = float(xd.max() + torch.sum(C * C, dim=-1).max())
    torch.testing.assert_close(out[1], ref[1], rtol=1e-4, atol=1e-5 * scale)
    if flips == 0:
        torch.testing.assert_close(out[2], ref[2], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[4], ref[4], rtol=1e-4, atol=1e-2)
    # an inactive restart's blocks exit at once: zeros, others unchanged
    act = torch.tensor([True, False, True], device=cuda_device)
    masked = lloyd_step(Xd, wd, xd, C, gumbel=g, window=window, active=act)
    assert not masked[2][1].any() and not masked[4][1]
    assert torch.equal(masked[2][0], out[2][0])
    # deterministic: a second launch is bit-identical
    again = lloyd_step(Xd, wd, xd, C, gumbel=g, window=window)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_module_launch_counter_is_a_plain_int():
    assert isinstance(kernels.lloyd_step.launches, int)
