"""The port's linear algebra (``ops/linalg``: sign flips, the Gram-route
and direct SVDs, the partial-U centered SVD, randomized SVD and
``stable_cumsum``) against the JAX package's ``ops/linalg``, on the CPU.

Inputs are made with numpy from a seed and go through both sides.
Tolerances: sign flips and the deterministic SVDs at rtol 1e-5 on the
singular values, 1e-4 on vectors and products (float32 sums taken in
another order; the port decomposes a float32 Gram in float64, see
``gram_spectrum``); the randomized SVD draws its range finder from
another generator, so its singular values are held at rtol 1e-4 on
low-rank data, where seven power iterations converge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.ops import linalg as jl
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.ops import linalg as tl


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _low_rank(n=200, m=30, r=20, seed=42):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, r)) @ rng.normal(size=(r, m))
    return (B + 0.05 * rng.normal(size=(n, m))).astype(np.float32)


def _close(a, b, rtol):
    """Equal at rtol, with an absolute floor of rtol × the largest entry
    (vectors hold near-zero entries)."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("shape", [(12, 5), (5, 12)])
def test_svd_flip_and_flip_v_match_jax(shape):
    rng = np.random.default_rng(0)
    u = rng.normal(size=(shape[0], min(shape))).astype(np.float32)
    v = rng.normal(size=(min(shape), shape[1])).astype(np.float32)
    u[0, 0] = 0.0  # a zero on a row does not flip its column
    for t_fn, j_fn in ((tl.svd_flip, jl.svd_flip),
                       (tl.svd_flip_v, jl.svd_flip_v)):
        tu, tv = t_fn(_t(u), _t(v))
        ju, jv = j_fn(jnp.asarray(u), jnp.asarray(v))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    # a partial U block: only its first columns flip
    tu, tv = tl.svd_flip_v(_t(u[:, :2]), _t(v))
    ju, jv = jl.svd_flip_v(jnp.asarray(u[:, :2]), jnp.asarray(v))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5)
    assert tl.svd_flip_v(None, _t(v))[0] is None


@pytest.mark.parametrize("shape,method", [((400, 30), "auto"),
                                          ((400, 30), "direct"),
                                          ((30, 400), "gram"),
                                          ((60, 40), "auto")])
def test_thin_svd_singular_values_match_jax(shape, method):
    X = _low_rank(*shape, r=min(shape) // 2)
    U, S, Vt = tl.thin_svd(_t(X), method=method)
    _, jS, _ = jl.thin_svd(jnp.asarray(X), method=method)
    k = min(shape) // 2  # the signal part; the tail is float32 noise
    np.testing.assert_allclose(S.numpy()[:k], np.asarray(jS)[:k], rtol=1e-5)
    # the factors reconstruct X
    np.testing.assert_allclose((U * S) @ Vt, X, rtol=1e-4,
                               atol=1e-4 * np.abs(X).max())


def test_gram_spectrum_is_descending_and_float64_inside():
    X = _low_rank(300, 12, r=6)
    G = _t(X.T @ X)
    S, V, safe = tl.gram_spectrum(G)
    assert S.dtype == V.dtype == torch.float32
    assert bool((S[1:] <= S[:-1]).all())
    jS, jV, _ = jl.gram_spectrum(jnp.asarray(X.T @ X))
    np.testing.assert_allclose(S.numpy()[:6], np.asarray(jS)[:6], rtol=1e-5)
    assert bool((safe > 0).all())


def test_centered_svd_matches_jax():
    X = _low_rank(200, 30) + 3.0
    mean, U, S, Vt = tl.centered_svd(_t(X))
    jmean, jU, jS, jVt = jl.centered_svd(jnp.asarray(X))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(S.numpy()[:20], np.asarray(jS)[:20],
                               rtol=1e-5)
    _close(Vt.numpy()[:20], np.asarray(jVt)[:20], 1e-4)
    _close(U.numpy()[:, :20], np.asarray(jU)[:, :20], 1e-4)


@pytest.mark.parametrize("n_left", [1, 5, 20])
def test_centered_svd_topk_matches_jax(n_left):
    X = _low_rank(400, 30) - 1.5
    mean, Uk, S, Vt = tl.centered_svd_topk(_t(X), n_left)
    jmean, jUk, jS, jVt = jl.centered_svd_topk(jnp.asarray(X), n_left)
    assert Uk.shape == (400, n_left)
    np.testing.assert_allclose(S.numpy()[:20], np.asarray(jS)[:20],
                               rtol=1e-5)
    _close(Vt.numpy()[:20], np.asarray(jVt)[:20], 1e-4)
    _close(Uk.numpy(), np.asarray(jUk), 1e-4)
    # the same block as the full centered SVD's first columns
    _, U, _, _ = tl.centered_svd(_t(X))
    _close(Uk.numpy(), U.numpy()[:, :n_left], 1e-4)


def test_centered_svd_topk_reduced_compute_dtype_rounds_the_operands():
    X = _low_rank(400, 30)
    _, _, S, _ = tl.centered_svd_topk(_t(X), 5, compute_dtype="bfloat16")
    _, _, jS, _ = jl.centered_svd_topk(jnp.asarray(X), 5,
                                       compute_dtype="bfloat16")
    np.testing.assert_allclose(S.numpy()[:5], np.asarray(jS)[:5], rtol=1e-3)


@pytest.mark.parametrize("shape,k", [((300, 40), 5), ((40, 300), 8)])
def test_randomized_svd_matches_jax(shape, k):
    X = _low_rank(*shape, r=12)
    g = torch.Generator().manual_seed(0)
    U, S, Vt = tl.randomized_svd(g, _t(X), k, n_iter=7)
    jU, jS, jVt = jl.randomized_svd(jax.random.PRNGKey(0), jnp.asarray(X), k,
                                    n_iter=7)
    assert U.shape == (shape[0], k) and Vt.shape == (k, shape[1])
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-4)
    _close(Vt.numpy(), np.asarray(jVt), 1e-3)


def test_stable_cumsum_accumulates_in_float64():
    a = np.full(100_000, 0.1, np.float32)
    out = tl.stable_cumsum(_t(a))
    assert out.dtype == torch.float32
    ref = np.cumsum(a.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    two_d = tl.stable_cumsum(_t(np.ones((3, 4), np.float32)), axis=1)
    assert two_d[:, -1].tolist() == [4.0, 4.0, 4.0]


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_stable_cumsum_takes_the_jax_axis(axis):
    a = np.random.default_rng(9).normal(size=(5, 7)).astype(np.float32)
    ours = tl.stable_cumsum(_t(a), axis=axis)
    theirs = np.asarray(jl.stable_cumsum(jnp.asarray(a), axis=axis))
    assert ours.shape == theirs.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-6)
