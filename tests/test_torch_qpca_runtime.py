"""The port's qPCA runtime model (``accumulate_q_runtime``,
``runtime_comparison``) against the JAX package's, on the CPU.

The JAX estimator is fitted, its state carried over by
``convert.qpca_from_numpy``, and both sides price the same fit: host numpy
on the same statistics, held at rtol 1e-4. The slice's path C (the runtime
model of the qPCA trial's fit) runs at a small size on the port's own fit.
"""

import numpy as np
import pytest

from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu_torch import QPCA, config_context
from sq_learn_tpu_torch.convert import qpca_from_numpy

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    B = rng.normal(size=(200, 20)) @ rng.normal(size=(20, 30))
    return (B + 0.05 * rng.normal(size=(200, 30))).astype(np.float32)


def _fit(data, norm, theta):
    kw = dict(estimate_all=True, estimate_least_k=True, eps=0.05,
              delta=0.05, theta_minor=95.0, true_tomography=False, norm=norm)
    if theta == "estimated":
        kw.update(theta_estimate=True, quantum_retained_variance=True,
                  eps_theta=0.1, eta=0.1, p=0.7)
    else:
        kw.update(theta_major=1e-6)
    return JaxQPCA(n_components=8, random_state=0).fit(data, **kw)


@pytest.mark.parametrize("theta", ["given", "estimated"])
@pytest.mark.parametrize("norm", ["L2", "inf"])
def test_accumulate_q_runtime_matches_jax(data, norm, theta):
    j = _fit(data, norm, theta)
    t = qpca_from_numpy(vars(j), device="cpu", params=j.get_params())
    nn, mm = np.meshgrid(np.linspace(1, 70_000, 7), np.linspace(1, 784, 5))
    for which in ("all", "left_sv", "right_sv"):
        for args in ((70_000, 784), (nn, mm)):
            tq = t.accumulate_q_runtime(*args, estimate_components=which)
            jq = j.accumulate_q_runtime(*args, estimate_components=which)
            assert len(tq) == len(jq) >= 2
            for a, b in zip(tq, jq):
                np.testing.assert_allclose(a, b, rtol=RTOL)
    for classic in ("classic", "rand"):
        tout = t.runtime_comparison(70_000, 784, classic_runtime=classic)
        jout = j.runtime_comparison(70_000, 784, classic_runtime=classic)
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a, b, rtol=RTOL)


def test_runtime_comparison_needs_an_estimator_and_renders(data, tmp_path):
    with pytest.raises(ValueError, match="no quantum estimator"):
        QPCA(n_components=3).fit(data).runtime_comparison(100, 10)
    pca = QPCA(n_components=3, random_state=0).fit(
        data, estimate_all=True, eps=0.05, delta=0.05, theta_major=1e-6,
        true_tomography=False)
    out = tmp_path / "qpca.png"
    n, m, q, c = pca.runtime_comparison(1000, 30, saveas=str(out))
    assert out.stat().st_size > 0 and q.shape == (100, 100)


def test_path_c_at_a_small_size():
    """Path C: the runtime model of the trial's fit (qPCA with every top-k
    estimator) on the reference's 100 × 100 mesh, finite and positive,
    priced as the JAX package prices the same fit."""
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, _ = synthetic_surrogate(2000, 64, 10, seed=784)
    kw = dict(estimate_all=True, eps=0.4, delta=0.4, theta_major=1e-9,
              true_tomography=False)
    pca = QPCA(n_components=16, svd_solver="full", random_state=0).fit(
        X, **kw)
    n, m, q, c = pca.runtime_comparison(70_000, 784)
    surfaces = pca.accumulate_q_runtime(n, m)
    assert len(surfaces) == 1
    assert surfaces[0].shape == n.shape == (100, 100)
    assert np.isfinite(q).all() and (q > 0).all() and (c >= 0).all()
    j = JaxQPCA(n_components=16, svd_solver="full", random_state=0).fit(
        X, **kw)
    jq = j.runtime_comparison(70_000, 784)[2]
    # the same fit up to its estimates (σ̂, μ): the same cost to 1e-2
    np.testing.assert_allclose(q, jq, rtol=1e-2)
