"""The port's sharded Gram SVDs, tomography, μ(A) sweep and streamed Gram
(``sq_learn_tpu_torch.parallel.pca``/``.streaming``) and the mesh routes
of QPCA and TruncatedSVD, against the JAX package's ``mesh8`` and the
port's single-device routes, on the CPU, with the tolerances of the JAX
package's own tests (``tests/test_parallel_pca.py``,
``tests/test_streaming.py``)."""

import os

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu.parallel import centered_svd_sharded as j_centered
from sq_learn_tpu.parallel import uncentered_svd_sharded as j_uncentered
from sq_learn_tpu.parallel.streaming import \
    streamed_centered_gram_sharded as j_streamed_gram
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.models import QPCA, TruncatedSVD
from sq_learn_tpu_torch.ops.linalg import centered_svd, svd_flip_v, thin_svd
from sq_learn_tpu_torch.ops.quantum.norms import best_mu
from sq_learn_tpu_torch.parallel import (ShardedRows, centered_sharded,
                                         centered_svd_sharded, make_mesh,
                                         tomography_sharded,
                                         uncentered_svd_sharded)
from sq_learn_tpu_torch.parallel.pca import best_mu_sharded
from sq_learn_tpu_torch.parallel.streaming import (
    streamed_centered_gram_sharded, streamed_centered_svd_topk_sharded)
from sq_learn_tpu_torch.streaming import streamed_centered_gram
from sq_learn_tpu_torch.utils import as_generator

RNG = np.random.default_rng(0)
X_TALL = (RNG.normal(size=(1003, 16)) + 2.0).astype(np.float32)
ROW_BYTES = X_TALL.nbytes // X_TALL.shape[0]
TILE_BYTES = 150 * ROW_BYTES  # ~7 tiles, tail of 103 → bucket 128


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


def _normal(seed, n, m):
    return np.random.default_rng(seed).normal(size=(n, m)).astype(
        np.float32)


@pytest.mark.parametrize("n", [160, 103])  # even and uneven shards
def test_centered_svd_matches_single_device_and_jax(mesh, mesh8, n):
    X = _normal(0, n, 12)
    mean_s, U_s, S_s, Vt_s = centered_svd_sharded(mesh, X)
    mean, U, S, Vt = centered_svd(torch.from_numpy(X), method="gram")
    jm, jU, jS, jVt = j_centered(mesh8, X)
    assert isinstance(U_s, ShardedRows) and len(U_s.shards) == 8
    for want in ((mean, U, S, Vt), (jm, jU, jS, jVt)):
        np.testing.assert_allclose(mean_s.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(S_s.numpy(), np.asarray(want[2]),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(Vt_s.numpy(), np.asarray(want[3]),
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(U_s.numpy(), np.asarray(want[1]),
                                   rtol=1e-3, atol=2e-3)


def test_reconstruction(mesh):
    X = _normal(1, 75, 6)
    mean, U, S, Vt = centered_svd_sharded(mesh, X)
    np.testing.assert_allclose(U.numpy() @ np.diag(S.numpy()) @ Vt.numpy(),
                               X - mean.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [160, 103])
def test_uncentered_svd_matches_exact_thin_svd_and_jax(mesh, mesh8, n):
    X = _normal(7, n, 12)
    U_s, S_s, Vt_s = uncentered_svd_sharded(mesh, X)
    U, S, Vt = thin_svd(torch.from_numpy(X))
    U, Vt = svd_flip_v(U, Vt)
    jU, jS, jVt = j_uncentered(mesh8, X)
    for want in ((U, S, Vt), (jU, jS, jVt)):
        np.testing.assert_allclose(S_s.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(Vt_s.numpy(), np.asarray(want[2]),
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(U_s.numpy(), np.asarray(want[0]),
                                   rtol=1e-3, atol=2e-3)


def test_wide_input_thin_spectrum(mesh, mesh8):
    X = _normal(4, 40, 96)
    ref = QPCA(n_components=10, svd_solver="full").fit(X)
    dp = QPCA(n_components=10, svd_solver="full", mesh=mesh).fit(X)
    jdp = JaxQPCA(n_components=10, svd_solver="full", mesh=mesh8).fit(X)
    assert dp.all_singular_values_.shape == ref.all_singular_values_.shape \
        == np.asarray(jdp.all_singular_values_).shape
    np.testing.assert_allclose(dp.noise_variance_, ref.noise_variance_,
                               rtol=1e-3)
    np.testing.assert_allclose(dp.explained_variance_,
                               jdp.explained_variance_, rtol=1e-3)


class TestQPCAMesh:
    def test_classical_fit_parity(self, mesh, mesh8):
        X = _normal(2, 120, 10)
        ref = JaxQPCA(n_components=4, svd_solver="full", mesh=mesh8).fit(X)
        dp = QPCA(n_components=4, svd_solver="full", mesh=mesh).fit(X)
        np.testing.assert_allclose(dp.explained_variance_,
                                   ref.explained_variance_, rtol=1e-4)
        np.testing.assert_allclose(dp.components_, ref.components_,
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(dp.left_sv, ref.left_sv,
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(dp.transform(X).numpy(),
                                   ref.transform(X), rtol=1e-3, atol=2e-3)
        assert dp.effective_compute_dtype_ is None

    def test_quantum_fit_on_mesh(self, mesh, mesh8):
        X = _normal(3, 96, 8)
        kw = dict(estimate_all=True, delta=0.1, eps=0.1, theta_major=0.5)
        est = QPCA(n_components=4, svd_solver="full", mesh=mesh,
                   random_state=0).fit(X, **kw)
        ref = JaxQPCA(n_components=4, svd_solver="full", mesh=mesh8,
                      random_state=0).fit(X, **kw)
        assert est.estimate_right_sv.shape[1] == X.shape[1]
        assert np.all(np.isfinite(est.estimate_s_values))
        # μ(A): the exact sweep over the sharded centered rows
        assert est.norm_muA == ref.norm_muA and est.sketch_info_ is None
        np.testing.assert_allclose(est.muA, ref.muA, rtol=1e-5)

    def test_mesh_forces_full_solver(self, mesh):
        X = _normal(5, 900, 50)
        dp = QPCA(n_components=5, mesh=mesh).fit(X)
        assert dp._fit_svd_solver == "full"
        with pytest.raises(ValueError, match="mesh requires svd_solver"):
            QPCA(n_components=5, svd_solver="randomized", mesh=mesh).fit(X)

    def test_compute_dtype_does_not_engage_under_a_mesh(self, mesh):
        with pytest.warns(RuntimeWarning, match="no mesh"):
            dp = QPCA(n_components=3, mesh=mesh,
                      compute_dtype="bfloat16").fit(X_TALL)
        assert dp.effective_compute_dtype_ is None


def test_best_mu_sharded_equals_single_device(mesh):
    X = _normal(6, 101, 9)
    Xc = X - X.mean(axis=0)
    got = best_mu_sharded(centered_sharded(mesh, X, X.mean(axis=0)),
                          0.0, 1.0, 0.1)
    want = best_mu(torch.from_numpy(Xc), 0.0, 1.0, 0.1)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


class TestTomographySharded:
    def test_noise_bounded_and_engaged(self, mesh):
        # 13 rows over 8 shards: padding rows must not leak NaN through
        # the per-row normalization guard
        A = _normal(1, 13, 8)
        est = tomography_sharded(mesh, as_generator(3, "cpu"), A, 0.3)
        est = est.numpy()
        assert est.shape == A.shape and np.all(np.isfinite(est))
        err = np.linalg.norm(est - A, axis=1)
        assert 0.0 < err.max() < 3.0 * 0.3 * np.linalg.norm(A, axis=1).max()

    def test_gaussian_route_keeps_the_whole_bound(self, mesh):
        A = _normal(4, 29, 6)
        est = tomography_sharded(mesh, as_generator(0, "cpu"), A, 0.5,
                                 true_tomography=False).numpy()
        assert 0.0 < np.linalg.norm(est - A) <= 0.5 + 1e-6

    def test_zero_noise_short_circuits_exact(self, mesh):
        A = _normal(2, 24, 5)
        out = tomography_sharded(mesh, as_generator(0, "cpu"), A, 0.0)
        np.testing.assert_array_equal(out.numpy(), A)

    def test_one_shard_draws_reproducibly(self):
        A = _normal(0, 16, 6)
        one = make_mesh(["cpu"])
        a = tomography_sharded(one, as_generator(7, "cpu"), A, 0.4).numpy()
        b = tomography_sharded(one, as_generator(7, "cpu"), A, 0.4).numpy()
        np.testing.assert_array_equal(a, b)

    def test_qpca_mesh_quantum_transform(self, mesh):
        X = _normal(3, 67, 8)
        est = QPCA(n_components=4, mesh=mesh, random_state=0).fit(X)
        Z = est.transform(X).numpy()
        out = est.transform(X, classic_transform=False,
                            quantum_representation=True, epsilon_delta=0.5,
                            norm="None", psi=0.5)
        Zq = np.asarray(out["quantum_representation_results"])
        assert Zq.shape == Z.shape
        err = np.linalg.norm(Zq - Z, axis=1)
        assert 0.0 < err.max() < 3.0 * 0.5 * max(
            np.linalg.norm(Z, axis=1).max(), 1.0)


class TestTruncatedSVDMesh:
    def test_matches_exact_and_jax(self, mesh, mesh8):
        X = _normal(8, 91, 15)
        exact = TruncatedSVD(n_components=5, algorithm="arpack").fit(X)
        meshed = TruncatedSVD(n_components=5, mesh=mesh).fit(X)
        jmeshed = JaxTruncatedSVD(n_components=5, mesh=mesh8).fit(X)
        for want in (exact, jmeshed):
            np.testing.assert_allclose(meshed.singular_values_,
                                       want.singular_values_, rtol=1e-4)
            np.testing.assert_allclose(meshed.components_,
                                       want.components_, rtol=1e-3,
                                       atol=2e-3)
            np.testing.assert_allclose(
                meshed.explained_variance_ratio_,
                want.explained_variance_ratio_, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(meshed.transform(X).numpy(),
                                   exact.transform(X).numpy(), rtol=1e-3,
                                   atol=2e-3)
        assert meshed.ingest_ == "monolithic"

    def test_warns_on_explicit_arpack(self, mesh):
        with pytest.warns(RuntimeWarning, match="Gram route"):
            TruncatedSVD(n_components=3, algorithm="arpack",
                         mesh=mesh).fit(_normal(9, 64, 10))


class TestMeshStreaming:
    def test_streamed_gram_sharded_parity(self, mesh, mesh8):
        mean, Gc, n = streamed_centered_gram_sharded(
            mesh, X_TALL, max_bytes=TILE_BYTES)
        mean_1, Gc_1, _ = streamed_centered_gram(X_TALL,
                                                 max_bytes=TILE_BYTES)
        jmean, jGc, jn = j_streamed_gram(mesh8, X_TALL, max_bytes=TILE_BYTES)
        assert n == jn == 1003
        for m_want, G_want in ((mean_1, Gc_1), (jmean, jGc)):
            np.testing.assert_allclose(mean.numpy(), np.asarray(m_want),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(Gc.numpy(), np.asarray(G_want),
                                       rtol=1e-4, atol=1e-2)

    def test_streamed_topk_sharded_vs_resident_mesh_svd(self, mesh):
        mean_s, Uk, S_s, Vt_s = streamed_centered_svd_topk_sharded(
            mesh, X_TALL, 3, max_bytes=TILE_BYTES)
        mean_m, U_m, S_m, Vt_m = centered_svd_sharded(mesh, X_TALL)
        assert Uk.shape == (1003, 3)
        np.testing.assert_allclose(S_s.numpy()[:16], S_m.numpy(),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(Uk.numpy(), U_m.numpy()[:, :3],
                                   rtol=1e-2, atol=1e-3)

    def test_qpca_mesh_streamed_fit(self, mesh, monkeypatch):
        ref = QPCA(n_components=3, svd_solver="full", mesh=mesh,
                   ingest="monolithic").fit(X_TALL)
        monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
        got = QPCA(n_components=3, svd_solver="full", mesh=mesh).fit(X_TALL)
        assert got.ingest_ == "streamed"
        np.testing.assert_allclose(got.explained_variance_ratio_,
                                   ref.explained_variance_ratio_,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.components_, ref.components_,
                                   rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(got.left_sv, ref.left_sv,
                                   rtol=1e-2, atol=1e-3)

    def test_retried_tile_and_resume_are_bit_equal_to_a_clean_pass(
            self, mesh, tmp_path):
        from sq_learn_tpu_torch.resilience import faults
        from sq_learn_tpu_torch.streaming import StreamCheckpoint

        clean = streamed_centered_gram_sharded(mesh, X_TALL,
                                               max_bytes=TILE_BYTES)
        faults.arm("put_fail:tiles=2,times=1")
        try:
            retried = streamed_centered_gram_sharded(mesh, X_TALL,
                                                     max_bytes=TILE_BYTES)
            assert faults.get_plan().events
        finally:
            faults.disarm()
        ckpt = StreamCheckpoint(str(tmp_path / "g.npz"), every=2)
        faults.arm("abort:tile=5")
        try:
            with pytest.raises(Exception):
                streamed_centered_gram_sharded(
                    mesh, X_TALL, max_bytes=TILE_BYTES, checkpoint=ckpt)
        finally:
            faults.disarm()
        assert os.path.exists(ckpt.path)
        resumed = streamed_centered_gram_sharded(
            mesh, X_TALL, max_bytes=TILE_BYTES, checkpoint=ckpt)
        for got in (retried, resumed):
            assert torch.equal(got[0], clean[0])
            assert torch.equal(got[1], clean[1])


def _measure_mesh_svd():
    """The JAX package's float32 spectrum error of ``TruncatedSVD(10,
    mesh=...)`` (the sharded Gram route) on the covertype surrogate over
    its 8 virtual CPU devices, against float64 — the number the smoke's
    ``MESH_SVD_ERR`` triples."""
    import jax
    from jax.sharding import Mesh

    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, _ = synthetic_surrogate(581_012, 54, 7, seed=54)
    s64 = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:10]
    mesh8 = Mesh(np.asarray(jax.devices("cpu")[:8]), ("data",))
    est = JaxTruncatedSVD(n_components=10, mesh=mesh8).fit(X)
    err = np.max(np.abs(est.singular_values_ - s64) / s64)
    print(f"JAX TruncatedSVD(10, mesh=8 devices): largest relative error "
          f"of singular_values_ against float64 {err!r}")


if __name__ == "__main__":
    _measure_mesh_svd()
