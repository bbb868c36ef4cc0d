"""The port's streaming engine (``sq_learn_tpu_torch.streaming``) against the
JAX package's, and against the port's own monolithic routes, on the CPU.

The inputs are made with numpy from a seed, and a tile cap of a few KB
makes every pass run 5–20 tiles with a ragged, zero-padded tail.
Tolerances, as ``tests/test_streaming.py`` sets them: row-independent
results (the resident assembly, classic predict labels, k-NN lists) equal
bit for bit; the streamed Gram against the monolithic one at rtol 1e-5;
the port's streamed Gram, SVD and prestats against the JAX package's
streamed ones at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from sq_learn_tpu import streaming as jstreaming
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu_torch import config_context, obs, streaming
from sq_learn_tpu_torch.models import (QPCA, KNeighborsClassifier, QKMeans,
                                       TruncatedSVD)
from sq_learn_tpu_torch.models.qkmeans import MU_GRID, fit_prestats
from sq_learn_tpu_torch.ops.linalg import centered_svd_topk
from sq_learn_tpu_torch.utils import as_generator
from sq_learn_tpu_torch.utils.validation import host_ingest

RNG = np.random.default_rng(0)
# 1003 rows in 150-row tiles: 7 tiles, a tail of 103 rows padded to 128
X_TALL = (RNG.normal(size=(1003, 16)) + 2.0).astype(np.float32)
ROW_BYTES = X_TALL.nbytes // X_TALL.shape[0]
TILE_BYTES = 150 * ROW_BYTES


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _blobs(n=1003, m=16, k=3, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, m))
    y = rng.integers(0, k, n)
    return (centers[y] + rng.normal(size=(n, m))).astype(np.float32), y


# -- the tile plan ----------------------------------------------------------


@pytest.mark.parametrize("n,row_bytes,cap,multiple", [
    (1003, 64, 9600, 1), (900, 64, 9600, 1), (17, 3136, 4 << 20, 1),
    (10_000, 3136, 4 << 20, 1), (70_000, 3136, 16 << 20, 1),
    (1003, 64, 9600, 8), (5, 64, 64, 1)])
def test_tile_plan_matches_jax(n, row_bytes, cap, multiple):
    assert streaming.plan_row_tiles(n, row_bytes, cap, multiple) == \
        jstreaming.plan_row_tiles(n, row_bytes, cap, multiple)
    assert streaming.padded_rows(n, row_bytes, cap, multiple) == \
        jstreaming.padded_rows(n, row_bytes, cap, multiple)


@pytest.mark.parametrize("n,full,multiple,min_rows", [
    (150, 150, 1, None), (103, 150, 1, None), (3, 150, 1, None),
    (140, 150, 1, None), (65, 150, 8, None), (3, 512, 1, 8),
    (9, 512, 1, 8), (600, 512, 1, 8), (643, 1337, 1, None)])
def test_buckets_match_jax(n, full, multiple, min_rows):
    assert streaming.bucket_rows(n, full, multiple, min_rows) == \
        jstreaming.bucket_rows(n, full, multiple, min_rows)


def test_tiles_cover_rows_with_zero_padding():
    seen = np.zeros(1003, bool)
    shapes = []
    for tile, n_valid, start in streaming.stream_tiles(
            X_TALL, max_bytes=TILE_BYTES):
        t = tile.numpy()
        shapes.append(t.shape[0])
        np.testing.assert_array_equal(t[:n_valid],
                                      X_TALL[start:start + n_valid])
        assert not t[n_valid:].any()
        seen[start:start + n_valid] = True
    assert seen.all() and shapes == [150] * 6 + [128]


def test_worth_streaming_rules(monkeypatch):
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    assert streaming.worth_streaming(X_TALL)
    assert not streaming.worth_streaming(X_TALL[:100])
    # a tensor is placed (the estimators hand host input over as numpy)
    assert not streaming.worth_streaming(torch.from_numpy(X_TALL))
    assert not streaming.worth_streaming([[1.0, 2.0]])
    assert streaming.worth_streaming(X_TALL[:100], max_bytes=1000)


def test_host_ingest_checks_on_the_host_and_applies_the_cap(monkeypatch):
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    Xh, over = host_ingest(X_TALL.astype(np.float64))
    assert over and Xh.dtype == np.float32 and Xh.flags.c_contiguous
    np.testing.assert_array_equal(Xh, X_TALL)
    assert host_ingest(torch.from_numpy(X_TALL[:100]))[1] is False
    with pytest.raises(ValueError, match="2D array"):
        host_ingest(X_TALL[0])
    with pytest.raises(ValueError, match=r"0 sample\(s\) while a minimum "
                       "of 1 is required"):
        host_ingest(X_TALL[:0])


def test_min_bucket_rows_is_read_at_each_call(monkeypatch):
    monkeypatch.delenv("SQ_STREAM_MIN_BUCKET_ROWS", raising=False)
    assert streaming.bucket_rows(3, 512) == jstreaming.bucket_rows(3, 512)
    monkeypatch.setenv("SQ_STREAM_MIN_BUCKET_ROWS", "256")
    assert streaming.bucket_rows(3, 512) == 256


# -- streamed against monolithic, in the port -------------------------------


@pytest.mark.parametrize("n_rows", [1003, 900])
def test_streamed_topk_svd_matches_monolithic(n_rows):
    X = X_TALL[:n_rows]
    mean_s, U_s, S_s, Vt_s = streaming.streamed_centered_svd_topk(
        X, 4, max_bytes=TILE_BYTES)
    mean_m, U_m, S_m, Vt_m = centered_svd_topk(torch.from_numpy(X), 4)
    np.testing.assert_allclose(mean_s.numpy(), mean_m.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(S_s.numpy(), S_m.numpy(), rtol=1e-5)
    np.testing.assert_allclose(np.abs(Vt_s[:4].numpy()),
                               np.abs(Vt_m[:4].numpy()), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(np.abs(U_s.numpy()), np.abs(U_m.numpy()),
                               rtol=1e-3, atol=1e-4)
    assert U_s.shape == (n_rows, 4)


def test_streamed_gram_matches_monolithic_and_jax():
    mean, G, n = streaming.streamed_centered_gram(X_TALL,
                                                  max_bytes=TILE_BYTES)
    Xc = torch.from_numpy(X_TALL) - torch.from_numpy(X_TALL).mean(0)
    ref = (Xc.T @ Xc).numpy()
    np.testing.assert_allclose(G.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    jmean, jG, jn = jstreaming.streamed_centered_gram(X_TALL,
                                                      max_bytes=TILE_BYTES)
    assert n == jn == 1003
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-4)


def test_streamed_topk_svd_matches_jax():
    _, U, S, Vt = streaming.streamed_centered_svd_topk(
        X_TALL, 3, max_bytes=TILE_BYTES)
    _, jU, jS, jVt = jstreaming.streamed_centered_svd_topk(
        X_TALL, 3, max_bytes=TILE_BYTES)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-4)
    # the same sign convention (V-based): the kept columns agree
    np.testing.assert_allclose(Vt[:3].numpy(), np.asarray(jVt)[:3],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("n_rows", [1003, 900])
def test_streamed_randomized_svd_matches_exact_and_jax(n_rows):
    rng = np.random.default_rng(1)
    X = (rng.normal(size=(n_rows, 6)) @ rng.normal(size=(6, 16))
         + 0.01 * rng.normal(size=(n_rows, 16))).astype(np.float32)
    U, S, Vt = streaming.streamed_randomized_svd(
        as_generator(0, "cpu"), X, 4, max_bytes=TILE_BYTES)
    jU, jS, jVt = jstreaming.streamed_randomized_svd(
        jax.random.PRNGKey(0), X, 4, max_bytes=TILE_BYTES)
    exact = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:4]
    np.testing.assert_allclose(S.numpy(), exact, rtol=1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-4)
    np.testing.assert_allclose(np.abs(Vt.numpy() @ np.asarray(jVt).T),
                               np.eye(4), atol=1e-3)
    assert U.shape == (n_rows, 4)
    # centered: the rank-one correction's spectrum is the centered one
    Uc, Sc, Vtc, mean = streaming.streamed_randomized_svd(
        as_generator(0, "cpu"), X, 4, center=True, max_bytes=TILE_BYTES)
    Xc = X.astype(np.float64) - X.mean(0)
    np.testing.assert_allclose(Sc.numpy(), np.linalg.svd(
        Xc, compute_uv=False)[:4], rtol=1e-3)
    np.testing.assert_allclose(mean.numpy(), X.mean(0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_rows", [1003, 900])
def test_streamed_prestats_match_monolithic(n_rows):
    X = X_TALL[:n_rows]
    got = streaming.streamed_prestats(X, max_bytes=TILE_BYTES)
    ref = fit_prestats(torch.from_numpy(X))
    for name, tol in (("mean", 1e-6), ("Xc", 1e-5), ("xsq", 1e-4),
                      ("var_mean", 1e-5)):
        a, b = got[name].numpy(), ref[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


def test_streamed_prestats_quantum_match_monolithic_and_jax():
    got = streaming.streamed_prestats(X_TALL, quantum=True, mu_grid=MU_GRID,
                                      max_bytes=TILE_BYTES)
    ref = fit_prestats(torch.from_numpy(X_TALL), quantum=True,
                       mu_grid=MU_GRID)
    theirs = jstreaming.streamed_prestats(X_TALL, quantum=True,
                                          mu_grid=MU_GRID,
                                          max_bytes=TILE_BYTES)
    # computed on the resident buffer: the monolithic kernels' values
    for name in ("eta", "frob", "sigma_min", "mu_vals"):
        np.testing.assert_array_equal(got[name].numpy(), ref[name].numpy(),
                                      err_msg=name)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(theirs[name]), rtol=1e-4,
                                   err_msg=name)
    for name in ("mean", "Xc", "var_mean"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(theirs[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_streamed_prestats_mu_blocked_matches_jax_and_the_one_pass_sweep():
    """``mu_blocked=True`` sweeps μ over row tiles: at width 512 a tile
    holds 512 rows, so 1500 rows make three tiles, the last ragged."""
    rng = np.random.default_rng(21)
    X = (rng.normal(size=(1500, 512)) * np.linspace(0.5, 2.0, 512)
         ).astype(np.float32)
    cap = X.nbytes // 5
    got = streaming.streamed_prestats(X, quantum=True, mu_grid=MU_GRID,
                                      mu_blocked=True, max_bytes=cap)
    one_pass = streaming.streamed_prestats(X, quantum=True, mu_grid=MU_GRID,
                                           max_bytes=cap)
    theirs = jstreaming.streamed_prestats(X, quantum=True, mu_grid=MU_GRID,
                                          mu_blocked=True, max_bytes=cap)
    np.testing.assert_allclose(got["mu_vals"].numpy(),
                               np.asarray(theirs["mu_vals"]), rtol=1e-5)
    np.testing.assert_allclose(got["mu_vals"].numpy(),
                               one_pass["mu_vals"].numpy(), rtol=1e-5)
    for name in ("eta", "frob", "sigma_min", "mean", "Xc", "xsq"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      one_pass[name].numpy(), err_msg=name)


def test_assume_finite_turns_the_tile_check_off(monkeypatch):
    bad = X_TALL.copy()
    bad[700, 3] = np.inf
    checks = []
    monkeypatch.setattr(streaming._FiniteCheck, "add",
                        lambda self, tile: checks.append(tile.shape))
    with config_context(assume_finite=True):
        TruncatedSVD(3, ingest="streamed").fit(X_TALL)
    assert checks == []
    TruncatedSVD(3, ingest="streamed").fit(X_TALL)
    assert checks


def test_resident_put_is_bit_equal():
    for cap in (TILE_BYTES, 64 * ROW_BYTES, 10 ** 9):
        out = streaming.streamed_resident_put(X_TALL, max_bytes=cap)
        assert torch.equal(out, torch.from_numpy(X_TALL))
    wide = streaming.streamed_resident_put(X_TALL.astype(np.float64),
                                           max_bytes=TILE_BYTES)
    assert wide.dtype == torch.float32  # canonicalized on the host


def test_streamed_kmeans_plusplus_picks_weighted_rows():
    X, _ = _blobs()
    w = np.ones(len(X), np.float32)
    w[::2] = 0.0  # rows of weight 0 are never picked
    centers, idx = streaming.streamed_kmeans_plusplus(
        as_generator(0, "cpu"), X, 5, weights=w, max_bytes=TILE_BYTES)
    assert centers.shape == (5, 16) and len(set(idx.tolist())) == 5
    np.testing.assert_array_equal(centers, X[idx])
    assert (idx % 2 == 1).all()
    again, idx2 = streaming.streamed_kmeans_plusplus(
        as_generator(0, "cpu"), X, 5, weights=w, max_bytes=TILE_BYTES)
    np.testing.assert_array_equal(idx, idx2)
    # D² seeding spreads over the blobs as the JAX package's does
    _, labels = _blobs()
    assert len(set(labels[idx].tolist())) == 3


def test_streamed_spectral_stats_match_jax():
    X = np.tile(X_TALL, (20, 1))
    ours = streaming.streamed_spectral_stats(
        X, MU_GRID, sketch=512, rng=np.random.default_rng(4),
        max_bytes=64 * TILE_BYTES)
    theirs = jstreaming.streamed_spectral_stats(
        X, MU_GRID, sketch=512, rng=np.random.default_rng(4),
        max_bytes=64 * TILE_BYTES)
    assert ours.sketched and theirs.sketched
    for name in ("eta", "frob", "sigma_min", "sigma_min_lower"):
        np.testing.assert_allclose(getattr(ours, name),
                                   getattr(theirs, name), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(ours.mu_upper, theirs.mu_upper, rtol=1e-4)


# -- the estimators' streamed routes -----------------------------------------


def test_qpca_streamed_fit_matches_monolithic_and_jax(monkeypatch):
    kw = dict(n_components=3, svd_solver="full", random_state=0)
    mono = QPCA(**kw).fit(X_TALL)
    assert mono.ingest_ == "monolithic"
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    rec = obs.enable()
    try:
        auto = QPCA(**kw).fit(X_TALL)
    finally:
        obs.disable()
    forced = QPCA(ingest="streamed", **kw).fit(X_TALL)
    jax_fit = JaxQPCA(ingest="streamed", **kw).fit(X_TALL)
    assert auto.ingest_ == forced.ingest_ == jax_fit.ingest_ == "streamed"
    span = [s for s in rec.spans if s["name"] == "qpca.fit"][0]
    assert span["attrs"]["ingest"] == "streamed"
    assert rec.counters["streaming.tiles"] == 2 * 7  # Gram + U passes
    for est in (auto, forced):
        np.testing.assert_allclose(est.singular_values_,
                                   mono.singular_values_, rtol=1e-5)
        np.testing.assert_allclose(est.singular_values_,
                                   jax_fit.singular_values_, rtol=1e-4)
        np.testing.assert_allclose(
            np.abs(np.sum(est.components_ * jax_fit.components_, axis=1)),
            1.0, atol=1e-4)
        np.testing.assert_allclose(est.mean_, mono.mean_, rtol=1e-5,
                                   atol=1e-6)
    assert np.isfinite(forced.transform(X_TALL).numpy()).all()


def test_qpca_streamed_compute_dtype_engages_the_u_block():
    kw = dict(n_components=3, svd_solver="full", ingest="streamed",
              random_state=0)
    bf = QPCA(compute_dtype="bfloat16", **kw).fit(X_TALL)
    ref = QPCA(**kw).fit(X_TALL)
    assert bf.effective_compute_dtype_ == "bfloat16"
    # the streamed Gram stays float32: the spectrum does not move
    np.testing.assert_array_equal(bf.singular_values_, ref.singular_values_)
    assert not np.array_equal(bf.left_sv, ref.left_sv)
    np.testing.assert_allclose(bf.left_sv, ref.left_sv, atol=2e-2)


def test_qadra_fit_vetoes_streaming_with_warning():
    with pytest.warns(RuntimeWarning, match="ingest='streamed'"):
        pca = QPCA(n_components=3, svd_solver="full",
                   ingest="streamed").fit(
            X_TALL, estimate_all=True, eps=0.1, delta=0.1,
            theta_major=1e-9, true_tomography=False)
    assert pca.ingest_ == "monolithic"
    assert np.isfinite(pca.estimate_s_values).all()


def test_streamed_input_is_validated_on_the_device():
    bad = X_TALL.copy()
    bad[700, 3] = np.inf
    for est in (QPCA(n_components=3, svd_solver="full", ingest="streamed"),
                TruncatedSVD(3, ingest="streamed")):
        with pytest.raises(ValueError, match="NaN or infinity"):
            est.fit(bad)
    with pytest.raises(ValueError, match="2D array"):
        QPCA(n_components=3, ingest="streamed").fit(X_TALL[0])
    with pytest.raises(ValueError, match="ingest"):
        QPCA(n_components=3, svd_solver="full", ingest="nope").fit(X_TALL)


def test_truncated_svd_streamed_matches_monolithic_and_jax(monkeypatch):
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(1003, 5)) @ rng.normal(size=(5, 16))
         + 0.01 * rng.normal(size=(1003, 16))).astype(np.float32)
    mono = TruncatedSVD(3, random_state=0).fit(X)
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    est = TruncatedSVD(3, random_state=0)
    Xt = est.fit_transform(X)
    jest = JaxTruncatedSVD(3, random_state=0, ingest="streamed").fit(X)
    assert mono.ingest_ == "monolithic" and est.ingest_ == "streamed"
    assert jest.ingest_ == "streamed" and Xt.shape == (1003, 3)
    for ref, rtol in ((mono, 1e-4), (jest, 1e-4)):
        np.testing.assert_allclose(est.singular_values_,
                                   ref.singular_values_, rtol=rtol)
        np.testing.assert_allclose(est.explained_variance_ratio_,
                                   ref.explained_variance_ratio_, rtol=1e-3)
        np.testing.assert_allclose(
            np.abs(np.sum(est.components_ * ref.components_, axis=1)), 1.0,
            atol=1e-4)
    with pytest.warns(RuntimeWarning, match="randomized"):
        arp = TruncatedSVD(3, algorithm="arpack", ingest="streamed").fit(X)
    assert arp.ingest_ == "monolithic"


def test_qkmeans_streamed_fit_matches_monolithic(monkeypatch):
    X, y = _blobs()
    init = X[:3].copy()
    kw = dict(n_clusters=3, init=init, n_init=1, delta=0.0, random_state=0)
    mono = QKMeans(**kw).fit(X)
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    rec = obs.enable()
    try:
        streamed = QKMeans(**kw).fit(X)
    finally:
        obs.disable()
    assert mono.ingest_ == "monolithic" and streamed.ingest_ == "streamed"
    span = [s for s in rec.spans if s["name"] == "qkmeans.fit"][0]
    assert span["attrs"]["ingest"] == "streamed"
    np.testing.assert_array_equal(streamed.labels_, mono.labels_)
    np.testing.assert_allclose(streamed.cluster_centers_,
                               mono.cluster_centers_, rtol=1e-4, atol=1e-4)
    assert streamed.inertia_ == pytest.approx(mono.inertia_, rel=1e-5)


def test_qkmeans_streamed_quantum_fit_matches_monolithic(monkeypatch):
    """δ-means with the runtime statistics: the statistics are those of
    the resident buffer, the fit the monolithic one's up to the
    tile-summed mean."""
    X, y = _blobs(n=1500)
    kw = dict(n_clusters=3, n_init=2, delta=0.5,
              true_distance_estimate=False, random_state=0, sketch=0)
    mono = QKMeans(**kw).fit(X)
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    streamed = QKMeans(**kw).fit(X)
    assert streamed.ingest_ == "streamed"
    for name in ("eta_", "mu_", "condition_number_"):
        assert getattr(streamed, name) == pytest.approx(
            getattr(mono, name), rel=1e-5), name
    from sq_learn_tpu_torch.metrics import adjusted_rand_score
    assert adjusted_rand_score(y, streamed.labels_) == 1.0


def test_qkmeans_classic_streamed_predict_is_exact(monkeypatch):
    X, _ = _blobs()
    km = QKMeans(n_clusters=3, init=X[:3].copy(), n_init=1, delta=0.0,
                 random_state=0).fit(X)
    ref = km.predict(X)
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    np.testing.assert_array_equal(km.predict(X), ref)
    np.testing.assert_array_equal(km.predict(X), km.labels_)


def test_qkmeans_noisy_streamed_predict_in_distribution(monkeypatch):
    """δ-means predict: each tile draws from a generator seeded from
    (random_state, its first row). Against the monolithic predict the
    picks agree in distribution (two-sample χ² on the label counts of the
    rows whose window holds several centers, α = 1e-3), and the tiles'
    streams are distinct."""
    rng = np.random.default_rng(9)
    X = rng.normal(scale=0.3, size=(3000, 4)).astype(np.float32)
    km = QKMeans(n_clusters=3, n_init=1, delta=0.0, random_state=0).fit(X)
    ref = km.predict(X, delta=5.0)
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(300 * 16))
    got = km.predict(X, delta=5.0)
    again = km.predict(X, delta=5.0)
    np.testing.assert_array_equal(got, again)  # reproducible
    table = np.stack([np.bincount(ref, minlength=3),
                      np.bincount(got, minlength=3)])
    assert sstats.chi2_contingency(table)[1] > 1e-3
    # with a window this wide every label is a uniform pick: tiles whose
    # streams were shared would repeat each other's picks
    tiles = got[:3000 // 300 * 300].reshape(-1, 300)
    assert len({t.tobytes() for t in tiles}) == len(tiles)


def test_knn_streamed_search_is_exact(monkeypatch):
    X, y = _blobs()
    kn = KNeighborsClassifier(n_neighbors=3).fit(X, y)
    d_ref, i_ref = kn.kneighbors(X[:257])
    p_ref = kn.predict(X[:257])
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(64 * ROW_BYTES))
    rec = obs.enable()
    try:
        d_s, i_s = kn.kneighbors(X[:257])
    finally:
        obs.disable()
    np.testing.assert_array_equal(i_s, i_ref)
    np.testing.assert_array_equal(d_s, d_ref)
    span = [s for s in rec.spans if s["name"] == "knn.search"][0]
    assert span["attrs"]["engine"] == "streamed-device"
    assert rec.counters["streaming.tiles"] == 5  # 4 × 64 rows + a tail
    np.testing.assert_array_equal(kn.predict(X[:257]), p_ref)
