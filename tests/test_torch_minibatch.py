"""The port's mini-batch q-means against the JAX package's.

One step at δ=0 without reassignment is deterministic: the same batch,
centers and counts must give the JAX ``minibatch_step``'s centers and
inertia at rtol 1e-5 and its counts exactly. The reassignment takes its
picks as an argument, so it is held bit for bit against the JAX host twin
``_host_reassign`` fed the same numpy draw. Whole fits draw from other
streams and are held in distribution: on blobs both the port and the JAX
package's device path (forced as ``tests/test_minibatch.py`` forces it)
reach ARI > 0.95 with inertias within 10 % of each other.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.datasets import make_blobs
from sq_learn_tpu.metrics import adjusted_rand_score as jax_ari
from sq_learn_tpu.models import MiniBatchQKMeans as JaxMiniBatch
from sq_learn_tpu.models import minibatch as jmb
from sq_learn_tpu.models.qkmeans import QKMeans as JaxQKMeans
from sq_learn_tpu_torch import (KMeans, MiniBatchKMeans, MiniBatchQKMeans,
                                config_context)
from sq_learn_tpu_torch.convert import minibatch_from_numpy
from sq_learn_tpu_torch.metrics import adjusted_rand_score
from sq_learn_tpu_torch.models import minibatch as tmb


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    X, y = make_blobs(n_samples=600, centers=4, n_features=6,
                      cluster_std=0.7, random_state=3)
    return X.astype(np.float32), y


def _batch(seed=0, b=128, m=6, k=4):
    rng = np.random.default_rng(seed)
    Xb = rng.normal(size=(b, m)).astype(np.float32) * 3
    # weights in halves: their sums are exact in any order
    wb = (rng.integers(1, 5, b) / 2).astype(np.float32)
    wb[::9] = 0.0  # padded rows
    centers = (Xb[rng.choice(b, k, replace=False)]
               + rng.normal(size=(k, m)).astype(np.float32))
    counts = np.array([3.0, 0.0, 12.5, 1.0], np.float32)[:k]
    return Xb, wb, centers, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minibatch_step_at_delta_0_matches_jax(seed):
    Xb, wb, centers, counts = _batch(seed)
    c, n, inertia = tmb.minibatch_step(
        torch.Generator().manual_seed(0), torch.from_numpy(Xb),
        torch.from_numpy(wb), torch.from_numpy(centers),
        torch.from_numpy(counts), 0, delta=0.0, mode="classic",
        reassignment_ratio=0.0)
    cj, nj, ij = jmb.minibatch_step(
        jax.random.PRNGKey(0), jnp.asarray(Xb), jnp.asarray(wb),
        jnp.asarray(centers), jnp.asarray(counts), 0, delta=0.0,
        mode="classic", ipe_q=5, reassignment_ratio=0.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
    np.testing.assert_allclose(float(inertia), float(ij), rtol=1e-5)


def _reassign_case(step_idx, wb_zero=(), counts=(50.0, 1.5, 40.0, 0.2)):
    Xb, wb, centers, _ = _batch(5)
    wb = np.ones_like(wb)
    wb[list(wb_zero)] = 0.0
    return Xb, wb, centers, np.asarray(counts, np.float32), step_idx


@pytest.mark.parametrize("step_idx,wb_zero", [
    (9, ()),                       # due: (9 + 1) % (10 + 0) == 0
    (19, tuple(range(0, 128, 2))),  # due, half the rows padded
    (8, ()),                       # not due
])
def test_reassign_apply_matches_the_jax_host_twin(step_idx, wb_zero):
    Xb, wb, centers, counts, step = _reassign_case(step_idx, wb_zero)
    ratio = 0.05
    # the JAX host twin draws its picks from this generator; the port is
    # handed the same draw
    p = (wb > 0).astype(np.float64)
    npos = int(p.sum())
    n_pick = min(len(centers), len(Xb), npos)
    picks = np.random.default_rng(7).choice(len(Xb), n_pick, replace=False,
                                            p=p / npos)
    cj, nj = jmb._host_reassign(np.random.default_rng(7), Xb, wb, centers,
                                counts.astype(np.float64), step, ratio)
    c, n = tmb.reassign_apply(torch.from_numpy(Xb), torch.from_numpy(wb),
                              torch.from_numpy(centers),
                              torch.from_numpy(counts), step, ratio,
                              torch.from_numpy(picks))
    np.testing.assert_array_equal(c.numpy(), cj)
    np.testing.assert_array_equal(n.numpy(), nj.astype(np.float32))
    moved = (c.numpy() != centers).any(axis=1)
    assert moved.tolist() == ([False, True, False, True] if step != 8
                              else [False] * 4)


def test_reassign_never_serves_a_weight_0_row():
    Xb, wb, centers, counts, step = _reassign_case(9)
    wb[:] = 0.0
    wb[3] = 1.0  # one positive row: one low center is served
    picks = tmb.reassign_picks(torch.Generator().manual_seed(0),
                               torch.from_numpy(wb), 4)
    assert int(picks[0]) == 3 and len(set(picks.tolist())) == 4
    c, n = tmb.reassign_apply(torch.from_numpy(Xb), torch.from_numpy(wb),
                              torch.from_numpy(centers),
                              torch.from_numpy(counts), step, 0.05, picks)
    np.testing.assert_array_equal(c.numpy()[1], Xb[3])
    np.testing.assert_array_equal(c.numpy()[3], centers[3])
    assert n.tolist() == [50.0, 40.0, 40.0, pytest.approx(0.2)]


def test_epoch_runs_every_batch_and_padding_weighs_nothing():
    Xb, wb, centers, counts = _batch(3)
    X = torch.from_numpy(Xb)
    w = torch.from_numpy(wb)
    c, n, step, inertias = tmb.minibatch_epoch(
        torch.Generator().manual_seed(1), X, w, torch.from_numpy(centers),
        torch.zeros(4), 5, batch=32, delta=0.0, mode="classic")
    assert step == 9 and inertias.shape == (4,)
    assert float(n.sum()) == pytest.approx(float(wb.sum()), rel=1e-6)


def test_epoch_gathers_padding_positions_modulo_n():
    """Positions past the n rows gather row p % n: the epoch equals the
    same epoch over the block with those rows copied in, bit for bit."""
    Xb, wb, centers, counts = _batch(4, b=100)
    X = torch.from_numpy(Xb)
    wp = torch.cat([torch.from_numpy(wb), torch.zeros(28)])
    out = [tmb.minibatch_epoch(
        torch.Generator().manual_seed(2), rows, wp,
        torch.from_numpy(centers), torch.from_numpy(counts), 0, batch=32,
        delta=0.0, mode="classic", reassignment_ratio=0.01)
        for rows in (X, torch.cat([X, X[:28]]))]
    assert out[0][2] == out[1][2] == 4
    for a, b in zip(out[0][:2] + out[0][3:], out[1][:2] + out[1][3:]):
        assert torch.equal(a, b)
    assert float(out[0][1].sum() - torch.from_numpy(counts).sum()) == \
        pytest.approx(float(wb.sum()), rel=1e-6)


def test_fit_transform_takes_sample_weight(blobs):
    X, _ = blobs
    w = np.random.default_rng(5).uniform(0.5, 2.0, X.shape[0])
    kw = {"n_clusters": 4, "batch_size": 100, "random_state": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        direct = MiniBatchKMeans(**kw).fit(X, sample_weight=w).transform(X)
        both = MiniBatchKMeans(**kw).fit_transform(X, sample_weight=w)
    np.testing.assert_array_equal(both, direct)


@pytest.mark.parametrize("delta", [0.0, 0.5])
def test_fit_on_blobs_agrees_with_the_jax_device_path(blobs, delta,
                                                      monkeypatch):
    X, y = blobs
    kw = dict(n_clusters=4, random_state=0, batch_size=128, n_init=3,
              delta=delta)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = MiniBatchQKMeans(**kw).fit(X)
        monkeypatch.setattr(JaxQKMeans, "_on_cpu_backend",
                            staticmethod(lambda: False))
        ref = JaxMiniBatch(**kw).fit(X)
    assert adjusted_rand_score(y, port.labels_) > 0.95
    assert float(jax_ari(y, ref.labels_)) > 0.95
    assert port.inertia_ == pytest.approx(ref.inertia_, rel=0.1)
    assert port.n_steps_ >= port.n_iter_ >= 1
    assert port.cluster_centers_.shape == ref.cluster_centers_.shape
    assert port.counts_.dtype == np.float32
    np.testing.assert_array_equal(port.predict(X), port.labels_)
    assert port.score(X) == pytest.approx(-port.inertia_, rel=1e-5)
    assert port.transform(X[:5]).shape == (5, 4)


def test_fit_is_reproducible_and_close_to_full_batch(blobs):
    X, y = blobs
    a = MiniBatchKMeans(n_clusters=4, random_state=0, batch_size=100).fit(X)
    b = MiniBatchKMeans(n_clusters=4, random_state=0, batch_size=100).fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    np.testing.assert_array_equal(a.counts_, b.counts_)
    assert (a.n_iter_, a.n_steps_) == (b.n_iter_, b.n_steps_)
    full = KMeans(n_clusters=4, n_init=3, random_state=0).fit(X)
    assert a.inertia_ <= full.inertia_ * 1.10
    assert a.delta is None


def test_padded_batches_and_other_inits(blobs):
    X, y = make_blobs(n_samples=130, centers=3, n_features=4,
                      cluster_std=0.3, random_state=7)
    one_per_class = X[[np.flatnonzero(y == c)[0] for c in range(3)]]
    for init in ("k-means++", "random", one_per_class):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            est = MiniBatchKMeans(n_clusters=3, batch_size=64, max_iter=20,
                                  n_init=2, init=init, random_state=0).fit(X)
        assert adjusted_rand_score(y, est.labels_) > 0.95
    with pytest.warns(RuntimeWarning, match="Explicit initial center"):
        MiniBatchKMeans(n_clusters=3, n_init=2, init=X[:3]).fit(X)
    with pytest.warns(RuntimeWarning, match="init_size"):
        MiniBatchKMeans(n_clusters=3, init_size=2, random_state=0).fit(X)
    with pytest.raises(ValueError, match="init centers shape"):
        MiniBatchKMeans(n_clusters=3, n_init=1, init=X[:2]).fit(X)


def test_stop_rules(blobs):
    X, _ = blobs
    full = MiniBatchKMeans(n_clusters=4, batch_size=128, max_iter=6,
                           max_no_improvement=None, random_state=0).fit(X)
    assert full.n_iter_ == 6 and full.n_steps_ == 6 * 5
    tol = MiniBatchKMeans(n_clusters=4, batch_size=128, max_iter=50,
                          max_no_improvement=None, tol=1e-2,
                          random_state=0).fit(X)
    assert 2 <= tol.n_iter_ < 50


def test_ipe_mode_fits(blobs):
    X, y = blobs
    est = MiniBatchQKMeans(n_clusters=4, batch_size=200, max_iter=3,
                           n_init=1, delta=0.5, true_distance_estimate=True,
                           random_state=0).fit(X)
    assert np.isfinite(est.inertia_) and est.n_steps_ >= 3
    assert adjusted_rand_score(y, est.labels_) > 0.9


def test_partial_fit_bookkeeping(blobs):
    X, y = blobs
    est = MiniBatchQKMeans(n_clusters=4, random_state=1)
    est.partial_fit(X[:200], sample_weight=np.ones(200))
    assert est.n_steps_ == 1 and est.labels_.shape == (200,)
    assert float(est.counts_.sum()) == pytest.approx(200.0)
    est.partial_fit(X[200:400], sample_weight=np.full(200, 0.5))
    assert est.n_steps_ == 2
    assert float(est.counts_.sum()) == pytest.approx(300.0)
    with pytest.raises(ValueError, match="expecting 6 features"):
        est.partial_fit(X[:10, :3])
    assert est.n_features_in_ == 6 and est.n_steps_ == 2
    assert est.cluster_centers_.shape == (4, 6)
    rng = np.random.default_rng(0)
    for _ in range(30):
        est.partial_fit(X[rng.choice(600, 128, replace=False)])
    assert est.n_steps_ == 32
    assert adjusted_rand_score(y, est.predict(X)) > 0.9
    # partial_fit after fit goes on from the fit's state and step count
    fit = MiniBatchKMeans(n_clusters=4, batch_size=128,
                          random_state=0).fit(X)
    steps = fit.n_steps_
    fit.partial_fit(X[:128])
    assert fit.n_steps_ == steps + 1


def test_minibatch_from_numpy_predicts_as_jax(blobs):
    X, _ = blobs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxMiniBatch(n_clusters=4, delta=0.5, random_state=0,
                           batch_size=128).fit(X)
    attrs = {k: v for k, v in vars(ref).items() if k.endswith("_")}
    port = minibatch_from_numpy(attrs, device="cpu", params=ref.get_params())
    assert type(port) is MiniBatchQKMeans and port.delta == 0.5
    assert (port.n_iter_, port.n_steps_) == (ref.n_iter_, ref.n_steps_)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    # distances cancel ‖x‖² + ‖c‖² against 2·x·c: held at 1e-5 of their
    # largest
    dist = ref.transform(X[:20])
    np.testing.assert_allclose(port.transform(X[:20]), dist, rtol=1e-5,
                               atol=1e-5 * dist.max())
    assert port.score(X) == pytest.approx(ref.score(X), rel=1e-5)
    port.partial_fit(X[:64])
    assert port.n_steps_ == ref.n_steps_ + 1
    from sq_learn_tpu.models import MiniBatchKMeans as JaxMBK

    classic = JaxMBK(n_clusters=4, random_state=0).fit(X)
    assert type(minibatch_from_numpy(
        {k: v for k, v in vars(classic).items() if k.endswith("_")},
        params=classic.get_params(), device="cpu")) is MiniBatchKMeans
    with pytest.raises(ValueError, match="counts_"):
        minibatch_from_numpy({"cluster_centers_": attrs["cluster_centers_"]})


def test_validation_and_unported_store_input(blobs):
    """Input validation; a row source (here the in-RAM twin of a shard
    store) now fits out of core, as ``tests/test_torch_oocore.py`` holds
    in full: ``fit`` runs ``max_iter`` epochs, ``partial_fit`` one epoch,
    and ``predict`` of a store points to ``oocore.assign_labels``."""
    from sq_learn_tpu_torch.oocore import ArraySource

    X, y = blobs
    with pytest.raises(ValueError, match="n_init"):
        MiniBatchKMeans(n_clusters=3, n_init="Auto").fit(X)
    with pytest.raises(ValueError, match="n_samples=2"):
        MiniBatchKMeans(n_clusters=3).fit(X[:2])
    with pytest.raises(ValueError, match="n_samples=2"):
        MiniBatchKMeans(n_clusters=3).fit(ArraySource(X[:2]))

    source = ArraySource(X, shard_rows=100)
    est = MiniBatchKMeans(n_clusters=4, batch_size=128, max_iter=3,
                          random_state=0).fit(source)
    assert est.n_iter_ == 3 and est.n_steps_ == 3 * 5
    assert adjusted_rand_score(y, est.labels_) > 0.95
    est.partial_fit(source)
    assert est.n_steps_ == 4 * 5
    with pytest.raises(ValueError, match="assign_labels"):
        est.predict(source)
    est = MiniBatchKMeans(n_clusters=4, n_init="auto", random_state=0)
    assert est._resolved_n_init() == 1
    assert MiniBatchKMeans(init="random",
                           n_init="auto")._resolved_n_init() == 3


def test_facades_export_the_estimators():
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch import cluster

    assert cluster.MiniBatchQKMeans is sqt.MiniBatchQKMeans \
        is MiniBatchQKMeans
    assert cluster.MiniBatchKMeans is sqt.models.MiniBatchKMeans
