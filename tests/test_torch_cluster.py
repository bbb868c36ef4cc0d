"""``kmeans_plusplus`` and ``cluster.select_labels`` of the port against
the JAX package's, on the CPU.

jax threefry and torch Philox streams cannot match bit for bit, so the
draws are held in distribution (``ROADMAP.md``'s parity rules): over
4 000 draws each, the first center's frequencies of both packages fit the
weights (chi-square, p > 1e-3) and each other (a 2 × n contingency test,
p > 1e-3); ``select_labels``' picks fit the uniform law. The rest is
exact: data rows, never a zero-weight row, the same picks from the same
generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sq_learn_tpu.cluster import kmeans_plusplus as jax_kmeans_plusplus
from sq_learn_tpu.cluster import select_labels as jax_select_labels
from sq_learn_tpu_torch import cluster, config_context, models
from sq_learn_tpu_torch.cluster import kmeans_plusplus, select_labels

DRAWS = 4000
P_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _data(n=40, m=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    w = (np.arange(n) % 5 + 1).astype(np.float32)
    w[::7] = 0.0  # rows 0, 7, 14, ...: never a center
    return X, w


def _generator(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_the_names_are_exported_where_the_jax_package_has_them():
    for mod in (models, cluster):
        assert mod.kmeans_plusplus is kmeans_plusplus
        assert mod.lloyd_single is models.qkmeans.lloyd_single
        assert {"kmeans_plusplus", "lloyd_single"} <= set(mod.__all__)
    assert "select_labels" in cluster.__all__


def test_kmeans_plusplus_picks_weighted_data_rows_repeatably():
    X, w = _data()
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    centers, idx = kmeans_plusplus(_generator(0), Xt, None, 5, weights=wt)
    assert centers.shape == (5, 6) and idx.shape == (5,)
    assert len(set(idx.tolist())) == 5
    assert (w[idx.numpy()] > 0).all()
    np.testing.assert_array_equal(centers.numpy(), X[idx.numpy()])
    # the same generator seed, the same rows (given norms or computed)
    again, idx2 = kmeans_plusplus(_generator(0), Xt, (Xt * Xt).sum(1), 5,
                                  weights=wt)
    assert torch.equal(idx, idx2) and torch.equal(centers, again)
    # one restart of the batched init from the same generator
    _, batched = models.qkmeans.kmeans_plusplus_batched(
        _generator(0), Xt, None, 5, n_restarts=1, weights=wt)
    assert torch.equal(batched[0], idx)


def test_kmeans_plusplus_never_picks_a_zero_weight_row():
    X, w = _data()
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    g = _generator(5)
    for _ in range(200):
        _, idx = kmeans_plusplus(g, Xt, None, 4, weights=wt)
        assert (w[idx.numpy()] > 0).all()


def test_kmeans_plusplus_first_center_matches_jax_in_distribution():
    X, w = _data()
    n = X.shape[0]
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    g = _generator(11)
    ours = np.array([int(kmeans_plusplus(g, Xt, None, 1, weights=wt)[1][0])
                     for _ in range(DRAWS)])
    Xj, wj = jnp.asarray(X), jnp.asarray(w)
    xsq = jnp.sum(Xj * Xj, axis=1)
    keys = jax.random.split(jax.random.PRNGKey(11), DRAWS)
    theirs = np.asarray(jax.vmap(
        lambda k: jax_kmeans_plusplus(k, Xj, xsq, 1, weights=wj)[1][0])(keys))
    live = w > 0
    assert live[ours].all() and live[theirs].all()
    expected = w[live].astype(np.float64) / w[live].sum() * DRAWS
    for draws in (ours, theirs):
        counts = np.bincount(draws, minlength=n)[live]
        assert stats.chisquare(counts, expected).pvalue > P_FLOOR
    table = np.stack([np.bincount(ours, minlength=n)[live],
                      np.bincount(theirs, minlength=n)[live]])
    assert stats.chi2_contingency(table).pvalue > P_FLOOR


@pytest.mark.parametrize("a", [[3, 7, 9], np.array([3, 7, 9]),
                               torch.tensor([3, 7, 9])])
def test_select_labels_picks_uniformly(a):
    g = _generator(2)
    picks = np.array([int(select_labels(a, g)) for _ in range(3000)])
    assert set(picks) <= {3, 7, 9}
    counts = np.array([(picks == v).sum() for v in (3, 7, 9)])
    assert stats.chisquare(counts).pvalue > P_FLOOR
    # the JAX shim's picks, from keys: the same law
    keys = jax.random.split(jax.random.PRNGKey(2), 300)
    jax_picks = np.array([int(jax_select_labels(np.array([3, 7, 9]), k))
                          for k in keys])
    jax_counts = np.array([(jax_picks == v).sum() for v in (3, 7, 9)])
    assert stats.chi2_contingency(np.stack([counts, jax_counts])).pvalue \
        > P_FLOOR


def test_select_labels_repeats_under_one_seed_and_raises_when_empty():
    a = list(range(50))
    first = [select_labels(a, _generator(4)) for _ in range(3)]
    assert len(set(first)) == 1
    assert select_labels([6]) == 6  # a fresh entropy-seeded pick
    for empty in ([], np.array([]), torch.tensor([])):
        with pytest.raises(ValueError, match="empty candidate set"):
            select_labels(empty)
        with pytest.raises(ValueError, match="empty candidate set"):
            jax_select_labels(np.asarray(empty))
