"""The port's sketch engine and stats cache (``sketch/``) against the JAX
package's ``sketch/``, on the CPU.

Both sides take the SAME ``np.random.default_rng(seed)`` for the row
sample, so they sample the same rows: the sampled statistics and their
certified bounds must agree at rtol 1e-4 (float32 sums in another order).
The host-side bound math is held equal on the same components, and the
exact route (sketch 0) must be bit-equal to ``best_mu``'s winner rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sq_learn_tpu.ops.quantum import norms as jnorms
from sq_learn_tpu.sketch import cache as jcache
from sq_learn_tpu.sketch import engine as jengine
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.ops.quantum import norms as tnorms
from sq_learn_tpu_torch.sketch import cache as tcache
from sq_learn_tpu_torch.sketch import engine as tengine

GRID = (0.0, 0.25, 0.5, 0.75, 1.0)
MU_GRID = jnorms._search_grid(0.0, 1.0, 0.1)  # the qPCA fit's grid


@pytest.fixture(autouse=True)
def _cpu_and_fresh_caches():
    tcache.clear()
    jcache.clear()
    with config_context(device="cpu"):
        yield
    tcache.clear()
    jcache.clear()


def _data(n=2000, m=12, seed=0):
    rng = np.random.default_rng(seed)
    # anisotropic + shifted so σ_min / μ are non-degenerate
    X = rng.normal(size=(n, m)) * np.linspace(0.5, 3.0, m) + 0.3
    return X.astype(np.float32)


def _fields_close(t, j, rtol):
    for name in ("eta", "frob", "sigma_min", "sigma_min_lower"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=rtol, err_msg=name)
    for name in ("mu_vals", "mu_upper"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=rtol, err_msg=name)
    assert (t.sketched, t.sample_rows, t.shape, t.mu_grid) == (
        j.sketched, j.sample_rows, j.shape, j.mu_grid)
    assert t.delta_stat == j.delta_stat
    assert t.cost == j.cost


def test_resolve_sketch_rows_matches_jax(monkeypatch):
    cases = [(500, 8, "auto"), (100, 200, 4096), (70_000, 784, "auto"),
             (70_000, 784, 0), (70_000, 784, None), (70_000, 784, 1024),
             (20_000, 64, "auto"), (16_383, 64, "auto")]
    for n, m, setting in cases:
        assert (tengine.resolve_sketch_rows(n, m, setting)
                == jengine.resolve_sketch_rows(n, m, setting))
    assert tengine.resolve_sketch_rows(70_000, 784, "auto") == 4096
    for env in ("512", "0"):
        monkeypatch.setenv("SQ_SKETCH_ROWS", env)
        assert (tengine.resolve_sketch_rows(70_000, 784, "auto")
                == jengine.resolve_sketch_rows(70_000, 784, "auto"))
    monkeypatch.delenv("SQ_SKETCH_ROWS")
    monkeypatch.setenv("SQ_SKETCH_DELTA", "0")
    assert tengine.resolve_sketch_rows(70_000, 784, "auto") == 0
    assert tengine.sketch_delta_stat() == jengine.sketch_delta_stat() == 0.0


@pytest.mark.parametrize("with_sigma", [False, True])
@pytest.mark.parametrize("rows", [256, 500])
def test_sampled_spectral_stats_match_jax_on_the_same_rng(rows, with_sigma):
    X = _data()
    t = tengine.spectral_stats(torch.from_numpy(X), GRID, sketch=rows,
                               with_sigma=with_sigma,
                               rng=np.random.default_rng(7))
    j = jengine.spectral_stats(X, GRID, sketch=rows, with_sigma=with_sigma,
                               rng=np.random.default_rng(7))
    assert t.sketched and t.sample_rows == rows
    _fields_close(t, j, 1e-4)
    assert t.conservative_mu()[0] == j.conservative_mu()[0]
    # the device-array route of the JAX engine samples the same rows
    jd = jengine.spectral_stats(jnp.asarray(X), GRID, sketch=rows,
                                with_sigma=with_sigma,
                                rng=np.random.default_rng(7))
    _fields_close(t, jd, 1e-4)


def test_sampled_mu_stats_match_jax_and_bound_the_exact_mu():
    X = _data(4000, 16, seed=3)
    t = tengine.mu_stats(torch.from_numpy(X), MU_GRID, sketch=512,
                         rng=np.random.default_rng(11), tag="qpca.mu")
    j = jengine.mu_stats(X, MU_GRID, sketch=512,
                         rng=np.random.default_rng(11), tag="qpca.mu",
                         audit=False)
    _fields_close(t, j, 1e-4)
    desc_t, mu_t = t.conservative_mu()
    desc_j, mu_j = j.conservative_mu()
    assert desc_t == desc_j
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-4)
    exact = tnorms._mu_grid(torch.from_numpy(X), MU_GRID).numpy()
    assert (t.mu_upper >= exact * (1 - 1e-6)).all()
    assert mu_t <= t.frob * (1 + 1e-6)
    info = t.info()
    assert info["sketched"] and info["sample_rows"] == 512


@pytest.mark.parametrize("audit", [True, False])
def test_audit_false_records_no_guarantee_in_either_package(audit):
    """``audit=False``: neither package computes or records the sketch's
    guarantee draws; with it on both record the same sites."""
    from _torch_obs_helpers import record
    from sq_learn_tpu import obs as jobs
    from sq_learn_tpu_torch import obs as tobs

    X = _data(3000, 10, seed=5)

    def run(engine, data):
        def go():
            engine.spectral_stats(data, GRID, sketch=512, audit=audit,
                                  rng=np.random.default_rng(3))
            engine.mu_stats(data, MU_GRID, sketch=512, audit=audit,
                            rng=np.random.default_rng(4), tag="audit")
        return go

    _, jrec = record(jobs, run(jengine, X))
    _, prec = record(tobs, run(tengine, torch.from_numpy(X)))
    theirs = [g["site"] for g in jrec.guarantee_records]
    ours = [g["site"] for g in prec.guarantee_records]
    assert ours == theirs
    assert ("sketch.mu" in ours) is audit


def test_numpy_input_is_validated_onto_the_configured_device():
    X = _data(400, 6)
    st = tengine.spectral_stats(X, GRID)
    ref = tengine.spectral_stats(torch.from_numpy(X), GRID)
    assert st.mu_vals.tolist() == ref.mu_vals.tolist()


def test_exact_route_is_bit_equal_to_best_mu():
    X = torch.from_numpy(_data(400, 6))
    st = tengine.mu_stats(X, MU_GRID, sketch=0)
    assert not st.sketched and st.sample_rows == 0
    assert st.conservative_mu() == tnorms.best_mu(X, 0.0, 1.0, 0.1)
    np.testing.assert_array_equal(st.mu_vals, st.mu_upper)
    full = tengine.exact_spectral_stats(X, GRID)
    j = jengine.exact_spectral_stats(X.numpy(), GRID)
    _fields_close(full, j, 1e-5)


def test_bound_math_matches_jax_on_the_same_components():
    comp = {"eta": 812.5, "frob": 3210.0, "amax": 9.5, "colsq_max": 9.1e4,
            "row_fac": np.linspace(1.0, 50.0, 11),
            "col_fac": np.linspace(300.0, 2e4, 11), "lam_min": 1234.5}
    kw = dict(n=70_000, m=784, s=4096, mu_grid=MU_GRID, delta_stat=0.05)
    _fields_close(tengine.finalize_components(comp, **kw),
                  jengine.finalize_components(comp, **kw), 1e-12)
    for q in (0.0, 0.4, 2.0, 2.6):
        assert tengine._row_cap(q, 784, 812.5, 9.5) == jengine._row_cap(
            q, 784, 812.5, 9.5)
        assert tengine._col_cap(q, 7e4, 9e4, 9.5) == jengine._col_cap(
            q, 7e4, 9e4, 9.5)
    assert (tengine._bernstein_gram_deviation(7e4, 4096, 784, 812.5, 3210.0,
                                              0.025)
            == jengine._bernstein_gram_deviation(7e4, 4096, 784, 812.5,
                                                 3210.0, 0.025))


def test_mu_stats_are_cached_per_dataset(monkeypatch):
    X = torch.from_numpy(_data(400, 6))
    first = tengine.mu_stats(X, GRID, sketch=0)
    assert tengine.mu_stats(X, GRID, sketch=0) is first
    assert tengine.mu_stats(X.clone(), GRID, sketch=0) is first
    moved = X.clone()
    moved[0, 0] += 1.0
    assert tengine.mu_stats(moved, GRID, sketch=0) is not first
    tcache.clear()
    assert tengine.mu_stats(X, GRID, sketch=0) is not first
    monkeypatch.setenv("SQ_STATS_CACHE", "0")
    assert tcache.key_for(X, "mu") is None
    assert tengine.mu_stats(X, GRID, sketch=0) is not tengine.mu_stats(
        X, GRID, sketch=0)


def test_mu_stats_cache_keys_the_seed_and_in_place_changes():
    """A sampled entry belongs to one generator state, and an in-place
    change to a row the digest does not sample still misses."""
    X = torch.from_numpy(_data(4000, 16, seed=3))
    first = tengine.mu_stats(X, MU_GRID, sketch=512,
                             rng=np.random.default_rng(1))
    assert tengine.mu_stats(X, MU_GRID, sketch=512,
                            rng=np.random.default_rng(1)) is first
    other = tengine.mu_stats(X, MU_GRID, sketch=512,
                             rng=np.random.default_rng(2))
    fresh = tengine.spectral_stats(X, MU_GRID, sketch=512, with_sigma=False,
                                   rng=np.random.default_rng(2))
    assert other is not first
    assert other.mu_upper.tolist() == fresh.mu_upper.tolist()

    exact = tengine.mu_stats(X, MU_GRID, sketch=0)
    digested = set(np.linspace(0, 3999, num=64, dtype=np.int64).tolist())
    row = next(i for i in range(4000) if i not in digested)
    digest = tcache.data_digest(X)
    X[row] *= 10.0
    assert tcache.data_digest(X) == digest
    after = tengine.mu_stats(X, MU_GRID, sketch=0)
    assert after is not exact
    assert after.mu_vals.tolist() == tengine.exact_spectral_stats(
        X, MU_GRID, with_sigma=False).mu_vals.tolist()
    assert not np.allclose(after.mu_vals, exact.mu_vals)


def test_cache_digest_matches_jax_and_is_bounded():
    X = _data(300, 5)
    assert tcache.data_digest(torch.from_numpy(X)) == jcache.data_digest(X)
    assert tcache.data_digest(X) == jcache.data_digest(X)
    for i in range(tcache.MAX_ENTRIES + 3):
        tcache.store(("k", i), i)
    assert tcache.lookup(("k", 0)) is None
    assert tcache.lookup(("k", tcache.MAX_ENTRIES + 2)) == (
        tcache.MAX_ENTRIES + 2)
    assert tcache.lookup(None) is None


def test_frobenius_squared_matches_jax():
    X = _data(500, 9)
    np.testing.assert_allclose(tengine.frobenius_squared(torch.from_numpy(X)),
                               jengine.frobenius_squared(X), rtol=1e-12)
    np.testing.assert_allclose(tengine.frobenius_squared(X),
                               jengine.frobenius_squared(X), rtol=1e-12)
