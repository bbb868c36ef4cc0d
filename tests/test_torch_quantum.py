"""The port's quantum routines (``ops/quantum``, the ``QuantumUtility``
facade) against the JAX package's, on the CPU.

Deterministic pieces (grid sizes, qubit counts, Fejér probabilities, the
consistent-PE snap grid, the phase-argument maps, μ(A)) must equal the
JAX functions at rtol 1e-5 on the same numpy inputs. The stochastic
routines draw from torch generators and JAX keys, whose streams differ,
so they are held in distribution: a two-sample Kolmogorov–Smirnov test
at α = 1e-3 (per statistic; the number of draws is stated at each test)
against the JAX function's draws on the same inputs, plus the guarantee
rates ``tests/test_quantum_core.py`` and ``tests/test_quantum_estimation.py``
pin for the JAX side, on the same inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import sq_learn_tpu.QuantumUtility as JQU
from sq_learn_tpu.ops import quantum as jq
from sq_learn_tpu.ops.quantum import norms as jnorms
from sq_learn_tpu.ops.quantum import sampling as jsampling
import sq_learn_tpu_torch.QuantumUtility as TQU
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.ops import quantum as tq
from sq_learn_tpu_torch.ops.quantum import estimation as testimation
from sq_learn_tpu_torch.ops.quantum import norms as tnorms
from sq_learn_tpu_torch.ops.quantum import sampling as tsampling

ALPHA = 1e-3  # two-sample tests: the rate at which a correct port fails


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def random_unit(seed, d):
    v = np.random.RandomState(seed).randn(d)
    return v / np.linalg.norm(v)


def same_distribution(a, b):
    """Two-sample KS: the port's draws ``a`` and the JAX draws ``b`` come
    from one distribution at level ALPHA."""
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > ALPHA, p


def exact_fejer_pmf(pos, M):
    """p(j) ∝ |sin(π(pos−j))/(M sin(π(pos−j)/M))|², j=0..M−1, circular."""
    j = np.arange(M)
    diff = (pos - j) / M
    diff = diff - np.round(diff)
    p = np.empty(M)
    for i, d in enumerate(diff):
        if abs(np.sin(np.pi * d)) < 1e-15:
            p[i] = 1.0
        else:
            p[i] = (np.sin(np.pi * M * d) / (M * np.sin(np.pi * d))) ** 2
    return p / p.sum()


# -- deterministic pieces, rtol 1e-5 ---------------------------------------


@pytest.mark.parametrize("M", [8.0, 64.0, 1024.0])
def test_fejer_probs_match_jax(M):
    delta = np.linspace(-1.5, 1.5, 301).astype(np.float32)
    np.testing.assert_allclose(
        tsampling.fejer_probs(torch.from_numpy(delta), M).numpy(),
        np.asarray(jsampling.fejer_probs(jnp.asarray(delta), M)),
        rtol=1e-5, atol=1e-7)
    assert float(tsampling.fejer_probs(torch.tensor(1.0), 32)) == 1.0


@pytest.mark.parametrize("d,delta,norm", [(784, 0.1, "L2"), (70_000, 0.4, "L2"),
                                          (50, 0.3, "inf")])
def test_tomography_n_measurements_match_jax(d, delta, norm):
    assert (tq.tomography_n_measurements(d, delta, norm)
            == jq.tomography_n_measurements(d, delta, norm))


def test_grid_sizes_and_qubit_counts_match_jax():
    for eps in (0.4, 0.05, 0.01, 1e-3, 5.6e-6):
        assert tq.amplitude_estimation_M(eps) == jq.amplitude_estimation_M(eps)
        for gamma in (0.1, 0.05, 1 - 1 / 784):
            assert (tq.phase_estimation_m(eps, gamma)
                    == jq.phase_estimation_m(eps, gamma))
    for gamma in (0.3, 0.1, 0.01, 0.001):
        assert tq.median_q(gamma) == jq.median_q(gamma)


@pytest.mark.parametrize("eps,gamma", [(0.05, 0.1), (0.02, 0.1),
                                       (5.6e-6, 1 - 1 / 784)])
def test_cpe_outputs_lie_on_the_ports_snap_grid(eps, gamma):
    """The JAX function's consistent-PE outputs are midpoints of the
    port's interval boundaries (float32, rtol 1e-5), and so are the
    port's."""
    iv, _ = testimation.consistent_phase_intervals(eps, gamma)
    mids = np.maximum((iv[:-1] + iv[1:]) / 2, 0.0).astype(np.float32)
    omega = np.random.default_rng(3).uniform(0.05, 0.95, 400).astype(
        np.float32)
    j = np.asarray(jq.consistent_phase_estimation(
        jax.random.PRNGKey(0), jnp.asarray(omega), eps, gamma))
    t = tq.consistent_phase_estimation(gen(), torch.from_numpy(omega), eps,
                                       gamma).numpy()
    for out in (j, t):
        pos = np.clip(np.searchsorted(mids, out), 1, len(mids) - 1)
        near = np.where(np.abs(out - mids[pos - 1]) < np.abs(out - mids[pos]),
                        mids[pos - 1], mids[pos])
        np.testing.assert_allclose(out, near, rtol=1e-5, atol=1e-7)


def test_phase_argument_maps_match_jax():
    sv = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    for eps in (0.1, 0.01):
        tt = tq.sv_to_theta(torch.from_numpy(sv), eps)
        jt = jq.sv_to_theta(jnp.asarray(sv), eps)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
        np.testing.assert_allclose(tq.theta_to_sv(tt, eps).numpy(),
                                   np.asarray(jq.theta_to_sv(jt, eps)),
                                   rtol=1e-5, atol=1e-6)
        back = tq.theta_to_sv(tq.sv_to_theta(torch.linspace(0, 1, 11), eps),
                              eps)
        np.testing.assert_allclose(back.numpy(), np.linspace(0, 1, 11),
                                   rtol=1e-5, atol=1e-6)


def _mu_data(seed, shape=(40, 12)):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=shape) * np.linspace(0.5, 3.0, shape[1])
    A[rng.random(shape) < 0.2] = 0.0  # zeros exercise the q = 0 count
    return A.astype(np.float32)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_mu_matches_jax(p):
    A = _mu_data(0)
    np.testing.assert_allclose(float(tq.mu(torch.from_numpy(A), p)),
                               float(jq.mu(A, p)), rtol=1e-5)


@pytest.mark.parametrize("grid", [(0.0, 1.0, 0.1), (0.0, 1.0, 0.05),
                                  (0.2, 0.7, 0.25)])
def test_linear_search_and_best_mu_match_jax(grid):
    A = _mu_data(1)
    tp, tv = tq.linear_search(torch.from_numpy(A), *grid)
    jp, jv = jq.linear_search(A, *grid)
    assert tp == jp
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    td, tval = tq.best_mu(torch.from_numpy(A), *grid)
    jd, jval = jq.best_mu(A, *grid)
    assert td == jd
    np.testing.assert_allclose(tval, jval, rtol=1e-5)


def test_tall_mu_sweep_matches_jax_blocked_sweep(monkeypatch):
    """On a tall matrix the port's one fused sweep gives the values of the
    JAX package's row-tiled sweep (its tiles shrunk so it engages) and of
    its fused one."""
    A = _mu_data(2, (300, 8))
    grid = jnorms._search_grid(0.0, 1.0, 0.1)
    fused = np.asarray(jnorms._mu_grid(A, grid))
    monkeypatch.setattr(jnorms, "_TILE_ELEMS", 64)
    assert jnorms.blocked_worthwhile(*A.shape)
    jblocked = np.asarray(jnorms._mu_grid_blocked(A, grid))
    port = tnorms._mu_grid(torch.from_numpy(A), grid).numpy()
    np.testing.assert_allclose(port, jblocked, rtol=1e-5)
    np.testing.assert_allclose(port, fused, rtol=1e-5)


def test_mu_grid_validation():
    with pytest.raises(ValueError):
        tq.mu(torch.ones(3, 3), 1.5)
    with pytest.raises(ValueError):
        tq.linear_search(torch.ones(3, 3), 0.5, 0.2)
    with pytest.raises(ValueError):
        tq.best_mu(torch.ones(3, 3), 0.0, 1.0, 0.0)
    desc, val = tq.best_mu(torch.eye(8))
    assert val <= math.sqrt(8) + 1e-6
    assert desc.startswith("p=") or desc == "Frobenius"


# -- the multinomial split tree --------------------------------------------


def test_multinomial_tree_matches_jax_in_distribution():
    """Counts of n = 50 draws over 6 categories, 3000 draws on each side:
    every category's count distribution passes the two-sample test against
    the JAX package's XLA multinomial (under jit, its chain route)."""
    p = np.array([0.05, 0.3, 0.02, 0.25, 0.18, 0.2], np.float32)
    draws = 3000
    t = tq.multinomial_counts(gen(), 50, torch.from_numpy(
        np.tile(p, (draws, 1)))).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    j = np.asarray(jax.jit(jax.vmap(
        lambda k: jq.multinomial_counts(k, 50, jnp.asarray(p))))(keys))
    assert (t.sum(1) == 50).all() and t.dtype == np.float64
    for c in range(len(p)):
        same_distribution(t[:, c], j[:, c])
    np.testing.assert_allclose(t.mean(0), 50 * p, atol=0.2)


@pytest.mark.parametrize("d", [1, 2, 3, 784, 1025])
def test_multinomial_tree_takes_log2_d_levels(d):
    p = torch.rand(4, d, generator=gen(d), dtype=torch.float64)
    before = tq.multinomial_counts.binomial_calls
    counts = tq.multinomial_counts(gen(), 10_000, p)
    assert (tq.multinomial_counts.binomial_calls - before
            == (math.ceil(math.log2(d)) if d > 1 else 0))
    assert counts.shape == (4, d)
    assert bool((counts.sum(-1) == 10_000).all())
    assert bool((counts[p == 0] == 0).all())


def test_multinomial_tree_counts_stay_exact_past_float32():
    """N = 1.8·10⁸ (tomography of a 70 000-vector at δ = 0.4) sums exactly
    in float64; a zero-mass row comes back NaN; N may differ per row."""
    n = tq.tomography_n_measurements(70_000, 0.4)
    assert n > 2**24
    p = torch.rand(2, 5000, generator=gen(1), dtype=torch.float64)
    counts = tq.multinomial_counts(gen(), n, p)
    assert bool((counts.sum(-1) == n).all())
    zero = tq.multinomial_counts(gen(), 10, torch.zeros(2, 3))
    assert bool(torch.isnan(zero).all())
    per_row = tq.multinomial_counts(gen(), torch.tensor([5.0, 7.0]),
                                    torch.ones(2, 4))
    assert per_row.sum(-1).tolist() == [5.0, 7.0]


# -- noise ------------------------------------------------------------------


@pytest.mark.parametrize("bound", [1.0, 0.3, 2.5])
def test_truncated_noise_matches_jax_in_distribution(bound):
    """5000 draws on each side, two-sample test; every draw within the
    bound."""
    t = tq.truncated_noise(gen(), bound, (5000,)).numpy()
    j = np.asarray(jq.truncated_noise(jax.random.PRNGKey(1), bound, (5000,)))
    assert np.abs(t).max() <= bound
    same_distribution(t, j)


def test_truncated_noise_zero_bound_is_exactly_zero():
    b = torch.tensor([0.0, 0.5, 0.0, 2.0])
    out = tq.truncated_noise(gen(), b, (3, 4))
    assert bool((out[:, b == 0] == 0).all())
    assert bool((out[:, 1].abs() <= 0.5).all())


def test_noise_injector_guarantees():
    out = tq.introduce_error(gen(), torch.zeros(1000), 0.1)
    assert float(out.abs().max()) <= 0.1 + 1e-6
    out = tq.introduce_error_array(gen(), torch.zeros(100), 0.5)
    assert float(torch.linalg.norm(out)) <= 0.5 + 1e-5
    out = tq.introduce_error_array(gen(), torch.zeros(3, 100),
                                   torch.tensor([0.1, 0.2, 0.3]))
    assert (torch.linalg.norm(out, dim=1) <= torch.tensor([0.1, 0.2, 0.3])
            + 1e-6).all()
    v = torch.from_numpy(random_unit(0, 64)).float()
    est = tq.gaussian_estimate(gen(), v, 0.3)
    assert float(torch.linalg.norm(est - v)) <= 0.3 + 1e-5
    v = torch.from_numpy(random_unit(1, 16)).float()
    assert torch.equal(tq.gaussian_estimate(gen(), v, 0.0), v)


def test_gaussian_estimate_matches_jax_in_distribution():
    """Per-component errors of 200 draws of a 64-vector at noise 0.3."""
    v = random_unit(2, 64).astype(np.float32)
    t = (tq.gaussian_estimate(gen(), torch.from_numpy(np.tile(v, (200, 1))),
                              0.3).numpy() - v)
    j = np.stack([np.asarray(jq.gaussian_estimate(k, v, 0.3)) - v
                  for k in jax.random.split(jax.random.PRNGKey(2), 200)])
    same_distribution(t, j)


# -- Fejér sampler, AE, PE, CPE, IPE ---------------------------------------


def test_fejer_sampler_matches_exact_pmf_and_jax():
    M, pos, n = 32, 7.3, 40000
    t = tq.fejer_grid_sample(gen(), torch.full((n,), pos), float(M),
                             window=64).numpy()
    emp = np.bincount(t.astype(int), minlength=M) / n
    assert 0.5 * np.abs(emp - exact_fejer_pmf(pos, M)).sum() < 0.02
    j = np.asarray(jq.fejer_grid_sample(jax.random.PRNGKey(3),
                                        jnp.full((5000,), pos), float(M), 64))
    same_distribution(t[:5000], j)


def test_fejer_sampler_wraps_and_takes_per_element_grids():
    M = 64
    j = tq.fejer_grid_sample(gen(), torch.full((20000,), 0.2), float(M),
                             32).numpy()
    assert j.min() >= 0 and j.max() <= M - 1
    assert (j > M / 2).mean() > 0.02
    Ms = torch.tensor([8.0, 64.0, 1024.0])
    out = tq.fejer_grid_sample(gen(), torch.tensor([2.2, 31.7, 512.4]), Ms,
                               window=16)
    assert out.shape == (3,) and bool((out < Ms).all())


def test_amplitude_estimation_guarantee_and_distribution():
    a = np.random.default_rng(7).uniform(0.02, 0.98, 500).astype(np.float32)
    eps = 0.01
    t = tq.amplitude_estimation(gen(), torch.from_numpy(a), epsilon=eps,
                                gamma=0.05).numpy()
    bound = 2 * np.pi * eps * np.sqrt(a * (1 - a)) + (np.pi * eps) ** 2
    assert (np.abs(t - a) <= bound).mean() >= 0.93
    j = np.asarray(jq.amplitude_estimation(jax.random.PRNGKey(4),
                                           jnp.asarray(a), epsilon=eps,
                                           gamma=0.05))
    same_distribution(t - a, j - a)
    ends = tq.amplitude_estimation(gen(), torch.tensor([0.0, 1.0]),
                                   epsilon=0.01, gamma=0.01)
    np.testing.assert_allclose(ends.numpy(), [0.0, 1.0], atol=5e-3)
    assert tq.amplitude_estimation(gen(), 0.3, epsilon=0.05).shape == ()


def test_amplitude_estimation_per_eps():
    eps = torch.from_numpy(np.geomspace(0.001, 0.1, 200).astype(np.float32))
    est = tq.amplitude_estimation_per_eps(gen(), torch.full((200,), 0.4),
                                          eps, Q=13).numpy()
    err = np.abs(est - 0.4)
    assert err[:50].mean() < err[-50:].mean() + 0.02
    assert (err <= 4 * eps.numpy() + 1e-3).mean() > 0.9


@pytest.mark.parametrize("a0", [0.11, 0.5, 0.83])
def test_ae_guarantee_small_epsilon(a0):
    """ε = 0.001 (M ≈ 3143 ≫ the 129 enumerated points), γ = 0.05, 4000
    trials: within ε w.p. ≥ 1 − γ."""
    est = tq.amplitude_estimation(gen(), torch.full((4000,), a0),
                                  epsilon=1e-3, gamma=0.05).numpy()
    assert (np.abs(est - a0) <= 1e-3).mean() >= 0.95


def test_ae_single_shot_success_floor():
    est = tq.amplitude_estimation(gen(), torch.full((6000,), 0.27),
                                  epsilon=1e-3).numpy()
    assert (np.abs(est - 0.27) <= 1e-3).mean() >= 8 / np.pi**2 - 0.02


def test_phase_estimation_pmf_guarantee_and_edges():
    m, omega = 6, 0.37
    M = 2**m
    t = tq.phase_estimation(gen(), torch.full((30000,), omega), m=m).numpy()
    emp = np.bincount((t * M).astype(int), minlength=M) / len(t)
    assert 0.5 * np.abs(emp - exact_fejer_pmf(omega * M, M)).sum() < 0.02
    w = np.random.default_rng(3).uniform(size=500).astype(np.float32)
    est = tq.phase_estimation(gen(), torch.from_numpy(w), epsilon=0.01,
                              gamma=0.1).numpy()
    err = np.abs(est - w)
    err = np.minimum(err, 1 - err)
    assert (err <= 0.01).mean() >= 1 - 0.1 - 0.03
    j = np.asarray(jq.phase_estimation(jax.random.PRNGKey(5), jnp.asarray(w),
                                       epsilon=0.01, gamma=0.1))
    jerr = np.abs(j - w)
    same_distribution(err, np.minimum(jerr, 1 - jerr))
    assert float(tq.phase_estimation(gen(), torch.tensor([1.0]), m=5)[0]) \
        == 31 / 32
    with pytest.raises(ValueError):
        tq.phase_estimation(gen(), 0.5)


def test_consistent_phase_estimation_guarantees():
    ests = np.array([
        float(tq.consistent_phase_estimation(g, 0.4321, epsilon=0.05,
                                             gamma=0.1))
        for g in (gen(s) for s in range(50))])
    _, counts = np.unique(np.round(ests, 6), return_counts=True)
    assert counts.max() / len(ests) >= 0.9
    w = np.random.default_rng(11).uniform(0.05, 0.95, 200).astype(np.float32)
    est = tq.consistent_phase_estimation(gen(), torch.from_numpy(w),
                                         epsilon=0.02, gamma=0.1).numpy()
    assert (np.abs(est - w) <= 2 * 0.02).mean() > 0.95
    j = np.asarray(jq.consistent_phase_estimation(
        jax.random.PRNGKey(6), jnp.asarray(w), epsilon=0.02, gamma=0.1))
    same_distribution(est - w, j - w)
    assert float(tq.consistent_phase_estimation(
        gen(), torch.tensor([0.001]), epsilon=0.05, gamma=0.1)[0]) >= 0.0


def test_median_evaluation_boosts():
    def noisy(generator):
        return torch.randn((), generator=generator) * 0.5 + 1.0

    assert abs(float(tq.median_evaluation(noisy, gen(), gamma=0.001))
               - 1.0) < 0.5


def _ipe_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 20)).astype(np.float32)
    y = rng.normal(size=(300, 20)).astype(np.float32)
    return (x * x).sum(1), (y * y).sum(1), (x * y).sum(1)


def test_ipe_guarantee_and_distribution():
    x2, y2, ip = _ipe_inputs()
    t = tq.ipe(gen(), torch.from_numpy(x2), torch.from_numpy(y2),
               torch.from_numpy(ip), epsilon=0.05, gamma=0.05).numpy()
    tol = 0.05 * np.maximum(1.0, np.abs(ip))
    assert (np.abs(t - ip) <= tol).mean() >= 0.9
    j = np.asarray(jq.ipe(jax.random.PRNGKey(7), jnp.asarray(x2),
                          jnp.asarray(y2), jnp.asarray(ip), epsilon=0.05,
                          gamma=0.05))
    same_distribution(t - ip, j - ip)


def test_inner_product_estimates_and_the_blocked_matrix(monkeypatch):
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    true = (X @ C.T).numpy()
    tol = 0.05 * np.maximum(1.0, np.abs(true))
    est = tq.inner_product_estimates(gen(), X, C, epsilon=0.01, gamma=0.1)
    assert est.shape == (40, 5)
    assert (np.abs(est.numpy() - true) <= tol).mean() > 0.9
    # rows taken in blocks of 3 when the sampler transient is capped
    monkeypatch.setattr(testimation, "_IPE_BLOCK_ELEMS", 5 * 5 * 129 * 3)
    blocked = tq.inner_product_estimates(gen(), X, C, epsilon=0.01, Q=5)
    assert blocked.shape == (40, 5)
    assert (np.abs(blocked.numpy() - true) <= tol).mean() > 0.9


# -- tomography -------------------------------------------------------------


def test_tomography_guarantees():
    v = torch.from_numpy(random_unit(2, 50)).float()
    assert float(torch.linalg.norm(tq.real_tomography(gen(), v, delta=0.3)
                                   - v)) <= 0.3
    v = random_unit(3, 20)
    est = tq.real_tomography(gen(), torch.from_numpy(v).float(),
                             delta=0.1).numpy()
    big = np.abs(v) > 0.15
    assert (np.sign(est[big]) == np.sign(v[big])).all()
    v = 5.0 * torch.from_numpy(random_unit(4, 30)).float()
    np.testing.assert_allclose(
        float(torch.linalg.norm(tq.real_tomography(gen(), v, delta=0.2))),
        5.0, rtol=0.05)
    raw = tq.real_tomography(gen(), v, delta=0.2, preserve_norm=False)
    np.testing.assert_allclose(float(torch.linalg.norm(raw)), 1.0, rtol=0.05)


def test_tomography_of_matrix_rows_and_per_row_n():
    A = torch.from_numpy(np.vstack([random_unit(s, 16)
                                    for s in range(4)])).float()
    est = tq.tomography(gen(), A, 0.3)
    assert est.shape == A.shape
    assert bool((torch.linalg.norm(est - A, dim=1) <= 0.3).all())
    N = torch.tensor([10.0, 100.0, 10_000.0, 1_000_000.0])
    est = tq.real_tomography(gen(), A, N=N)
    err = torch.linalg.norm(est - A, dim=1)
    assert float(err[3]) < float(err[0])
    assert bool(torch.isnan(tq.tomography(gen(), torch.zeros(6), 0.2)).all())


def test_tomography_short_circuits_and_gaussian_path():
    A = torch.from_numpy(np.random.RandomState(0).randn(3, 5)).float()
    assert tq.tomography(gen(), A, 0.0) is A
    B = torch.from_numpy(np.random.RandomState(1).randn(4, 6)).float()
    out = tq.tomography(gen(), B, 0.2, true_tomography=False)
    assert float(torch.linalg.norm(out - B)) <= 0.2 + 1e-5


def test_tomography_error_matches_jax_in_distribution():
    """L2 errors of 200 tomographies of a 16-vector at δ = 0.3, against the
    JAX package's XLA route (under jit) on the same vector."""
    v = random_unit(7, 16).astype(np.float32)
    t = torch.linalg.norm(
        tq.real_tomography(gen(), torch.from_numpy(np.tile(v, (200, 1))),
                           delta=0.3) - torch.from_numpy(v), dim=1).numpy()
    keys = jax.random.split(jax.random.PRNGKey(8), 200)
    j = np.asarray(jax.jit(jax.vmap(
        lambda k: jnp.linalg.norm(jq.real_tomography(k, jnp.asarray(v),
                                                     delta=0.3) - v)))(keys))
    assert t.max() <= 0.3 and j.max() <= 0.3
    same_distribution(t, j)


def test_magnitude_tomography_signed():
    rng = np.random.default_rng(0)
    v = rng.normal(size=32).astype(np.float32)
    v /= np.linalg.norm(v)
    est = tq.magnitude_tomography_signed(gen(), torch.from_numpy(v),
                                         delta=0.1).numpy()
    assert np.linalg.norm(est - v) <= 0.1
    nz = np.abs(v) > 1e-3
    assert np.all(np.sign(est[nz]) == np.sign(v[nz]))
    v2 = torch.tensor([0.6, -0.8])
    np.testing.assert_allclose(
        tq.magnitude_tomography_signed(gen(), v2, delta=0.0).numpy(),
        v2.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tq.magnitude_tomography_signed(gen(), v2)


def test_tomography_incremental_early_stop():
    v = torch.from_numpy(random_unit(5, 12)).float()
    res = tq.tomography_incremental(gen(), v, delta=0.4)
    ns = list(res)
    assert ns == sorted(ns)
    assert np.linalg.norm(res[ns[-1]] - v.numpy()) <= 0.4 * 1.5


# -- quantum state ------------------------------------------------------------


def test_quantum_state():
    qs = tq.QuantumState(torch.arange(4), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_allclose(float(qs.probabilities.sum()), 1.0, atol=1e-6)
    qs = tq.QuantumState(torch.tensor([0, 1]), torch.tensor([3.0, 4.0]))
    freq = qs.measure_counts(gen(), 100000).numpy() / 100000
    np.testing.assert_allclose(freq, [0.36, 0.64], atol=0.01)
    qs = tq.QuantumState(torch.tensor([10.0, 20.0]), torch.tensor([1.0, 1.0]))
    assert set(np.unique(qs.measure(gen(), 100).numpy())) <= {10.0, 20.0}
    np.testing.assert_allclose(list(qs.get_state().values()), [0.5, 0.5],
                               atol=1e-6)
    lst = tq.QuantumState([np.ones(2), np.zeros(2)], [1.0, 1.0])
    assert len(lst.measure(gen(), 3)) == 3
    with pytest.raises(ValueError):
        tq.QuantumState(torch.arange(3), torch.tensor([1.0, 1.0]))
    counts = tq.multinomial_counts(gen(), 1000, torch.tensor([0.5, 0.5]))
    np.testing.assert_allclose(float(tq.estimate_wald(counts, 1000).sum()),
                               1.0, atol=1e-6)


def test_coupon_collect_matches_jax_in_distribution():
    """300 collections of a 5-state uniform register on each side (the
    mean is 5·H₅ ≈ 11.42)."""
    qs = tq.QuantumState(torch.arange(5), torch.ones(5))
    t = np.array([tq.coupon_collect(gen(s), qs) for s in range(300)])
    jqs = jq.QuantumState(jnp.arange(5), jnp.ones(5))
    collect = jax.jit(lambda k: jq.coupon_collect(k, jqs))
    j = np.array([int(collect(k))
                  for k in jax.random.split(jax.random.PRNGKey(9), 300)])
    assert t.min() >= 5
    same_distribution(t, j)
    assert tq.coupon_collect(gen(), qs, max_draws=3) == 3


# -- the reference-name facade ----------------------------------------------


def test_quantum_utility_facade():
    assert TQU.L2_tomogrphy_fakeSign is TQU.magnitude_tomography_signed
    assert TQU.make_gaussian_est is tq.gaussian_estimate
    assert TQU.wrapper_phase_est_arguments is tq.sv_to_theta
    assert TQU.unwrap_phase_est_arguments is tq.theta_to_sv
    assert set(JQU.__all__) <= set(TQU.__all__)
    for arr, inc in (([1, 1, 2, 2, 3], 0), ([5, 3, 3, 10], 2)):
        assert TQU.check_measure(arr, inc) == JQU.check_measure(arr, inc)
    assert TQU.check_division(17, 5) == JQU.check_division(17, 5)
    w0, w1 = np.array([0.1, 0.9, 0.25]), np.array([0.95, 0.05, 0.3])
    np.testing.assert_allclose(
        TQU.amplitude_est_dist(torch.from_numpy(w0),
                               torch.from_numpy(w1)).numpy(),
        np.asarray(JQU.amplitude_est_dist(w0, w1)), rtol=1e-5)
    v = TQU.create_rand_vec(gen(), 3, 7, scale=2.0)
    assert v.shape == (3, 7) and float(v.abs().max()) <= 2.0
    assert TQU.create_rand_vec(gen(), 2, 4, type="normal").shape == (2, 4)
    with pytest.raises(ValueError):
        TQU.create_rand_vec(gen(), 2, 4, type="cauchy")
    qs = tq.QuantumState(torch.tensor([1.0, 2.0]), torch.ones(2))
    assert TQU.auxiliary_fun(qs, 4, gen()).shape == (4,)
    assert TQU.vectorize_aux_fun({1: 0.25}, 1) == 0.5
    assert TQU.vectorize_aux_fun({1: 0.25}, 2) == 0


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_auxiliary_fun_default_generator_follows_the_state(device):
    """Without a generator, the facade's measurement draws on the device
    of the state's probabilities, never on another one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU to hold a state on the card")
    qs = tq.QuantumState(torch.tensor([1.0, 2.0, 3.0], device=device),
                         torch.tensor([1.0, 0.0, 1.0], device=device))
    seen = []
    measure = qs.measure

    def spy(generator, n_times=1):
        seen.append(generator)
        return measure(generator, n_times=n_times)

    qs.measure = spy
    out = TQU.auxiliary_fun(qs, 50)
    assert seen[0].device.type == qs.probabilities.device.type == device
    assert out.device.type == device and out.shape == (50,)
    assert set(out.tolist()) <= {1.0, 3.0}
