"""The port's QLSSVC and pairwise kernels against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and go through both sides.
Deterministic parts (kernels, the LS-SVM solve, h, β, P without noise, the
complexities) at rtol 1e-4 in float32; the noise models in distribution
(two-sample KS at α = 1e-3) and to their bound, which holds by
construction.

Run as a script from the repository root (``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_qlssvc.py``, a few minutes, ~3 GB) it measures,
on the split ``chip_smoke.py`` fits
(classes 0 and 1 of ``synthetic_surrogate(70_000, 784, 10, seed=784)``
as ±1, 8 000 training and 2 000 test rows from a seeded permutation), the
JAX package's ``classical_predict`` accuracy and its float32 error on the
singular values of F and on ``cond_`` against a float64 decomposition of
the same F, for the linear and rbf kernels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sq_learn_tpu.metrics import pairwise as jpair
from sq_learn_tpu.models import QLSSVC as JaxQLSSVC
from sq_learn_tpu.models import qlssvc as jsvc
from sq_learn_tpu_torch import QLSSVC, config_context
from sq_learn_tpu_torch.convert import qlssvc_from_numpy
from sq_learn_tpu_torch.metrics import pairwise as tpair
from sq_learn_tpu_torch.models import qlssvc as tsvc
from sq_learn_tpu_torch.utils import as_generator


def surrogate_split(X, y, n_train=8000, n_test=2000, seed=0):
    """Classes 0 and 1 of the surrogate as ±1 (class 0 → +1), split into
    training and test rows by a permutation from ``seed``."""
    rows = np.flatnonzero(y <= 1)
    rows = rows[np.random.default_rng(seed).permutation(len(rows))]
    tr, te = rows[:n_train], rows[n_train:n_train + n_test]
    ypm = np.where(y == 0, 1.0, -1.0)
    return X[tr], ypm[tr], X[te], ypm[te]


def jax_f_errors(kernel):
    """The JAX package's QLSSVC on the smoke's split, on the CPU: its
    classical_predict accuracy, and the largest relative error of its
    float32 singular values of F and of cond_ against a float64
    eigendecomposition of the same float32 F."""
    import jax.numpy as jnp

    from sq_learn_tpu.datasets import synthetic_surrogate
    from sq_learn_tpu.models import QLSSVC

    X, y = synthetic_surrogate(70_000, 784, 10, seed=784)
    Xtr, ytr, Xte, yte = surrogate_split(X, y)
    est = QLSSVC(kernel=kernel, random_state=0).fit(Xtr, ytr)
    acc = float(np.mean(est.classical_predict(Xte) == yte))
    K = np.asarray(est.get_kernel(jnp.asarray(Xtr)))
    N = K.shape[0]
    F = np.zeros((N + 1, N + 1), np.float32)
    F[0, 1:] = F[1:, 0] = 1.0
    F[1:, 1:] = K + np.float32(1.0 / est.penalty) * np.eye(N,
                                                          dtype=np.float32)
    s64 = np.sort(np.abs(np.linalg.eigvalsh(F.astype(np.float64))))[::-1]
    s32 = np.asarray(est.singular_values_F_, np.float64)
    sv_err = float(np.max(np.abs(s32 - s64) / s64))
    cond64 = s64[0] / s64[-1]
    return {"kernel": kernel, "accuracy": acc, "sv_rel_err": sv_err,
            "cond_rel_err": float(abs(est.cond_ - cond64) / cond64),
            "cond": float(est.cond_), "cond64": float(cond64)}


KS_ALPHA = 1e-3
KERNELS = ("linear", "poly", "rbf", "sigmoid")


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(n=160, m=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * X[:, 1] > 0, 1.0, -1.0)
    return X, y


@pytest.fixture(scope="module", params=KERNELS)
def fitted(request):
    X, y = _data()
    kw = dict(kernel=request.param, penalty=0.5, random_state=0)
    with config_context(device="cpu"):
        t = QLSSVC(**kw).fit(X[:120], y[:120])
    j = JaxQLSSVC(**kw).fit(X[:120], y[:120])
    return t, j, X[120:], y[120:]


# -- kernels ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["linear", "poly", "rbf", "sigmoid"])
def test_pairwise_kernels_match_jax(name):
    X, _ = _data(n=50)
    Y = X[:20] + 0.3
    kw = {} if name == "linear" else dict(gamma=0.2)
    if name in ("poly", "sigmoid"):
        kw["coef0"] = 0.5
    metric = "poly" if name == "poly" else name
    t = tpair.pairwise_kernels(_t(X), _t(Y), metric=metric, **kw).numpy()
    j = np.asarray(jpair.pairwise_kernels(X, Y, metric=metric, **kw))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)
    fn = getattr(tpair, f"{'polynomial' if name == 'poly' else name}_kernel")
    np.testing.assert_array_equal(fn(_t(X), _t(Y), **kw).numpy(), t)
    # Y=None is X against itself, and γ defaults to 1/m
    np.testing.assert_allclose(
        fn(_t(X)).numpy(),
        np.asarray(getattr(jpair, fn.__name__)(X)), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="unknown kernel"):
        tpair.pairwise_kernels(_t(X), metric="cosine")


# -- the solve -------------------------------------------------------------


@pytest.mark.parametrize("var", [None, 0.9, 40])
def test_lssvc_solve_matches_jax(var):
    # wider than tall: K has no repeated eigenvalue, so a truncation keeps
    # the same eigenvectors on both sides
    X, y = _data(n=80, m=120)
    K = X @ X.T
    b, alpha, s, cond, normF = tsvc.lssvc_solve(_t(K), y, 0.5, var=var)
    jb, ja, js, jc, jn = jsvc.lssvc_solve(jnp.asarray(K), y, 0.5, var=var)
    assert len(s) == len(js)
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4)
    assert float(b) == pytest.approx(float(jb), rel=1e-4, abs=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ja), rtol=1e-3,
                               atol=1e-4 * float(np.abs(ja).max()))
    assert cond == pytest.approx(jc, rel=1e-4)
    assert normF == pytest.approx(jn, rel=1e-4)


def test_the_saddle_system_is_solved():
    X, y = _data(n=60)
    K = _t(X @ X.T)
    b, alpha, *_ = tsvc.lssvc_solve(K, y, 0.5)
    sol = torch.cat([b[None], alpha]).double()
    rhs = torch.cat([torch.zeros(1), _t(y).float()]).double()
    res = tsvc.saddle_matrix(K, 0.5).double() @ sol - rhs
    assert float(res.abs().max()) <= 1e-3 * float(rhs.abs().max())


# -- the estimator ---------------------------------------------------------


def test_fit_state_matches_jax(fitted):
    t, j, _, _ = fitted
    assert t.b_ == pytest.approx(j.b_, rel=1e-4, abs=1e-6)
    np.testing.assert_allclose(t.alpha_, j.alpha_, rtol=1e-3,
                               atol=1e-4 * np.abs(j.alpha_).max())
    np.testing.assert_allclose(t.singular_values_F_, j.singular_values_F_,
                               rtol=1e-4)
    for name in ("cond_", "normF_", "alpha_F_", "Nu_"):
        assert getattr(t, name) == pytest.approx(getattr(j, name),
                                                 rel=1e-4), name
    if t.kernel == "linear":
        np.testing.assert_allclose(t.coef_, j.coef_, rtol=1e-4, atol=1e-5)
    assert isinstance(t.X_, torch.Tensor) and t.n_features_in_ == 8


def test_decision_pieces_without_noise_match_jax(fitted):
    t, j, Xte, _ = fitted
    np.testing.assert_allclose(t.get_h(Xte), j.get_h(Xte), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.get_betas(Xte), j.get_betas(Xte),
                               rtol=1e-4)
    np.testing.assert_allclose(t.get_P(Xte), j.get_P(Xte), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(t.classical_predict(Xte),
                                  j.classical_predict(Xte))


def test_complexities_on_carried_state_match_jax(fitted):
    _, j, Xte, _ = fitted
    t = qlssvc_from_numpy(vars(j), device="cpu", params=j.get_params())
    assert t.get_training_complexity() == pytest.approx(
        j.get_training_complexity(), rel=1e-4)
    for rel in (False, True):
        np.testing.assert_allclose(
            t.get_classification_complexity(Xte, relative_error=rel),
            j.get_classification_complexity(Xte, relative_error=rel),
            rtol=1e-4)
    for a, b in zip(t.get_all_attributes(Xte), j.get_all_attributes(Xte)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_qlssvc_from_numpy_rejects_inconsistent_state(fitted):
    _, j, _, _ = fitted
    attrs = dict(vars(j))
    with pytest.raises(ValueError, match="alpha_"):
        qlssvc_from_numpy({"X_": attrs["X_"]}, device="cpu")
    bad = dict(attrs, alpha_=attrs["alpha_"][:-1])
    with pytest.raises(ValueError, match="do not match"):
        qlssvc_from_numpy(bad, device="cpu")


@pytest.mark.parametrize("error_type", ["absolute", "relative"])
def test_noisy_p_stays_within_its_bound(fitted, error_type):
    """P̃ = P + z with |z| ≤ ε on every row; the float32 sum adds at most
    one ulp."""
    t, _, Xte, _ = fitted
    t.error_type = error_type
    X = t._input(Xte)
    h, beta = t._h(X), t._betas(X)
    P = 0.5 * (1.0 - h / beta)
    try:
        for seed in range(5):
            t.random_state = seed
            noisy, eps = t._noisy_P(P, h, beta)
            ulp = torch.finfo(torch.float32).eps * torch.maximum(
                noisy.abs(), P.abs())
            assert bool((torch.abs(noisy - P) <= eps + ulp).all())
            assert bool((noisy != P).any())
    finally:
        t.error_type, t.random_state = "absolute", 0


def test_relative_error_routine_depth_matches_jax_in_distribution():
    """The halving depth r of each element (recovered from δ_r) against
    the JAX routine's, over many draws: two-sample KS at α = 1e-3."""
    n = 3000
    x_max = np.full(n, 10.0, np.float32)
    x_real = np.full(n, 0.7, np.float32)
    x_hat, delta_r, eps = tsvc.relative_error_routine(
        as_generator(0, "cpu"), _t(x_max), _t(x_real), 0.5)
    jx, jd, je = jsvc.relative_error_routine(jax.random.PRNGKey(0), x_max,
                                             x_real, 0.5)

    def depth(d):
        return np.round(np.sqrt(6 * 0.1 / (math.pi**2 * np.asarray(d))))

    rt, rj = depth(delta_r.numpy()), depth(jd)
    assert stats.ks_2samp(rt, rj).pvalue >= KS_ALPHA
    assert (x_hat.numpy() >= 10.0 / 2**rt - 1e-6).all()
    np.testing.assert_allclose(eps.numpy(), 0.5 * 10.0 / 2**rt / 2,
                               rtol=1e-6)


def test_relative_error_routine_reads_its_flag_every_few_steps(monkeypatch):
    """The host reads "any active" once every READ_EVERY iterations, and
    the iterations run past the last element's stop change nothing."""
    reads = []
    real_any = torch.Tensor.any

    def counting_any(self, *a, **kw):
        reads.append(1)
        return real_any(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "any", counting_any)
    x_max = _t(np.full(200, 64.0, np.float32))
    x_real = _t(np.full(200, 1.0, np.float32))
    _, delta_r, _ = tsvc.relative_error_routine(
        as_generator(0, "cpu"), x_max, x_real, 0.1)
    depth = np.round(np.sqrt(6 * 0.1 / (math.pi**2 * delta_r.numpy())))
    # reads at steps 0, READ_EVERY, ... up to the first at or past the
    # deepest element's last iteration
    assert len(reads) == -(-int(depth.max()) // tsvc.READ_EVERY) + 1
    assert (depth == depth.max()).any()


def test_predict_and_hyperplane(fitted):
    t, j, Xte, yte = fitted
    for error_type in ("absolute", "relative"):
        t.error_type = error_type
        pred = t.predict(Xte)
        assert set(np.unique(pred)) <= {-1.0, 1.0}
        assert np.mean(pred == t.classical_predict(Xte)) >= 0.9
        b, coef = t.get_approximated_hyperplane(Xte[:1])
        assert np.isfinite(b) and coef.shape == (8,)
        assert t.get_h(Xte, approx=True).shape == (len(Xte),)
        assert t.get_P(Xte, approx=True).shape == (len(Xte),)
    t.error_type = "absolute"
    assert t.score(Xte, yte) == pytest.approx(np.mean(t.predict(Xte) == yte))


def test_facade_and_exports():
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch import svm
    from sq_learn_tpu_torch.models import QLSSVC as M

    assert svm.QLSSVC is sqt.QLSSVC is M is QLSSVC
    assert svm.lssvc_solve is tsvc.lssvc_solve
    assert "device" in QLSSVC().get_params()
    with pytest.raises(ValueError, match="absolute' or 'relative"):
        QLSSVC(error_type="other")


# -- the slice as a whole, small ---------------------------------------------


def test_path_d_at_a_small_size_against_jax():
    """Path D on the smoke's split of a small surrogate: both kernels and
    error types fit and predict, classical accuracy at least the JAX
    package's less 0.01. cond_ of the rbf F at rtol 1e-4; the linear F
    (rank 16 plus γ⁻¹·I, κ ≈ 3·10⁷) is beyond any float32 solver's
    relative precision, so its cond_ is held against a float64
    decomposition of the same F within 3× the JAX package's error."""
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    X, y = synthetic_surrogate(3000, 16, 10, seed=784)
    Xtr, ytr, Xte, yte = surrogate_split(X, y, n_train=400, n_test=150)
    for kernel, error_type in (("linear", "absolute"), ("rbf", "relative")):
        kw = dict(kernel=kernel, error_type=error_type, random_state=0)
        t = QLSSVC(**kw).fit(Xtr, ytr)
        j = JaxQLSSVC(**kw).fit(Xtr, ytr)
        acc = np.mean(t.classical_predict(Xte) == yte)
        assert acc >= np.mean(j.classical_predict(Xte) == yte) - 0.01
        assert t.predict(Xte).shape == (150,)
        if kernel == "rbf":
            assert t.cond_ == pytest.approx(j.cond_, rel=1e-4)
            continue
        F = tsvc.saddle_matrix(t.get_kernel(t.X_), t.penalty).double()
        s64 = torch.linalg.eigvalsh(F).abs().sort(descending=True).values
        cond64 = float(s64[0] / s64[-1])
        assert abs(t.cond_ - cond64) <= 3 * abs(j.cond_ - cond64)


if __name__ == "__main__":
    for kernel in ("linear", "rbf"):
        print(jax_f_errors(kernel), flush=True)
