"""The port's qPCA and tomography drivers (``examples_torch/``) against
the JAX package's (``examples/``), on the CPU.

Each driver runs twice at the same small arguments: the JAX driver in a
subprocess (``JAX_PLATFORMS=cpu``, offline), the port's ``main([...,
"--device", "cpu"])`` in this process. The port prints the JAX driver's
lines (numbers masked), and its numbers are held to the JAX driver's:

- ``mnist_trial`` at ``--subsample 2000 --n-components 16``: the data's
  shape and the top-k equal; the 10-fold CV accuracy within
  ``acc_tol`` (4 standard deviations of the difference of two binomial
  shares over the 2 000 rows: the quantum transform is a noise draw);
  the F-norm deviation within 4·√2 standard deviations of the port's own
  over QPCA random_state 0–9 (jax threefry and torch Philox draws never
  match, so a draw is held in distribution).
- ``qpca_demo``: the classical singular values and spectral norm at rtol
  1e-4; the top-k, its retained variance (rtol 1e-4), θ (within 0.01)
  and the crossover share equal (the θ search lands on the JAX package's
  answer at the driver's random_state; one of the port's random_states
  0–7 selects one component fewer); every estimated singular value of
  consistent phase estimation within 2·ε·(π + 1) of the JAX package's
  (each within ε·(π + ε/μ) of σ by phase estimation's bound, ε/μ < 1);
  the estimated spectral norm within the same.
- ``tomography_histogram`` at ``--dim 64 --trials 32``, L2 and inf: N
  per trial equal; P(err ≤ δ) equal; the per-trial errors of the port
  against the JAX package's ``real_tomography`` on the port's own unit
  vector by a two-sample Kolmogorov–Smirnov test at α = 1e-3, and the
  drivers' mean L2 errors (of two different random vectors) within 25 %.
- ``qpca_error_tradeoff`` at ``--subsample 1000 --folds 3``: every leg's
  shape equal; the classical CV accuracy (exact search, no draw) within
  one row of the JAX package's; per ε+δ the CV accuracy within
  ``acc_tol`` and the F-norm error within 4·√2 standard deviations of
  five more port draws at that point (plus the printed rounding).

Run as a script from the repository root (``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_examples_qpca.py``, ~3 min,
~3 GB) it runs the JAX drivers at ``chip_smoke.py``'s arguments (the
defaults; ``qpca_error_tradeoff`` at ``--subsample 4000 --folds 3``) and
prints the numbers the smoke's ``examples`` phase holds the card to.
"""

import contextlib
import io
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_examples_helpers import (acc_tol, line_after,  # noqa: E402
                                     load_driver, masked, numbers,
                                     run_jax_driver)

MNIST_ARGS = ("--subsample", "2000", "--n-components", "16")
TOMO_ARGS = ("--dim", "64", "--trials", "32")
QERR_ARGS = ("--subsample", "1000", "--folds", "3")
LEGS = ("mnist", "low_margin", "cicids")
KS_ALPHA = 1e-3


def port_run(name, args):
    """(printed text, returned dict) of the port's driver on the CPU."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = load_driver(name).main([*args, "--device", "cpu"])
    return buf.getvalue(), result


@pytest.fixture(scope="module")
def mnist_runs():
    return run_jax_driver("mnist_trial.py", *MNIST_ARGS), *port_run(
        "mnist_trial", MNIST_ARGS)


@pytest.fixture(scope="module")
def demo_runs():
    return run_jax_driver("qpca_demo.py"), *port_run("qpca_demo", ())


@pytest.fixture(scope="module", params=["L2", "inf"])
def tomo_runs(request):
    args = (*TOMO_ARGS, "--norm", request.param)
    return (request.param, run_jax_driver("tomography_histogram.py", *args),
            *port_run("tomography_histogram", args))


@pytest.fixture(scope="module")
def qerr_runs():
    return run_jax_driver("qpca_error_tradeoff.py", *QERR_ARGS), *port_run(
        "qpca_error_tradeoff", QERR_ARGS)


# -- mnist_trial ---------------------------------------------------------------


def test_mnist_trial_prints_the_jax_drivers_lines(mnist_runs):
    jax_out, port_out, _ = mnist_runs
    assert masked(port_out) == masked(jax_out)


def test_mnist_trial_numbers_agree(mnist_runs):
    from sq_learn_tpu_torch.datasets import load_mnist
    from sq_learn_tpu_torch.models import QPCA

    jax_out, _, port = mnist_runs
    assert port["shape"] == (2000, 784) and not port["real"]
    assert line_after(jax_out, "data:").startswith("data: (2000, 784)")
    assert port["topk"] == int(numbers(line_after(jax_out, "qPCA fit"))[-1])
    cv_mean, cv_std = numbers(line_after(jax_out, "10-fold"))[1:]
    assert abs(port["cv_mean"] - cv_mean) <= acc_tol(cv_mean, 2000)
    assert len(port["scores"]) == 10 and min(port["scores"]) >= 0.95
    # the F-norm deviation follows the tomography's draw: the port's
    # spread over random_state 0–9 at the driver's settings
    X, _, _ = load_mnist()
    X = X[:2000]
    fn = []
    for seed in range(10):
        pca = QPCA(n_components=16, svd_solver="full", random_state=seed,
                   device="cpu").fit(X, estimate_all=True, eps=0.4,
                                     delta=0.4, theta_major=1e-9,
                                     true_tomography=False)
        Xq = pca.transform(X, classic_transform=False,
                           use_classical_components=False)
        fn.append(float(torch.linalg.norm(Xq - pca.transform(X))))
    assert fn[0] == pytest.approx(port["f_norm"], rel=1e-6)
    jax_fn = numbers(line_after(jax_out, "quantum transform"))[-1]
    sd = float(np.std(fn, ddof=1))
    assert abs(jax_fn - np.mean(fn)) <= 4 * math.sqrt(2) * sd, (jax_fn, fn)


# -- qpca_demo -----------------------------------------------------------------


def test_qpca_demo_prints_the_jax_drivers_lines(demo_runs):
    jax_out, port_out, _ = demo_runs
    assert masked(port_out) == masked(jax_out)


def test_qpca_demo_numbers_agree(demo_runs):
    jax_out, _, port = demo_runs
    sv = numbers(line_after(jax_out, "classical singular values"))
    np.testing.assert_allclose(port["singular_values"], sv, rtol=1e-4,
                               atol=0.005)
    true_norm, est_norm = numbers(line_after(jax_out, "spectral norm"))
    assert port["spectral_norm"] == pytest.approx(true_norm, abs=0.005)
    eps = 0.1
    bound = 2 * eps * (math.pi + 1)
    assert abs(port["est_spectral_norm"] - est_norm) <= bound
    est_sv = numbers(line_after(jax_out, "estimated singular values"))
    assert len(port["estimated_singular_values"]) == len(est_sv)
    np.testing.assert_allclose(port["estimated_singular_values"], est_sv,
                               atol=bound)
    theta = numbers(line_after(jax_out, "estimated theta"))[-1]
    assert port["est_theta"] == pytest.approx(theta, abs=0.01)
    topk, share = numbers(line_after(jax_out, "top-k selected"))
    assert port["topk"] == topk
    assert 100 * port["topk_p"] == pytest.approx(share, abs=0.05)
    crossover = numbers(line_after(jax_out, "quantum runtime model"))[0]
    assert 100 * port["crossover"] == pytest.approx(crossover, abs=0.05)


# -- tomography_histogram ------------------------------------------------------


def test_tomography_histogram_prints_the_jax_drivers_lines(tomo_runs):
    _, jax_out, port_out, _ = tomo_runs
    assert masked(port_out) == masked(jax_out)


def test_tomography_histogram_errors_agree(tomo_runs):
    import jax
    import jax.numpy as jnp
    from scipy.stats import ks_2samp

    from sq_learn_tpu.ops.quantum import real_tomography as jax_tomography

    norm, jax_out, _, port = tomo_runs
    assert port["N"] == int(numbers(line_after(jax_out, "dim="))[-1])
    mean_err, max_err, within = numbers(line_after(jax_out, "32 trials"))[
        -3:]
    assert 100 * port["within"] == pytest.approx(within, abs=0.005)
    if norm == "L2":
        # about √(d/4N) a trial whatever the vector; the inf-norm error
        # is set by the vector's smallest entries, so the drivers' two
        # random vectors are compared only through the test below
        assert abs(port["mean_err"] - mean_err) <= 0.25 * mean_err
    # the JAX package's draws on the port's own unit vector
    g = torch.Generator()
    g.manual_seed(0)
    v = torch.randn(64, generator=g)
    v = (v / torch.linalg.norm(v)).numpy()
    keys = jax.random.split(jax.random.PRNGKey(1), 32)
    est = jax.vmap(lambda k: jax_tomography(k, jnp.asarray(v), delta=0.1,
                                            norm=norm))(keys)
    diff = np.asarray(est) - v[None, :]
    jax_errors = (np.linalg.norm(diff, axis=1) if norm == "L2"
                  else np.abs(diff).max(axis=1))
    assert ks_2samp(port["errors"], jax_errors).pvalue > KS_ALPHA


# -- qpca_error_tradeoff -------------------------------------------------------


def _tables(text):
    """Per leg: (classical accuracy, {ε+δ: (accuracy, F-norm error)})."""
    legs, current = [], None
    for line in text.splitlines():
        if "classical transform" in line:
            current = (numbers(line.split("accuracy")[1])[0], {})
            legs.append(current)
        elif current is not None and line.count("|") == 3 and "KNN" not in \
                line:
            err, acc, f_norm, _ = numbers(line)
            current[1][err] = (acc, f_norm)
    return dict(zip(LEGS, legs))


def test_qpca_error_tradeoff_prints_the_jax_drivers_lines(qerr_runs):
    jax_out, port_out, _ = qerr_runs
    assert masked(port_out) == masked(jax_out)


def test_qpca_error_tradeoff_numbers_agree(qerr_runs):
    from sq_learn_tpu_torch.datasets import (load_cicids, load_mnist,
                                             load_mnist_surrogate_low_margin)
    from sq_learn_tpu_torch.models import QPCA
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    jax_out, _, port = qerr_runs
    for prefix, shape in (("MNIST leg", (1000, 784)),
                          ("MNIST low-margin leg", (1000, 784)),
                          ("CICIDS leg", (4000, 78))):
        assert tuple(int(v) for v in numbers(
            line_after(jax_out, prefix))[:2]) == shape
    jax_legs = _tables(jax_out)
    X, _, _ = load_mnist()
    Xlm, _ = load_mnist_surrogate_low_margin(1000)
    Xc, _, _ = load_cicids(n_samples=4000)
    data = {"mnist": (X[:1000], 61),
            "low_margin": (Xlm, 61),
            "cicids": (StandardScaler(device="cpu").fit_transform(Xc), 10)}
    for leg in LEGS:
        Z, width = data[leg]
        n = Z.shape[0]
        jax_c, jax_points = jax_legs[leg]
        assert abs(port[leg]["classical_acc"] - jax_c) <= 1.0 / n + 5e-5
        pca = QPCA(n_components=width, svd_solver="full", random_state=0,
                   device="cpu").fit(Z)
        for err, (acc, f_norm) in jax_points.items():
            point = port[leg]["points"][err]
            assert abs(point["acc"] - acc) <= acc_tol(acc, n), (leg, err)
            draws = [float(pca.transform(
                Z, classic_transform=False, epsilon_delta=err,
                quantum_representation=True, norm="est_representation",
                true_tomography=True)["quantum_representation_results"][2])
                for _ in range(5)] + [point["f_norm"]]
            sd = float(np.std(draws, ddof=1))
            assert abs(point["f_norm"] - f_norm) <= (
                4 * math.sqrt(2) * sd + 0.005), (leg, err, draws, f_norm)


# -- the script mode: the JAX drivers' numbers behind chip_smoke's floors -----


def measure_floors():
    """Run the JAX drivers at the smoke's arguments and print their
    numbers."""
    out = run_jax_driver("mnist_trial.py")
    cv_mean, cv_std = numbers(line_after(out, "10-fold"))[1:]
    print(out)
    print(f"JAX mnist_trial at its defaults: CV accuracy {cv_mean} "
          f"± {cv_std} (10 000 rows)")
    out = run_jax_driver("qpca_error_tradeoff.py", "--subsample", "4000",
                         "--folds", "3")
    print(out)
    print("JAX qpca_error_tradeoff at --subsample 4000 --folds 3:",
          {leg: (c, {e: a for e, (a, _) in points.items()})
           for leg, (c, points) in _tables(out).items()})
    out = run_jax_driver("tomography_histogram.py")
    print(out)
    print("JAX tomography_histogram at its defaults: (N, mean, max, "
          "P(err <= delta) %):",
          numbers(line_after(out, "dim="))[-1],
          numbers(line_after(out, "64 trials"))[-3:])
    out = run_jax_driver("qpca_demo.py")
    print(out)


if __name__ == "__main__":
    measure_floors()
