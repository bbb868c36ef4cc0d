"""The accuracy-vs-quantum-runtime study through both packages, and obs
left inert, on the CPU.

- Both legs of ``chip_smoke.py``'s trade-off phase at a few thousand
  rows: the port through ``chip_smoke.tradeoff_legs`` itself, the JAX
  package through the same steps on its accelerator route. The routes
  are those of the full-size run: leg 1's fits take the sketch (here
  from 256 rows; the port is fed the JAX package's row sample, so both
  price the same statistics), the twin fit the exact μ. They record the
  same guarantee sites and ledger steps — ``chip_smoke.TRADEOFF_SITES``
  and ``TRADEOFF_STEPS``, which the card's run is held to — and the same
  ``q_runtime`` per point to rtol 1e-6, and the audit flags nothing.
  Leg 2 keeps 8 components, so the twin's median σ falls in a spectral
  gap and both packages select the same top-k.
- Obs is inert: with obs on, a fit's outputs (and a later ``predict``),
  and the number of Lloyd steps it runs, are bit-equal to the same fit
  with obs off; with obs off no record is written and no audit path
  touches a tensor.

Run as a script from the repository root (``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_obs_tradeoff.py``, a few minutes, ~4 GB) it
measures leg 2's holdout 7-NN accuracy, and its transform's realized
error over its bound, with the JAX package at the smoke's sizes over QPCA
random_state 0–9 and prints the floors ``chip_smoke.TRADEOFF_ACC_FLOOR``
and the bands ``chip_smoke.TRADEOFF_FNORM_BAND`` hold the card to.
"""

import importlib.util
import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from sq_learn_tpu import obs as jax_obs
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.sketch import engine as jax_sketch
from sq_learn_tpu.utils import as_key
from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.datasets import (load_cicids,
                                         load_mnist_surrogate_low_margin)
from sq_learn_tpu_torch.models import QLSSVC, QPCA, QKMeans
from sq_learn_tpu_torch.models import MiniBatchQKMeans
from sq_learn_tpu_torch.models import qkmeans as tqk
from sq_learn_tpu_torch.preprocessing import StandardScaler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_obs_helpers import (assert_draws_within_contract,  # noqa: E402
                                jax_accelerator_route, record)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()

#: the small run: leg 1 on 1 100 CICIDS rows with a 256-row sketch, leg 2
#: on 1 500 low-margin MNIST rows, a 500-row twin and 8 components
SMALL_SWEEP, SMALL_SKETCH = 1100, 256
SMALL_MNIST, SMALL_TRAIN, SMALL_TWIN, SMALL_COMPONENTS = 1500, 1200, 500, 8


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def jax_sample_indices(n, rows, random_state=0):
    """The sketch's row sample of the JAX package's fused fit
    (``sq_learn_tpu/models/qkmeans.py``, ``_fit_fused``)."""
    rng = np.random.default_rng(np.asarray(jax.random.key_data(
        jax.random.fold_in(as_key(random_state), 0x5CE7)),
        np.uint32).tolist())
    return jax_sketch.sample_indices(rng, n, rows)


def jax_tradeoff_legs(Xs, ys, Xm, ym, *, n_train, twin_rows, n_components,
                      errs=smoke.TRADEOFF_ERRS, deltas=smoke.SWEEP_DELTAS,
                      sketch="auto", random_state=0, ipe=True):
    """``chip_smoke.tradeoff_legs`` with the JAX package's estimators
    (numpy in and out, the same steps in the same order; ``random_state``
    seeds the main QPCA's tomography noise, ``ipe`` False skips the IPE
    fit). Returns per δ the q_runtime, and per ε+δ the accuracy,
    q_runtime, top-k, and the transform's f_norm beside its bound."""
    out = {"sweep": {}, "qpca": {}}

    def qkmeans(delta, ipe):
        return JaxQKMeans(
            n_clusters=smoke.SWEEP_K, n_init=10, delta=delta,
            true_distance_estimate=ipe, random_state=0, sketch=sketch,
            use_pallas=False).fit(Xs)

    for delta in deltas:
        est = qkmeans(delta, False)
        acc = smoke.ari(ys, est.labels_)
        q_rt = c_rt = kappa = None
        if delta > 0:
            quantum, classical = est.quantum_runtime_model(*Xs.shape)
            q_rt, c_rt = float(np.ravel(quantum)[0]), float(classical)
            kappa = est.condition_number_
        out["sweep"][delta] = {"ari": acc, "q_runtime": q_rt,
                               "kappa": kappa}
        jax_obs.frontier.record_tradeoff(
            "cicids_qkmeans_delta", delta, accuracy=acc,
            accuracy_metric="ari", q_runtime=q_rt, c_runtime=c_rt,
            budget={"delta": delta})
    if ipe:
        qkmeans(smoke.TRADEOFF_IPE_DELTA, True)

    n, m = Xm.shape
    pca = JaxQPCA(n_components, svd_solver="full",
                  random_state=random_state).fit(Xm)
    twin = Xm[:twin_rows]
    theta = float(np.median(JaxQPCA(n_components, svd_solver="full",
                                    random_state=0).fit(
        twin).singular_values_))
    for err in errs:
        Xq, bound, f_norm = pca.transform(
            Xm, classic_transform=False, epsilon_delta=err,
            quantum_representation=True, norm="est_representation",
            true_tomography=False)["quantum_representation_results"]
        knn = JaxKNN(n_neighbors=smoke.TRADEOFF_KNN).fit(
            Xq[:n_train], ym[:n_train])
        acc = float(np.mean(knn.predict(Xq[n_train:]) == ym[n_train:]))
        q = JaxQPCA(n_components, svd_solver="full", random_state=0).fit(
            twin, estimate_all=True, theta_major=theta, eps=err / 2,
            delta=err / 2, true_tomography=False)
        q_rt = float(np.sum([np.asarray(c, float)
                             for c in q.accumulate_q_runtime(n, m)]))
        out["qpca"][err] = {"accuracy": acc, "q_runtime": q_rt,
                            "topk": q.topk, "muA": q.muA,
                            "f_norm": float(f_norm), "bound": float(bound)}
        jax_obs.frontier.record_tradeoff(
            "mnist_qpca_eps_delta", err, accuracy=acc,
            accuracy_metric="holdout_7nn_acc", q_runtime=q_rt,
            c_runtime=float(n) * float(m) ** 2,
            budget={"eps": err / 2, "delta": err / 2},
            f_norm_err=float(f_norm))
    return out


@pytest.fixture(scope="module")
def small_data():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the surrogate's notice
        Xc, yc, _ = load_cicids(n_samples=SMALL_SWEEP)
    Xs = StandardScaler(device="cpu").fit_transform(Xc).numpy()
    Xm, ym = load_mnist_surrogate_low_margin(SMALL_MNIST)
    return Xs, yc, Xm, ym


@pytest.fixture(scope="module")
def small_runs(small_data):
    """Both packages' small runs, each under its own obs run."""
    Xs, ys, Xm, ym = small_data
    kw = dict(n_train=SMALL_TRAIN, twin_rows=SMALL_TWIN,
              n_components=SMALL_COMPONENTS, sketch=SMALL_SKETCH)
    mp = pytest.MonkeyPatch()
    try:
        with config_context(device="cpu"), jax_accelerator_route(mp):
            jax_out, jax_rec = record(
                jax_obs, lambda: jax_tradeoff_legs(Xs, ys, Xm, ym, **kw))
        # the port takes the JAX package's row sample: the same draw fed to
        # both sides, so both price the same sketched statistics
        mp.setattr(tqk, "sample_indices",
                   lambda rng, n, rows: jax_sample_indices(n, rows))
        with config_context(device="cpu"):
            port_out, port_rec = record(obs, lambda: smoke.tradeoff_legs(
                torch.from_numpy(Xs), ys, torch.from_numpy(Xm), ym, **kw))
    finally:
        mp.undo()
    return jax_out, jax_rec, port_out, port_rec


def test_small_legs_record_the_smokes_sites_and_steps(small_runs):
    _, jax_rec, _, port_rec = small_runs
    jax_sites, jax_steps = smoke.recorded_sites_and_steps(jax_rec)
    port_sites, port_steps = smoke.recorded_sites_and_steps(port_rec)
    assert port_sites == jax_sites == smoke.TRADEOFF_SITES
    assert port_steps == jax_steps == smoke.TRADEOFF_STEPS


def test_small_legs_price_every_point_alike(small_runs):
    """q_runtime per point to rtol 1e-6, once the one statistic the two
    packages compute in another precision is divided out: q-means' model
    is linear in κ, which the port takes from a float64 decomposition of
    the float32 sketch Gram and the JAX package from a float32 one (its
    λ_min sits ~7 decades under λ_max here: 12 % apart); the QADRA
    accountant is linear in μ(A), whose float32 power sums the two sum in
    another order (3e-6 apart)."""
    jax_out, jax_rec, port_out, port_rec = small_runs
    for delta, point in jax_out["sweep"].items():
        port = port_out["sweep"][delta]
        if point["q_runtime"] is None:
            assert port["q_runtime"] is None
            continue
        np.testing.assert_allclose(port["q_runtime"] / port["kappa"],
                                   point["q_runtime"] / point["kappa"],
                                   rtol=1e-6)
        np.testing.assert_allclose(port["kappa"], point["kappa"], rtol=0.25)
    for err, point in jax_out["qpca"].items():
        port = port_out["qpca"][err]
        assert port["topk"] == point["topk"]
        np.testing.assert_allclose(port["q_runtime"] / port["muA"],
                                   point["q_runtime"] / point["muA"],
                                   rtol=1e-6)
        np.testing.assert_allclose(port["muA"], point["muA"], rtol=1e-5)
    # the tradeoff records carry those numbers, one per point
    for rec in (jax_rec, port_rec):
        sweeps = obs.frontier.collect(rec.tradeoff_records)
        assert sorted(sweeps) == ["cicids_qkmeans_delta",
                                  "mnist_qpca_eps_delta"]
        assert [p["point"] for p in sweeps["cicids_qkmeans_delta"]] == list(
            smoke.SWEEP_DELTAS)
        assert [p["point"] for p in sweeps["mnist_qpca_eps_delta"]] == list(
            smoke.TRADEOFF_ERRS)


def test_small_legs_transform_noise_alike(small_runs):
    """Leg 2's quantum transform: the bound √k·(ε+δ) is the same, and the
    realized ‖Xq − X·Vᵀ‖_F lies under it at the same share in both
    packages. The noise is truncnorm(±bound/√d) per entry, near-uniform,
    so the share sits near 1/√3; atol 0.02 is ~6σ of the two packages'
    difference at 1 500 × 8 entries."""
    jax_out, _, port_out, _ = small_runs
    for err, point in jax_out["qpca"].items():
        port = port_out["qpca"][err]
        np.testing.assert_allclose(port["bound"], point["bound"], rtol=1e-12)
        assert 0 < port["f_norm"] <= port["bound"]
        np.testing.assert_allclose(port["f_norm"] / port["bound"],
                                   point["f_norm"] / point["bound"],
                                   atol=0.02)
        np.testing.assert_allclose(point["f_norm"] / point["bound"],
                                   3 ** -0.5, atol=0.02)


def test_small_legs_audit_clean(small_runs):
    _, jax_rec, _, port_rec = small_runs
    assert_draws_within_contract(port_rec)
    assert_draws_within_contract(jax_rec)


def test_small_legs_frontier_renders_alike_in_both_packages(small_runs):
    _, jax_rec, _, port_rec = small_runs
    port_sweeps = obs.frontier.collect(port_rec.tradeoff_records)
    assert obs.frontier.render(port_sweeps) == jax_obs.frontier.render(
        port_sweeps)
    for sweep in port_sweeps.values():
        pts = sorted(sweep, key=lambda p: p["point"])
        assert obs.frontier.pareto(pts) == jax_obs.frontier.pareto(pts)


# -- obs is inert ----------------------------------------------------------


def _blobs(n=900, m=12, k=4, seed=3):
    rng = np.random.default_rng(seed)
    C = rng.normal(scale=4.0, size=(k, m))
    y = rng.integers(0, k, n)
    return (C[y] + rng.normal(size=(n, m))).astype(np.float32), y


def _counting_lloyd(monkeypatch):
    calls = []
    real = tqk.lloyd_step

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tqk, "lloyd_step", counting)
    return calls


@pytest.mark.parametrize("kw", [
    {"delta": 0.0},
    {"delta": 0.5, "true_distance_estimate": False},
    {"delta": 0.5, "true_distance_estimate": True},
    {"delta": 0.5, "true_distance_estimate": False,
     "intermediate_error": True},
    {"delta": 0.5, "true_distance_estimate": False, "sketch": 128},
], ids=["classic", "delta", "ipe", "tomography", "sketch"])
def test_qkmeans_fit_is_bit_equal_with_obs_on(kw, monkeypatch, tmp_path):
    X, _ = _blobs()
    calls = _counting_lloyd(monkeypatch)

    def run():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            est = QKMeans(n_clusters=4, n_init=3, random_state=0, **kw).fit(X)
        return (est.labels_, est.cluster_centers_, est.n_iter_,
                est.inertia_, est.predict(X[:200], delta=kw["delta"]),
                getattr(est, "condition_number_", None))

    off = run()
    steps_off = len(calls)
    on, rec = record(obs, run, str(tmp_path / "on.jsonl"))
    assert len(calls) - steps_off == steps_off
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert rec.guarantee_records and rec.ledger_entries and rec.spans


def test_qpca_and_qlssvc_are_bit_equal_with_obs_on():
    rng = np.random.default_rng(42)
    X = (rng.normal(size=(300, 8)) @ rng.normal(size=(8, 16))
         + 0.05 * rng.normal(size=(300, 16))).astype(np.float32)
    y = np.where(X[:, 0] > np.median(X[:, 0]), 1.0, -1.0)

    def run():
        pca = QPCA(6, svd_solver="full", random_state=0).fit(
            X, estimate_all=True, eps=0.3, delta=0.3, theta_major=1.0,
            spectral_norm_est=True, condition_number_est=True)
        Xq = pca.transform(X, classic_transform=False, epsilon_delta=0.5,
                           quantum_representation=True,
                           norm="est_representation")
        svc = QLSSVC(kernel="rbf", error_type="relative",
                     random_state=0).fit(X[:200], y[:200])
        return (pca.estimate_right_sv, pca.est_spectral_norm,
                pca.est_cond_number,
                Xq["quantum_representation_results"][0].numpy(),
                svc.predict(X[200:]), svc.get_P(X[200:], approx=True))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        off = run()
    on, rec = record(obs, run)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert {g["site"] for g in rec.guarantee_records} >= {
        "qpca.sv_estimate", "tomography.true", "qlssvc.noisy_p"}


def test_minibatch_is_bit_equal_with_obs_on():
    X, _ = _blobs()

    def run():
        est = MiniBatchQKMeans(n_clusters=4, delta=0.5, batch_size=128,
                               true_distance_estimate=True,
                               random_state=0).fit(X)
        est.partial_fit(X[:100])
        return est.cluster_centers_, est.counts_, est.n_steps_, est.labels_

    off = run()
    on, rec = record(obs, run)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    # the steps run in the JAX package's jit: no draw is audited
    assert rec.guarantee_records == []
    # each entry point validates its input first (a read of the device)
    assert [s["name"] for s in rec.spans] == [
        "sync.validation", "minibatch.fit", "sync.validation",
        "minibatch.partial_fit"]


def test_nothing_is_recorded_with_obs_off(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not obs.enabled() and obs.get_recorder() is None
    X, _ = _blobs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        QKMeans(n_clusters=4, n_init=2, delta=0.5, random_state=0).fit(
            X).predict(X)
    assert list(tmp_path.iterdir()) == []
    assert obs.snapshot() is None
    assert obs.ledger.entries() == []
    assert obs.guarantees.audit() == {}


class _Untouchable:
    """A stand-in tensor whose every use fails: an instrumentation path
    that runs while obs is off must return before it reads it."""

    def __getattr__(self, name):
        raise AssertionError(f"touched .{name} while obs is off")

    def __float__(self):
        raise AssertionError("converted to a number while obs is off")


def test_instrumentation_touches_no_tensor_with_obs_off():
    from sq_learn_tpu_torch.ops.quantum.estimation import _observe_estimate
    from sq_learn_tpu_torch.ops.quantum.tomography import _observe_guarantee

    t = _Untouchable()
    _observe_estimate("ipe", t, t, t, 0.1)
    _observe_guarantee(t, t, 0.1, "L2", True, "true")
    obs.guarantees.observe("site", t, t)
    with obs.span("x", value=t) as sp:
        sp.set(value=t)
        assert sp.sync(t) is t
    assert obs.NULL_SPAN.set(value=t) is obs.NULL_SPAN
    obs.ledger.record("e", "s", queries={"q": t})
    obs.frontier.record_tradeoff("s", 1.0, accuracy=t)


def test_no_audit_region_silences_the_routines_but_not_the_run():
    from sq_learn_tpu_torch.ops.quantum.tomography import tomography
    from sq_learn_tpu_torch.utils import as_generator

    A = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 8)).astype(np.float32))

    def run():
        gen = as_generator(0, "cpu")
        with obs.guarantees.no_audit():
            inner = tomography(gen, A, 0.3, true_tomography=False)
            assert not obs.guarantees.enabled()
        outer = tomography(gen, A, 0.3, true_tomography=False)
        return inner, outer

    _, rec = record(obs, run)
    assert [g["site"] for g in rec.guarantee_records] == [
        "tomography.gaussian"]


# -- the smoke's accuracy floors (script mode) ------------------------------


def measure_floors(seeds=range(10)):
    """Leg 2 at the smoke's sizes with the JAX package over QPCA
    random_state in ``seeds``: per ε+δ the accuracies and the floor
    min − 1.5·(max − min), and the ratios f_norm / bound and their band
    (min − 1.5·(max − min), max + 1.5·(max − min))."""
    Xm, ym = load_mnist_surrogate_low_margin(smoke.TRADEOFF_N)
    acc = {err: [] for err in smoke.TRADEOFF_ERRS}
    ratio = {err: [] for err in smoke.TRADEOFF_ERRS}
    for seed in seeds:
        out = jax_tradeoff_legs(
            None, None, Xm, ym, n_train=smoke.TRADEOFF_TRAIN,
            twin_rows=smoke.TRADEOFF_TWIN,
            n_components=smoke.TRADEOFF_COMPONENTS, deltas=(),
            random_state=seed, ipe=False)
        for err, point in out["qpca"].items():
            acc[err].append(point["accuracy"])
            ratio[err].append(point["f_norm"] / point["bound"])
        print(f"random_state {seed}:",
              {e: (p["accuracy"], p["f_norm"] / p["bound"])
               for e, p in out["qpca"].items()}, flush=True)
    floors = {err: min(a) - 1.5 * (max(a) - min(a)) for err, a in acc.items()}
    bands = {err: (min(r) - 1.5 * (max(r) - min(r)),
                   max(r) + 1.5 * (max(r) - min(r)))
             for err, r in ratio.items()}
    return acc, floors, ratio, bands


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    accuracies, floors, ratios, bands = measure_floors()
    print("accuracies:", accuracies)
    print("TRADEOFF_ACC_FLOOR =", floors)
    print("f_norm / bound:", ratios)
    print("TRADEOFF_FNORM_BAND =", bands)
