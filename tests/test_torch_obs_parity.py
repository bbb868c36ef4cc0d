"""Instrumentation parity: every estimator entry point of the port records
what the JAX package's accelerator route records, on the CPU.

Each case runs the same numpy data through both packages, each under its
own obs run (the JAX package forced onto its accelerator route: q-means'
fused fit with ``use_pallas=True``, in interpret mode here, not its host
engines; the k-NN search through its Pallas kernel). They must record:

- the same guarantee sites, as many records per site, the same
  ``fail_prob`` and ``n_total`` on every record, short-circuit records
  equal, and ``tol`` equal — at rtol 1e-4 where the tolerance scales with
  a fitted float32 value (QLSSVC's ε/2β), and not compared where it is
  itself a draw (QLSSVC's relative-error scale);
- the same ledger (estimator, step) pairs, with ``queries`` and
  ``budget`` equal to rtol 1e-6 (a sketched q-means fit's cost per unit
  of κ: the port decomposes the sketch Gram in float64, the JAX package
  in float32);
- the same span names, less ``JAX_ONLY_SPANS`` (routes the port does not
  have, each with its reason) and plus ``PORT_ONLY_SPANS``.

Realized errors are draws from two generators, held in distribution:
every draw at a ``fail_prob`` 0 site is within its tolerance, and the
audit flags no site.
"""

import os
import sys

import numpy as np
import pytest

from sq_learn_tpu.models import QLSSVC as JaxQLSSVC
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.models import MiniBatchQKMeans as JaxMiniBatch
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.models import (QLSSVC, QPCA, KNeighborsClassifier,
                                       MiniBatchQKMeans, QKMeans,
                                       TruncatedSVD)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_obs_helpers import (JAX_ONLY_SPANS,  # noqa: E402
                                PORT_ONLY_SPANS,
                                assert_draws_within_contract,
                                assert_same_sites, assert_same_spans,
                                assert_same_steps, record_both, span_names)



@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(3)
    C = rng.normal(scale=4.0, size=(5, 12))
    y = rng.integers(0, 5, 600)
    return (C[y] + rng.normal(size=(600, 12))).astype(np.float32), y


@pytest.fixture(scope="module")
def lowrank():
    rng = np.random.default_rng(42)
    B = rng.normal(size=(400, 10)) @ rng.normal(size=(10, 16))
    X = (B + 0.05 * rng.normal(size=(400, 16))).astype(np.float32)
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    return X, y


def _parity(jax_fn, port_fn, monkeypatch, tol_rtol=None, drawn_tol=(),
            same_steps=True):
    jrec, prec = record_both(jax_fn, port_fn, monkeypatch)
    assert_same_sites(jrec, prec, tol_rtol=tol_rtol, drawn_tol=drawn_tol)
    if same_steps:
        assert_same_steps(jrec, prec)
    assert_same_spans(jrec, prec)
    assert_draws_within_contract(prec)
    assert_draws_within_contract(jrec)
    return jrec, prec


@pytest.mark.parametrize("kw", [
    {"delta": 0.5, "true_distance_estimate": False},
    {"delta": 0.5, "true_distance_estimate": True},
    {"delta": 0.0},
], ids=["delta_means", "ipe", "classic"])
def test_qkmeans_fit_and_predict(blobs, kw, monkeypatch):
    X, _ = blobs
    if kw.get("true_distance_estimate"):
        # IPE's tolerance ε·max(1, |⟨x, c⟩|) follows the fitted centers,
        # which the two packages number in different orders: rows scaled
        # so that every |⟨x, c⟩| < 1 make it ε on every draw
        X = X * 0.02
    args = dict(n_clusters=5, n_init=3, random_state=0, **kw)
    jrec, prec = _parity(
        lambda: JaxQKMeans(use_pallas=True, **args).fit(X).predict(
            X[:50], delta=kw["delta"]),
        lambda: QKMeans(**args).fit(X).predict(X[:50], delta=kw["delta"]),
        monkeypatch)
    assert {"qkmeans.fit", "qkmeans.fused_init", "qkmeans.fused_fit",
            "qkmeans.predict"} <= span_names(prec)
    assert ("qkmeans.quantum_stats" in span_names(prec)) == (
        kw["delta"] > 0)
    expected = {0.0: {"qkmeans.delta_window"}}.get(
        kw["delta"], {"sketch.stats", "ipe" if kw.get(
            "true_distance_estimate") else "qkmeans.delta_window"})
    assert {g["site"] for g in prec.guarantee_records} == expected


def test_qkmeans_sketched_fit(monkeypatch):
    """With the sketch engaged, its own audit (``sketch.mu``, and
    ``sketch.sigma_min`` where the σ bound is not vacuous) replaces the
    exact statistics' short-circuit."""
    rng = np.random.default_rng(8)
    X = (rng.normal(size=(2400, 6)) * np.arange(1, 7)).astype(np.float32)
    args = dict(n_clusters=3, n_init=2, delta=0.5, sketch=512,
                true_distance_estimate=False, random_state=0)
    fitted = {}

    def run(name, cls, **extra):
        def go():
            fitted[name] = cls(**args, **extra).fit(X)
        return go

    jrec, prec = _parity(run("jax", JaxQKMeans, use_pallas=True),
                         run("port", QKMeans), monkeypatch,
                         same_steps=False)
    sites = {g["site"] for g in prec.guarantee_records}
    assert "sketch.mu" in sites and "sketch.stats" not in sites
    assert prec.counters["sketch.estimates"] == 1
    # the model is linear in κ, which the port takes from a float64
    # decomposition of the float32 sketch Gram and the JAX package from a
    # float32 one: the cost per unit of κ agrees
    (jentry,), (pentry,) = jrec.ledger_entries, prec.ledger_entries
    np.testing.assert_allclose(
        pentry["queries"]["theoretical_quantum_cost"]
        / fitted["port"].condition_number_,
        jentry["queries"]["theoretical_quantum_cost"]
        / fitted["jax"].condition_number_, rtol=1e-6)
    assert pentry["queries"]["classical_cost"] == jentry["queries"][
        "classical_cost"]
    assert pentry["budget"] == jentry["budget"]


@pytest.mark.parametrize("true_tomography", [True, False])
def test_qpca_fit_with_every_estimator_and_the_quantum_transform(
        lowrank, true_tomography, monkeypatch):
    X, _ = lowrank
    fit_kw = dict(estimate_all=True, eps=0.4, delta=0.4, theta_major=1.0,
                  spectral_norm_est=True, condition_number_est=True,
                  quantum_retained_variance=True,
                  true_tomography=true_tomography)
    tr_kw = dict(classic_transform=False, epsilon_delta=0.8,
                 quantum_representation=True, norm="est_representation",
                 true_tomography=true_tomography)

    def run(cls):
        return lambda: cls(8, svd_solver="full", random_state=0).fit(
            X, **fit_kw).transform(X, **tr_kw)

    jrec, prec = _parity(run(JaxQPCA), run(QPCA), monkeypatch)
    variant = "true" if true_tomography else "gaussian"
    assert {g["site"] for g in prec.guarantee_records} == {
        "sketch.stats", "phase_estimation", "consistent_phase_estimation",
        "qpca.sv_estimate", f"tomography.{variant}"}
    assert {e["step"] for e in prec.ledger_entries} == {
        "spectral_norm_estimation", "condition_number_estimation",
        "factor_score_ratio_sum", "topk_extract"}


def test_qpca_zero_budget_short_circuits(lowrank, monkeypatch):
    X, _ = lowrank
    fit_kw = dict(estimate_all=True, estimate_least_k=True, eps=0, delta=0,
                  theta_major=1.0, theta_minor=1.0, spectral_norm_est=True,
                  condition_number_est=True)
    jrec, prec = _parity(
        lambda: JaxQPCA(8, svd_solver="full", random_state=0).fit(X, **fit_kw),
        lambda: QPCA(8, svd_solver="full", random_state=0).fit(X, **fit_kw),
        monkeypatch)
    for g in prec.guarantee_records:
        if g["site"] != "tomography.true" or g.get("short_circuit"):
            assert g["realized"] == 0.0 and not g["violated"]
    shorted = [e for e in prec.ledger_entries
               if (e.get("attrs") or {}).get("short_circuit")]
    assert {e["step"] for e in shorted} == {"spectral_norm_estimation",
                                            "condition_number_estimation"}


@pytest.mark.parametrize("error_type", ["absolute", "relative"])
def test_qlssvc_fit_and_predict(lowrank, error_type, monkeypatch):
    X, y = lowrank
    ypm = np.where(y == 1, 1.0, -1.0)
    args = dict(kernel="rbf", error_type=error_type, random_state=0)

    def run(cls):
        def go():
            est = cls(**args).fit(X[:200], ypm[:200])
            est.get_P(X[200:], approx=True)
            return est.predict(X[200:])
        return go

    # the absolute bound ε/2β scales with the fitted Nu (float32 sums);
    # the relative one is the draw's own halving scale
    drawn = ("qlssvc.noisy_p",) if error_type == "relative" else ()
    jrec, prec = _parity(run(JaxQLSSVC), run(QLSSVC), monkeypatch,
                         tol_rtol={"qlssvc.noisy_p": 1e-4},
                         drawn_tol=drawn)
    assert len(prec.guarantee_records) == 128  # two calls of 64 draws
    assert span_names(prec) == {"qlssvc.fit", "qlssvc.predict"}


def test_knn_predict(lowrank, monkeypatch):
    X, y = lowrank
    jrec, prec = _parity(
        lambda: JaxKNN(n_neighbors=5, use_pallas=True).fit(
            X[:300], y[:300]).predict(X[300:]),
        lambda: KNeighborsClassifier(n_neighbors=5).fit(
            X[:300], y[:300]).predict(X[300:]), monkeypatch)
    (entry,) = prec.ledger_entries
    assert entry["attrs"]["engine"] == "argkmin_reference"
    (span,) = prec.spans
    assert span["attrs"]["engine"] == "argkmin_reference"
    assert span["attrs"]["n_queries"] == 100 and span["attrs"]["k"] == 5


@pytest.mark.parametrize("algorithm", ["randomized", "arpack"])
def test_truncated_svd(lowrank, algorithm, monkeypatch):
    X, _ = lowrank
    jrec, prec = _parity(
        lambda: JaxTruncatedSVD(5, algorithm=algorithm,
                                random_state=0).fit(X),
        lambda: TruncatedSVD(5, algorithm=algorithm, random_state=0).fit(X),
        monkeypatch)
    (entry,) = prec.ledger_entries
    assert entry["wall_s"] >= 0 and entry["attrs"]["algorithm"] == algorithm


@pytest.mark.parametrize("ipe", [False, True])
def test_minibatch_fit_and_partial_fit(lowrank, ipe, monkeypatch):
    X, _ = lowrank
    args = dict(n_clusters=4, delta=0.5, true_distance_estimate=ipe,
                batch_size=128, random_state=0)
    jrec, prec = _parity(
        lambda: JaxMiniBatch(**args).fit(X).partial_fit(X[:100]),
        lambda: MiniBatchQKMeans(**args).fit(X).partial_fit(X[:100]),
        monkeypatch)
    assert span_names(prec) == {"minibatch.fit", "minibatch.partial_fit"}
    assert prec.guarantee_records == []


@pytest.mark.parametrize("route", ["qkmeans_delta", "qkmeans_classic",
                                   "qpca", "knn", "truncated_svd"])
def test_mesh_routes(lowrank, blobs, route, mesh8, monkeypatch):
    """Every mesh route records the JAX package's mesh route: the same
    guarantee sites, ledger steps and span names (``qkmeans.init`` of the
    restart loop and the sharded spans among them), each sharded span
    with the JAX package's attributes (``n_devices`` …)."""
    from sq_learn_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cpu"] * 8)
    X, y = lowrank
    Xb, _ = blobs
    qkw = dict(n_clusters=5, n_init=2, random_state=0)
    qpca_fit = dict(estimate_all=True, eps=0.1, delta=0.1, theta_major=0.5)
    jax_fn, port_fn = {
        "qkmeans_delta": (
            lambda: JaxQKMeans(delta=0.5, true_distance_estimate=False,
                               mesh=mesh8, **qkw).fit(Xb),
            lambda: QKMeans(delta=0.5, true_distance_estimate=False,
                            mesh=mesh, **qkw).fit(Xb)),
        "qkmeans_classic": (
            lambda: JaxQKMeans(delta=0.0, mesh=mesh8, **qkw).fit(Xb),
            lambda: QKMeans(delta=0.0, mesh=mesh, **qkw).fit(Xb)),
        "qpca": (
            lambda: JaxQPCA(n_components=4, mesh=mesh8,
                            random_state=0).fit(X, **qpca_fit),
            lambda: QPCA(n_components=4, mesh=mesh,
                         random_state=0).fit(X, **qpca_fit)),
        "knn": (
            lambda: JaxKNN(n_neighbors=5, mesh=mesh8).fit(
                X[:300], y[:300]).predict(X[300:]),
            lambda: KNeighborsClassifier(n_neighbors=5, mesh=mesh).fit(
                X[:300], y[:300]).predict(X[300:])),
        "truncated_svd": (
            lambda: JaxTruncatedSVD(5, mesh=mesh8).fit(X),
            lambda: TruncatedSVD(5, mesh=mesh).fit(X)),
    }[route]
    jrec, prec = record_both(jax_fn, port_fn, monkeypatch)
    assert_same_sites(jrec, prec, tol_rtol={"qpca.sv_estimate": 1e-4},
                      drawn_tol=("tomography.true",))
    assert_same_steps(jrec, prec, rtol=1e-4)
    assert span_names(prec) == (span_names(jrec) - {"xla.capture"}) | (
        span_names(prec) & set(PORT_ONLY_SPANS))
    sharded = {s["name"] for s in prec.spans
               if s["name"].startswith("parallel.")}
    assert sharded
    for name in sharded:
        (pa,) = {tuple(sorted(s["attrs"].items())) for s in prec.spans
                 if s["name"] == name}
        ja = {tuple(sorted(s["attrs"].items())) for s in jrec.spans
              if s["name"] == name}
        assert pa in ja, (name, pa, ja)
    assert_draws_within_contract(prec)


def test_left_out_span_names_carry_their_reasons():
    assert set(JAX_ONLY_SPANS).isdisjoint(PORT_ONLY_SPANS)
    assert {"qkmeans.native_init", "qkmeans.native_lloyd",
            "qkmeans.prestats", "xla.capture"} <= set(JAX_ONLY_SPANS)
    for reason in (*JAX_ONLY_SPANS.values(), *PORT_ONLY_SPANS.values()):
        assert len(reason) > 20
