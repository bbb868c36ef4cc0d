"""Shared pieces of the ``tests/test_torch_obs*.py`` files: running a
callable under each package's obs recorder and summarizing what it
recorded."""

import contextlib
import warnings

import numpy as np

from sq_learn_tpu import obs as jax_obs
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.sketch import cache as jax_stats_cache
from sq_learn_tpu_torch import obs as port_obs

#: spans of JAX routes the port does not have, by its ground rules
#: (ROADMAP.md): the host engines, the tiny-fit host routing and the XLA
#: and watchdog captures write spans no port run can
JAX_ONLY_SPANS = {
    "qkmeans.native_init": "the native host engines are not ported",
    "qkmeans.native_lloyd": "the native host engines are not ported",
    "qkmeans.prestats": "the host engine's prestats (native route only)",
    "qkmeans.init": "the staged (non-fused) fit route is not ported",
    "xla.capture": "XLA's cost analysis has no torch counterpart",
}

#: spans the port writes where the JAX accelerator route writes none
PORT_ONLY_SPANS = {
    "qkmeans.quantum_stats": (
        "the JAX package times the runtime statistics' fetch only on its "
        "host route (qkmeans.py:1638, :1648); the port fetches them after "
        "the Lloyd loop on its one route and times that fetch and fold"),
}


@contextlib.contextmanager
def jax_accelerator_route(monkeypatch):
    """The JAX package's accelerator route on the CPU: q-means and
    mini-batch q-means take the fused device path (not the host engines),
    and no statistic comes from the digest cache of an earlier fit."""
    monkeypatch.setattr(JaxQKMeans, "_on_cpu_backend",
                        staticmethod(lambda: False))
    jax_stats_cache.clear()
    try:
        yield
    finally:
        jax_stats_cache.clear()


def record(obs_module, fn, path=None):
    """Run ``fn()`` under a fresh obs run of ``obs_module``; returns
    (fn's result, the closed recorder)."""
    obs_module.enable(path) if path else obs_module.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = fn()
    finally:
        rec = obs_module.disable()
    return out, rec


def record_both(jax_fn, port_fn, monkeypatch):
    """(JAX recorder, port recorder) of the two callables, the JAX one on
    its accelerator route."""
    with jax_accelerator_route(monkeypatch):
        _, jrec = record(jax_obs, jax_fn)
    _, prec = record(port_obs, port_fn)
    return jrec, prec


def sites(rec):
    """{site: [guarantee record, ...]} in record order."""
    out = {}
    for g in rec.guarantee_records:
        out.setdefault(g["site"], []).append(g)
    return out


def steps(rec):
    """{(estimator, step): [ledger entry, ...]} in record order."""
    out = {}
    for e in rec.ledger_entries:
        out.setdefault((e["estimator"], e["step"]), []).append(e)
    return out


def span_names(rec):
    return {s["name"] for s in rec.spans}


def assert_same_sites(jrec, prec, tol_rtol=None, drawn_tol=()):
    """Same guarantee sites, the same record count per site, the same
    ``fail_prob`` and ``n_total`` on every record, ``tol`` equal (or at
    ``tol_rtol[site]`` where the tolerance scales with a fitted, noisy
    value; not compared at the ``drawn_tol`` sites, whose tolerance is
    itself a random draw) and short-circuit records equal."""
    js, ps = sites(jrec), sites(prec)
    assert sorted(ps) == sorted(js)
    for site, jr in js.items():
        pr = ps[site]
        assert len(pr) == len(jr), site
        for a, b in zip(pr, jr):
            assert a["fail_prob"] == b["fail_prob"], site
            assert a.get("n_total") == b.get("n_total"), site
            assert a.get("short_circuit") == b.get("short_circuit"), site
            if b.get("short_circuit"):
                for key in ("realized", "tol", "violated", "attrs"):
                    assert a.get(key) == b.get(key), (site, key)
        if site in drawn_tol:
            continue
        rtol = (tol_rtol or {}).get(site)
        t_p = np.array([r["tol"] for r in pr])
        t_j = np.array([r["tol"] for r in jr])
        if rtol is None:
            np.testing.assert_array_equal(t_p, t_j, err_msg=site)
        else:
            np.testing.assert_allclose(t_p, t_j, rtol=rtol, err_msg=site)


def assert_draws_within_contract(rec):
    """Every draw at a ``fail_prob`` 0 site is within its ``tol``, and the
    audit flags no site."""
    for g in rec.guarantee_records:
        if g["fail_prob"] == 0.0:
            assert not g["violated"], g
    assert not any(a["flagged"] for a in
                   port_obs.guarantees.audit(rec.guarantee_records).values())


def assert_same_steps(jrec, prec, rtol=1e-6):
    """The same ledger (estimator, step) pairs, as often, with ``queries``
    and ``budget`` equal to ``rtol``."""
    js, ps = steps(jrec), steps(prec)
    assert sorted(ps) == sorted(js)
    for key, jr in js.items():
        pr = ps[key]
        assert len(pr) == len(jr), key
        for a, b in zip(pr, jr):
            for field in ("queries", "budget"):
                assert sorted(a[field]) == sorted(b[field]), (key, field)
                for name in b[field]:
                    np.testing.assert_allclose(
                        a[field][name], b[field][name], rtol=rtol,
                        err_msg=f"{key} {field}.{name}")


def assert_same_spans(jrec, prec):
    """The same span names, less the JAX routes the port does not have,
    plus the port's own."""
    expected = (span_names(jrec) - set(JAX_ONLY_SPANS)) | (
        span_names(prec) & set(PORT_ONLY_SPANS))
    assert span_names(prec) == expected
