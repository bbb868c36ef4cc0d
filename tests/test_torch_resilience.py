"""The port's resilience layer (``sq_learn_tpu_torch.resilience``) against
the JAX package's, on the CPU: the fault grammar and its draws, the
supervised put (retries, keyed backoff, deadline), the circuit breaker and
resumable streamed passes.

Parity discipline, as in ``tests/test_resilience.py``: a fault-injected
and recovered, or interrupted and resumed, streamed computation must equal
the fault-free one bit for bit. The same ``SQ_FAULTS`` spec must fail the
same tiles in both packages, and the breaker must go through the JAX
breaker's transitions, with the port's raise where the JAX package runs
its CPU escape.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sq_learn_tpu import streaming as jstreaming
from sq_learn_tpu.obs.schema import validate_record as jax_validate
from sq_learn_tpu.resilience import faults as jfaults
from sq_learn_tpu.resilience import supervisor as jsup
from sq_learn_tpu_torch import config_context, obs, streaming
from sq_learn_tpu_torch.models import QPCA
from sq_learn_tpu_torch.obs.schema import validate_record
from sq_learn_tpu_torch.resilience import faults, supervisor
from sq_learn_tpu_torch.resilience.faults import (FaultSpecError,
                                                  InjectedInterrupt,
                                                  InjectedTransferError)
from sq_learn_tpu_torch.resilience.supervisor import (
    CLOSED, HALF_OPEN, OPEN, BreakerOpenError, CircuitBreaker,
    NonFiniteAccumulatorError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(0)
# 1003 rows in 150-row tiles: 7 tiles with a ragged tail
X_TALL = (RNG.normal(size=(1003, 16)) + 2.0).astype(np.float32)
ROW_BYTES = X_TALL.nbytes // X_TALL.shape[0]
TILE_BYTES = 150 * ROW_BYTES


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Every test runs on the CPU, disarmed, with a closed history-free
    breaker and fast retries (both packages' breakers)."""
    monkeypatch.setenv("SQ_RETRY_BACKOFF_S", "0.001")
    with config_context(device="cpu"):
        yield
    for mod, br in ((faults, supervisor.breaker), (jfaults, jsup.breaker)):
        mod.disarm()
        br.reset()
        br.transitions.clear()
        br.trips = 0


def _gram(**kw):
    mean, G, _ = streaming.streamed_centered_gram(X_TALL,
                                                  max_bytes=TILE_BYTES, **kw)
    return mean.numpy(), G.numpy()


# -- the fault grammar ------------------------------------------------------


_SPECS = ["put_fail:tiles=2/5,times=2;put_stall:p=0.5,s=0.1,seed=7;"
          "nan:tiles=1;abort:tile=4;probe_timeout:n=3",
          "read_fail:p=0.3,seed=2;corrupt_shard:tiles=0/9;cold_tier:"
          "s=0.01,per_mb=0.5", "host_fail:host=1,window=3;host_stall:tile=2"]


@pytest.mark.parametrize("spec", _SPECS)
def test_spec_parses_as_in_jax(spec):
    ours, theirs = faults.parse_spec(spec), jfaults.parse_spec(spec)
    fields = ("index", "kind", "tiles", "tile", "host", "p", "times", "seed",
              "stall_s", "per_mb", "count")
    assert [[getattr(i, f) for f in fields] for i in ours] == \
        [[getattr(i, f) for f in fields] for i in theirs]


@pytest.mark.parametrize("bad", [
    "", "wedge_everything", "put_fail:frequency=2", "put_fail:tiles",
    "put_stall:s=often"])
def test_malformed_specs_raise(bad):
    with pytest.raises(FaultSpecError):
        faults.parse_spec(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.parse_spec(bad)


@pytest.mark.parametrize("spec", ["put_fail:p=0.25,seed=3",
                                  "nan:p=0.5,seed=11,times=2",
                                  "put_stall:p=0.1"])
def test_same_spec_fails_the_same_tiles_in_both_packages(spec):
    """The splitmix64 draws are copied: per tile, the same selections (a
    ``times=2`` countdown included) on both sides."""
    ours = faults.FaultPlan(spec).injectors[0]
    theirs = jfaults.FaultPlan(spec).injectors[0]
    picks = [[inj.matches(t) for t in range(200) for _ in range(3)]
             for inj in (ours, theirs)]
    assert picks[0] == picks[1]
    assert 0 < sum(picks[0]) < 600


def test_u01_matches_jax():
    for salt in [(0,), (1, 2), (7, 3, 9), (2**40, 5)]:
        for seed in (0, 1, 12345):
            assert faults._u01(seed, *salt) == jfaults._u01(seed, *salt)


def test_arm_disarm_and_nan_injection():
    assert not faults.active()
    plan = faults.arm("nan:tiles=0/1")
    assert faults.active() and faults.get_plan() is plan
    int_tile = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(plan.corrupt(int_tile, 0), int_tile)
    tile = np.ones((2, 3), np.float32)
    assert np.isnan(plan.corrupt(tile, 1)).any() and np.isfinite(tile).all()
    assert [ev.get("skipped") for ev in plan.events] == [
        "non-float dtype", None]
    assert faults.disarm() is plan and not faults.active()


def test_env_spec_arms_at_import():
    code = ("from sq_learn_tpu_torch.resilience import faults; "
            "print([i.kind for i in faults.get_plan().injectors])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  SQ_FAULTS="abort:tile=1;put_fail:tiles=2"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['abort', 'put_fail']"


# -- retries and backoff ----------------------------------------------------


def test_unarmed_put_is_the_fast_path():
    assert faults._active is None and supervisor.breaker._state == CLOSED
    tile = np.zeros(4, np.float32)
    assert supervisor.put(lambda t: t, tile) is tile


@pytest.mark.parametrize("spec,kinds", [
    ("put_fail:tiles=2,times=2", ["put_fail", "put_fail"]),
    ("put_fail:tiles=3/6,times=1", ["put_fail", "put_fail"]),
    ("put_stall:tiles=1,s=0.001", ["put_stall"]),
])
def test_transient_faults_recover_bit_equal(spec, kinds):
    mean_ref, G_ref = _gram()
    plan = faults.arm(spec)
    mean_f, G_f = _gram()
    assert [ev["kind"] for ev in plan.events] == kinds
    np.testing.assert_array_equal(G_f, G_ref)
    np.testing.assert_array_equal(mean_f, mean_ref)
    assert supervisor.breaker.state() == CLOSED


@pytest.mark.parametrize("exc_type", [RuntimeError, OSError])
def test_fast_path_retries_real_transient_errors(exc_type):
    calls = []

    def flaky(t):
        calls.append(1)
        if len(calls) < 3:
            raise exc_type("transient transfer hiccup")
        return t

    out = supervisor.put(flaky, np.ones(4, np.float32))
    assert len(calls) == 3 and out.sum() == 4
    assert supervisor.breaker.consecutive_failures == 0


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("exc", [
    ValueError("operand shapes incompatible"),
    RuntimeError("CUDA error: out of memory"),
    NonFiniteAccumulatorError("non-finite accumulator leaf 0"),
    InjectedInterrupt("injected mid-pass interrupt"),
    BreakerOpenError("open"),
])
def test_deterministic_errors_never_retry(exc, armed):
    if armed:
        faults.arm("probe_timeout:n=1")  # forces the supervised path
    calls = []

    def broken(t):
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        supervisor.put(broken, np.ones(2, np.float32))
    assert len(calls) == 1 and supervisor.breaker.consecutive_failures == 0


def test_retries_exhausted_raise_the_terminal_error(monkeypatch):
    monkeypatch.setenv("SQ_RETRY_MAX", "2")
    monkeypatch.setenv("SQ_BREAKER_K", "99")
    faults.arm("put_fail:tiles=0,times=10")
    with pytest.raises(InjectedTransferError):
        _gram()
    assert supervisor.breaker.consecutive_failures == 3  # 1 + 2 retries


def test_backoff_matches_jax():
    for attempt in range(4):
        for tile in (0, 3, 17):
            assert supervisor.backoff_delay(attempt, tile, seed=1) == \
                jsup.backoff_delay(attempt, tile, seed=1)
    d = [supervisor.backoff_delay(a, 3, seed=1) for a in range(3)]
    for attempt, delay in enumerate(d):
        assert 0.001 * 2 ** attempt <= delay < 0.002 * 2 ** attempt


def test_deadline_exceeded_counts_as_timeout(monkeypatch):
    monkeypatch.setenv("SQ_TILE_DEADLINE_S", "0.0001")
    monkeypatch.setenv("SQ_BREAKER_K", "99")
    faults.arm("put_stall:tiles=1,s=0.01")
    _gram()
    assert supervisor.breaker.consecutive_failures == 0  # later tiles ok
    assert any(ev["kind"] == "put_stall" for ev in faults.get_plan().events)


def test_faults_retries_and_breaker_are_recorded(tmp_path, monkeypatch):
    """Injected faults become ``fault`` records, the retries the
    ``resilience.retries`` counter, the breaker's transitions ``breaker``
    records and the ``resilience.breaker_state`` gauge; each validates
    under both packages' schemas."""
    monkeypatch.setenv("SQ_BREAKER_K", "2")
    rec = obs.enable(str(tmp_path / "faults.jsonl"))
    try:
        faults.arm("put_fail:tiles=1/4,times=1")
        _gram()
        faults.disarm()
        supervisor.breaker.record_failure("x")
        supervisor.breaker.record_failure("x")
        supervisor.breaker.reset()
    finally:
        obs.disable()
    assert [e["tile"] for e in rec.fault_events] == [1, 4]
    assert rec.counters["resilience.retries"] == 2
    assert [e["state"] for e in rec.breaker_events] == [OPEN, CLOSED]
    assert rec.gauges["resilience.breaker_state"] == CLOSED
    for ev in rec.fault_events + rec.breaker_events:
        assert validate_record(ev) == [] and jax_validate(ev) == []
    assert obs.schema.validate_jsonl(str(tmp_path / "faults.jsonl"))[
        "errors"] == []


# -- the circuit breaker ----------------------------------------------------


def _breakers(monkeypatch, k=2, cooldown=10.0):
    monkeypatch.setenv("SQ_BREAKER_K", str(k))
    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", str(cooldown))
    clock = {"t": 100.0}
    ours = CircuitBreaker(clock=lambda: clock["t"])
    theirs = jsup.CircuitBreaker(clock=lambda: clock["t"],
                                 trip_action=lambda: None)
    return ours, theirs, clock


_SEQUENCES = {
    "trip": ["fail", "fail"],
    "reset_by_success": ["fail", "ok", "fail"],
    "half_open_cycle": ["fail", "fail", "+5", "state", "+6", "state",
                        "probe_timeout", "+11", "state", "probe_ok"],
    "half_open_trial_put": ["fail", "fail", "+11", "state", "fail",
                            "+11", "ok"],
    "reset": ["fail", "fail", "reset", "fail"],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_breaker_transitions_equal_jax(monkeypatch, name):
    ours, theirs, clock = _breakers(monkeypatch)
    for br in (ours, theirs):
        clock["t"] = 100.0
        for step in _SEQUENCES[name]:
            if step == "fail":
                br.record_failure("x")
            elif step == "ok":
                br.record_success()
            elif step.startswith("+"):
                clock["t"] += float(step[1:])
            elif step == "state":
                br.state()
            elif step.startswith("probe_"):
                br.on_probe(step[len("probe_"):])
            elif step == "reset":
                br.reset()
    assert ours.transitions == theirs.transitions
    assert ours.state() == theirs.state() and ours.trips == theirs.trips


def test_trip_action_runs_once_per_trip_as_in_jax(monkeypatch):
    """The hook runs at each closed → open trip, never at a failed
    half-open trial's re-open; the port's default does nothing."""
    monkeypatch.setenv("SQ_BREAKER_K", "2")
    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", "10")
    clock = {"t": 100.0}
    calls = {"port": [], "jax": []}
    ours = CircuitBreaker(clock=lambda: clock["t"],
                          trip_action=lambda: calls["port"].append(
                              ours.state()))
    theirs = jsup.CircuitBreaker(clock=lambda: clock["t"],
                                 trip_action=lambda: calls["jax"].append(
                                     theirs.state()))
    for br in (ours, theirs):
        clock["t"] = 100.0
        for step in ["fail", "fail", "fail", "+11", "state", "fail", "+11",
                     "ok", "fail", "fail"]:
            if step == "fail":
                br.record_failure("x")
            elif step == "ok":
                br.record_success()
            elif step == "state":
                br.state()
            else:
                clock["t"] += float(step[1:])
    assert calls["port"] == calls["jax"] == [OPEN, OPEN]
    assert ours.trips == theirs.trips == 2
    assert ours.transitions == theirs.transitions
    plain = CircuitBreaker(clock=lambda: clock["t"])
    assert plain.trip_action is None
    plain.record_failure("x")
    plain.record_failure("x")
    assert plain.state() == OPEN and plain.trips == 1


def test_open_breaker_raises_and_nothing_moves_to_the_cpu(monkeypatch):
    """Where the JAX breaker runs its CPU escape, the port's raises: the
    tile that trips it raises ``BreakerOpenError`` (naming the site and the
    transition), so does the next supervised put, and so does a streamed
    fit's preflight. No fit output is made at all."""
    monkeypatch.setenv("SQ_BREAKER_K", "3")
    faults.arm("put_fail:tiles=2,times=10")
    with pytest.raises(BreakerOpenError, match="3 consecutive failures"):
        _gram()
    assert supervisor.breaker.state() == OPEN
    faults.disarm()
    with pytest.raises(BreakerOpenError, match="streaming.gram_colsum"):
        _gram()
    pca = QPCA(n_components=3, svd_solver="full", ingest="streamed")
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    with pytest.raises(BreakerOpenError, match="qpca.fit"):
        pca.fit(X_TALL)
    assert not hasattr(pca, "components_")
    supervisor.breaker.reset()
    assert QPCA(n_components=3, svd_solver="full",
                ingest="streamed").fit(X_TALL).ingest_ == "streamed"


def test_half_open_preflight_probes_the_device(monkeypatch):
    """After the cooldown, ``preflight`` runs the private probe: a healthy
    device closes the breaker, an injected probe timeout re-opens it and
    the preflight raises."""
    monkeypatch.setenv("SQ_BREAKER_K", "1")
    monkeypatch.setenv("SQ_BREAKER_COOLDOWN_S", "0")
    br = supervisor.breaker
    br.record_failure("wedge")
    faults.arm("probe_timeout:n=1")
    with pytest.raises(BreakerOpenError, match="probe timeout"):
        br.preflight("test", torch.device("cpu"))
    faults.disarm()
    assert br.preflight("test", torch.device("cpu")) == CLOSED
    assert [t["state"] for t in br.transitions] == [
        OPEN, HALF_OPEN, OPEN, HALF_OPEN, CLOSED]


# -- strict finiteness and input validation -----------------------------------


def test_strict_mode_raises_with_tile_provenance(monkeypatch):
    monkeypatch.setenv("SQ_RESILIENCE_STRICT", "1")
    faults.arm("nan:tiles=1")
    with pytest.raises(NonFiniteAccumulatorError, match="tile 1"):
        _gram()


def test_without_strict_nan_propagates_as_in_jax():
    faults.arm("nan:tiles=1")
    _, G = _gram()
    jfaults.arm("nan:tiles=1")
    _, jG, _ = jstreaming.streamed_centered_gram(X_TALL,
                                                 max_bytes=TILE_BYTES)
    assert not np.isfinite(G).all() and not np.isfinite(np.asarray(jG)).all()


def test_streamed_routes_check_values_on_the_device():
    """The estimators' streamed routes (``validate=True``) raise
    check_array's error for non-finite input, after the pass."""
    faults.arm("nan:tiles=3")
    with pytest.raises(ValueError, match="NaN or infinity"):
        streaming.streamed_centered_gram(X_TALL, max_bytes=TILE_BYTES,
                                         validate=True)


# -- resumable passes -------------------------------------------------------


def test_interrupt_then_resume_bitwise_parity(tmp_path, monkeypatch):
    ckpt = streaming.StreamCheckpoint(str(tmp_path / "gram.npz"), every=2)
    mean_ref, G_ref = _gram()
    faults.arm("abort:tile=4,times=1")
    with pytest.raises(InjectedInterrupt):
        _gram(checkpoint=ckpt)
    assert (tmp_path / "gram.npz").exists()
    puts = []
    real = streaming._cpu_put
    monkeypatch.setattr(streaming, "_cpu_put",
                        lambda t: puts.append(t.shape[0]) or real(t))
    mean_r, G_r = _gram(checkpoint=ckpt)
    # the abort fired while tile 4 staged: tiles 0-2 were folded and the
    # every=2 snapshot left cursor 2, so the rerun puts tiles 2..6 only
    assert len(puts) == 5
    np.testing.assert_array_equal(G_r, G_ref)
    np.testing.assert_array_equal(mean_r, mean_ref)
    assert not (tmp_path / "gram.npz").exists()  # completed: removed


def test_port_resumes_a_jax_written_pass_checkpoint(tmp_path):
    """The fingerprint and the file are the JAX package's: a Gram pass the
    JAX package checkpointed resumes in the port at its cursor."""
    path = str(tmp_path / "gram.npz")
    jfaults.arm("abort:tile=4,times=1")
    with pytest.raises(jfaults.InjectedInterrupt):
        jstreaming.streamed_centered_gram(
            X_TALL, max_bytes=TILE_BYTES,
            checkpoint=jstreaming.StreamCheckpoint(path, every=2))
    jfaults.disarm()
    rec = obs.enable()
    try:
        mean_r, G_r = _gram(checkpoint=streaming.StreamCheckpoint(path,
                                                                  every=2))
    finally:
        obs.disable()
    assert rec.gauges["resilience.resume_cursor"] == 2
    jmean, jG, _ = jstreaming.streamed_centered_gram(X_TALL,
                                                     max_bytes=TILE_BYTES)
    np.testing.assert_allclose(G_r, np.asarray(jG), rtol=1e-4,
                               atol=1e-5 * np.abs(G_r).max())
    np.testing.assert_allclose(mean_r, np.asarray(jmean), rtol=1e-6)


@pytest.mark.parametrize("change", ["shift", "interior"])
def test_stale_checkpoint_is_ignored(tmp_path, change):
    ckpt = streaming.StreamCheckpoint(str(tmp_path / "gram.npz"), every=2)
    faults.arm("abort:tile=4,times=1")
    with pytest.raises(InjectedInterrupt):
        _gram(checkpoint=ckpt)
    faults.disarm()
    other = X_TALL + 1.0 if change == "shift" else X_TALL.copy()
    if change == "interior":
        other[1:-1] = X_TALL[-2:0:-1]
        assert streaming._data_digest(other) != streaming._data_digest(
            X_TALL)
    ref = streaming.streamed_centered_gram(other, max_bytes=TILE_BYTES)
    got = streaming.streamed_centered_gram(other, max_bytes=TILE_BYTES,
                                           checkpoint=ckpt)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())


def test_prestats_ingest_opts_out_of_env_checkpointing(monkeypatch,
                                                       tmp_path):
    from sq_learn_tpu_torch.utils import checkpoint as ckpt_mod

    monkeypatch.setenv("SQ_STREAM_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "1")
    monkeypatch.setattr(ckpt_mod, "save_stream_state", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("ingest wrote a checkpoint")))
    out = streaming.streamed_prestats(X_TALL, max_bytes=TILE_BYTES)
    assert not list(tmp_path.iterdir())
    np.testing.assert_allclose(out["mean"].numpy(), X_TALL.mean(axis=0),
                               rtol=1e-5, atol=1e-5)


def test_resumed_qpca_fit_matches_uninterrupted_exactly(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("SQ_STREAM_TILE_BYTES", str(TILE_BYTES))
    monkeypatch.setenv("SQ_STREAM_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("SQ_STREAM_CKPT_EVERY", "2")

    def fit():
        return QPCA(n_components=3, svd_solver="full", random_state=0,
                    ingest="streamed").fit(X_TALL)

    ref = fit()
    faults.arm("abort:tile=4,times=1")
    with pytest.raises(InjectedInterrupt):
        fit()
    assert any(f.suffix == ".npz" for f in tmp_path.iterdir())
    resumed = fit()
    for attr in ("mean_", "components_", "singular_values_",
                 "explained_variance_", "left_sv"):
        np.testing.assert_array_equal(getattr(resumed, attr),
                                      getattr(ref, attr), err_msg=attr)
    assert not any(f.suffix == ".npz" for f in tmp_path.iterdir())


def test_resident_put_recovers_bit_equal():
    plan = faults.arm("put_fail:tiles=1,times=1")
    out = streaming.streamed_resident_put(X_TALL, max_bytes=TILE_BYTES)
    assert [ev["kind"] for ev in plan.events] == ["put_fail"]
    np.testing.assert_array_equal(out.numpy(), X_TALL)


@pytest.mark.parametrize("rec", [
    {"type": "fault", "kind": 7, "tile": 1},
    {"type": "fault", "kind": "x", "tile": "one"},
    {"type": "breaker", "state": "melted", "prev": "closed",
     "reason": "r", "consecutive": 1},
    {"type": "breaker", "state": "open", "prev": "closed",
     "reason": "r", "consecutive": -1},
])
def test_invalid_records_rejected(rec):
    assert validate_record(dict(rec, v=1, ts=1.0)) != []
    assert jax_validate(dict(rec, v=1, ts=1.0)) != []
