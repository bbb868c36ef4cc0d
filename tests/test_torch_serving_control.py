"""The port's serving controller (``sq_learn_tpu_torch.serving.control``)
against the JAX package's, on the CPU: fed the same burn telemetry (the
same latencies and draws, at the same ledger timestamps), both make the
same sequence of plan, hold, degrade, recover, relax and tighten
decisions, and their ``control`` records are equal apart from
timestamps. A dispatcher whose controller degrades a burning tenant to
the last rung still serves it on the registry's device.
"""

import numpy as np
import pytest

from sq_learn_tpu import obs as jobs
from sq_learn_tpu import serving as jserving
from sq_learn_tpu.obs import budget as jbudget
from sq_learn_tpu_torch import obs, serving
from sq_learn_tpu_torch.obs import budget
from sq_learn_tpu_torch.serving import control

from _torch_serving_helpers import jax_tenants, request_stream, reset_serving


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    return jax_tenants(tmp_path_factory.mktemp("tenants"))


@pytest.fixture(autouse=True)
def _hygiene():
    reset_serving()
    yield
    reset_serving()


class _StubDispatcher:
    """What a controller reads of a dispatcher: its ledger and its bucket
    geometry."""

    def __init__(self, ledger):
        self._ledger = ledger
        self._min_bucket = 8
        self._max_batch_rows = 128

    def budget_ledger(self):
        return self._ledger


#: tenant → declared (p99 ms, slo_eps, slo_delta)
_DECLARED = {"greedy": (1.0, 0.01, 1e-3), "steady": (1.0, None, None),
             "banker": (1e4, None, 1e-3), "tight": (1.0, 1e-3, None)}

#: per evaluation: latency in ms per tenant, and violated draws for banker
_SCRIPT = ([({"greedy": 50.0, "steady": 50.0, "banker": 0.01,
              "tight": 50.0}, 0)] * 3
           + [({"greedy": 0.01, "steady": 0.01, "banker": 0.01,
                "tight": 0.01}, 0)] * 6
           + [({"greedy": 0.01, "steady": 0.01, "banker": 0.01,
                "tight": 0.01}, 25)] * 2)


def _drive(serving_pkg, obs_pkg, budget_pkg, ckpt):
    """Register the tenants under a fresh controller, feed the script's
    telemetry, evaluate after each step; return (actions per step, the
    control records, the final contracts)."""
    rec = obs_pkg.enable()
    if serving_pkg is serving:
        reg = serving.ModelRegistry(device="cpu")
    else:
        reg = serving_pkg.ModelRegistry()
    ctl = reg.controller(patience=1)
    for tenant, (p99, eps, delta) in _DECLARED.items():
        reg.register(tenant, ckpt, quantize=None, slo_p99_ms=p99,
                     slo_eps=eps, slo_delta=delta)
    led = budget_pkg.BudgetLedger(window_seconds=(1.0, 4.0), site="test")
    stub = _StubDispatcher(led)
    t = 100.0
    steps = []
    for latencies, violations in _SCRIPT:
        for tenant, ms in latencies.items():
            p50_t, p99_t = (ctl.targets_for(tenant)
                            or reg.declared_targets(tenant))
            led.note_requests(tenant, [ms / 1e3] * 20, p50_ms=p50_t,
                              p99_ms=p99_t, ts=t)
        for _ in range(violations):
            led.note_draw("banker", True, fail_prob=1e-3, ts=t)
        steps.append(ctl.evaluate(stub, now=t))
        t += 1.5
    steps.append(ctl.evaluate(stub, now=t, final=True))
    obs_pkg.disable()
    return steps, rec.control_records, ctl.contracts()


def _strip(records):
    return [{k: v for k, v in r.items()
             if k not in ("ts", "v", "schema_version")} for r in records]


def test_decisions_and_records_equal_jax(tenants):
    ckpt = tenants["km"][1]
    ours = _drive(serving, obs, budget, ckpt)
    theirs = _drive(jserving, jobs, jbudget, ckpt)
    assert ours[0] == theirs[0]
    assert _strip(ours[1]) == _strip(theirs[1])
    assert ours[2] == theirs[2]
    actions = {r["action"] for r in ours[1]}
    assert actions == {"plan", "hold", "degrade", "recover", "relax",
                       "tighten"}
    for r in ours[1]:
        assert obs.schema.validate_record(dict(r)) == [], r


def test_plan_picks_the_same_route(tenants):
    ckpt = tenants["km"][1]
    routes = {}
    for pkg, obs_pkg in ((serving, obs), (jserving, jobs)):
        obs_pkg.enable()
        reg = (serving.ModelRegistry(device="cpu") if pkg is serving
               else pkg.ModelRegistry())
        reg.controller()
        for tenant, (p99, eps, delta) in _DECLARED.items():
            reg.register(tenant, ckpt, quantize=None, slo_p99_ms=p99,
                         slo_eps=eps, slo_delta=delta)
        routes[pkg] = {t: reg.current_route(t) for t in _DECLARED}
        obs_pkg.disable()
    assert routes[serving] == routes[jserving]
    assert routes[serving]["greedy"] == "int8"
    assert routes[serving]["steady"] is None


@pytest.mark.parametrize("value,route", [(1e-3, None), (2e-3, "bf16"),
                                         (None, None)])
def test_theoretical_cost_equals_jax(value, route):
    assert control.theoretical_cost(value, route) == \
        jserving.control.theoretical_cost(value, route)


def test_autotune_off_and_obs_off_allocate_no_controller(tenants):
    reg = serving.ModelRegistry(device="cpu")
    reg.register("t", tenants["km"][1], quantize=None)
    assert reg.controller() is None  # no recorder: nothing allocated
    d = serving.MicroBatchDispatcher(reg, background=False)
    d.serve("t", "predict", request_stream(n=1)[0])
    d.close()
    assert d._ctl is None and d.budget_ledger() is None
    obs.enable()
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=False,
                                     autotune_every=1)
    d.serve("t", "predict", request_stream(n=1)[0])
    d.close()
    assert d._ctl is None and obs.get_recorder().control_records == []
    obs.disable()


def test_burning_tenant_walks_the_ladder_and_still_serves(tenants):
    """A tenant with an impossible p99 target and an aggressive
    renegotiation margin is degraded to wider coalescing, then to the host
    rung; every response still equals the exact route's, computed on the
    registry's device."""
    ckpt = tenants["km"][1]
    reg = serving.ModelRegistry(device="cpu")
    rec = obs.enable()
    reg.controller(patience=1, margin=0.25)
    reg.register("t", ckpt, quantize=None, slo_p99_ms=1e-6)
    d = serving.MicroBatchDispatcher(reg, background=False, autotune=True,
                                     autotune_every=1)
    reqs = request_stream(n=16)
    outs = []
    for X in reqs:
        outs.append(d.serve("t", "predict", X))
    d._ctl.margin = 4.0
    d.close()
    obs.disable()
    est = tenants["km"][0]
    for X, o in zip(reqs, outs):
        assert np.array_equal(o, est.predict(np.asarray(X, np.float32)))
    rungs = []
    for r in rec.control_records:
        if r["action"] == "degrade":
            rung = "host" if r["decision"]["route"] == "host" else "widen"
            if rung not in rungs:
                rungs.append(rung)
    assert rungs[:2] == ["widen", "host"]
    assert rec.counters["serving.degraded_batches"] >= 1
