"""The port's error-budget ledger (``sq_learn_tpu_torch.obs.budget``)
against the JAX package's, on the CPU: the same latency and draw stream,
at the same timestamps, gives equal window statistics, equal ``budget``
and ``alert`` records (apart from their timestamps), the same strict-mode
raise, and the same rendered table and CLI exit codes.
"""

import numpy as np
import pytest

from sq_learn_tpu import obs as jobs
from sq_learn_tpu.obs import budget as jbudget
from sq_learn_tpu_torch import obs
from sq_learn_tpu_torch.obs import budget


def _stream(seed):
    """A seeded latency and draw stream over four tenants with declared
    targets (None = undeclared), as ``(call, args, kwargs)`` triples."""
    rng = np.random.default_rng(seed)
    targets = {"hot": (None, 1e-3), "warm": (5.0, 20.0), "cold": (None, 1e4),
               "blind": (None, None)}
    calls = []
    ts = 1000.0
    for step in range(40):
        ts += float(rng.uniform(0.5, 20.0))
        for tenant, (p50, p99) in targets.items():
            lats = list(rng.exponential(0.004, size=int(rng.integers(1, 9))))
            calls.append(("note_requests", (tenant, lats),
                          dict(p50_ms=p50, p99_ms=p99, ts=ts)))
        if step % 3 == 0:
            calls.append(("note_draw", ("cold", bool(rng.random() < 0.4)),
                          dict(fail_prob=0.01, ts=ts)))
            calls.append(("note_draw", ("warm", False),
                          dict(fail_prob=0.0, ts=ts)))
    return calls, ts


def _run(mod, obs_pkg, calls, now):
    led = mod.BudgetLedger(window_seconds=(60.0, 600.0), site="serving.t")
    for name, args, kw in calls:
        getattr(led, name)(*args, **kw)
    rec = obs_pkg.enable()
    summary, alerts = led.emit(now=now)
    obs_pkg.disable()
    strip = [{k: v for k, v in r.items()
              if k not in ("ts", "v", "schema_version")}
             for r in rec.budget_records + rec.alert_records]
    return led, summary, alerts, strip


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_records_equal_jax(seed):
    calls, now = _stream(seed)
    ours = _run(budget, obs, calls, now)
    theirs = _run(jbudget, jobs, calls, now)
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    assert ours[3] == theirs[3]
    for r in ours[3]:
        assert obs.schema.validate_record(
            dict(r, v=11, schema_version=11, ts=1.0)) == [], r
    for tenant in ours[0].tenants():
        assert ours[0].total_requests(tenant) == \
            theirs[0].total_requests(tenant)
        for w in (1.0, 30.0, 60.0, 600.0):
            assert ours[0].window_stats(tenant, w, now) == \
                theirs[0].window_stats(tenant, w, now)


def test_alerting_tenants_and_collect_render_equal_jax():
    calls, now = _stream(0)
    _, _, alerts, records = _run(budget, obs, calls, now)
    assert {a["tenant"] for a in alerts} == {"hot"}
    view = budget.collect([dict(r) for r in records])
    assert view == jbudget.collect([dict(r) for r in records])
    assert budget.render(view) == jbudget.render(view)
    assert budget.render({}) == jbudget.render({})


def test_strict_raises_after_records_land(monkeypatch):
    monkeypatch.setenv("SQ_OBS_BUDGET_STRICT", "1")
    for mod, obs_pkg in ((budget, obs), (jbudget, jobs)):
        led = mod.BudgetLedger(window_seconds=(60.0, 600.0), threshold=2.0)
        led.note_requests("hot", [0.5] * 8, p99_ms=1e-6, ts=999.0)
        rec = obs_pkg.enable()
        with pytest.raises(mod.BudgetBurnError, match="hot"):
            led.emit(now=1000.0)
        assert len(rec.budget_records) == 2 and len(rec.alert_records) == 1
        obs_pkg.disable()


def test_knobs_and_edges_equal_jax(monkeypatch):
    assert budget.windows() == jbudget.windows() == (60.0, 600.0)
    monkeypatch.setenv("SQ_OBS_BUDGET_WINDOWS", "5, 1,30")
    monkeypatch.setenv("SQ_OBS_BUDGET_BURN", "3.5")
    assert budget.windows() == jbudget.windows() == (1.0, 5.0, 30.0)
    assert budget.burn_threshold() == jbudget.burn_threshold() == 3.5
    with pytest.raises(ValueError):
        budget.BudgetLedger(window_seconds=(0.0,))
    with pytest.raises(KeyError):
        budget.BudgetLedger().window_stats("nobody", 60.0)
    # a zero declared failure probability with a violation: the capped
    # sentinel, in both packages
    for mod in (budget, jbudget):
        led = mod.BudgetLedger(window_seconds=(60.0,))
        led.note_draw("z", True, fail_prob=0.0, ts=1.0)
        assert led.window_stats("z", 60.0, now=2.0)["stat_burn_rate"] == \
            mod.MAX_BURN_RATE


def test_cli_exit_codes_and_text_equal_jax(tmp_path, capsys):
    calls, now = _stream(1)
    paths = {}
    for name, mod, obs_pkg in (("ours", budget, obs), ("theirs", jbudget,
                                                        jobs)):
        led = mod.BudgetLedger(window_seconds=(60.0, 600.0))
        for call, args, kw in calls:
            getattr(led, call)(*args, **kw)
        paths[name] = str(tmp_path / f"{name}.jsonl")
        obs_pkg.enable(paths[name])
        led.emit(now=now)
        obs_pkg.disable()
    capsys.readouterr()
    for path in paths.values():
        assert budget.main([path]) == jbudget.main([path]) == 1  # burning
        ours, theirs = capsys.readouterr().out.split("== tenant")[1:3]
        assert ours == theirs
    empty = tmp_path / "empty.jsonl"
    obs.enable(str(empty))
    obs.disable()
    assert budget.main([str(empty)]) == jbudget.main([str(empty)]) == 2
    assert budget.main([]) == 2
