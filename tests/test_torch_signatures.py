"""Signature parity: the port accepts every parameter of the JAX package's
shared public callables, but for the ones ``ROADMAP.md`` gives a reason
for.

For every name the port shares with a JAX module's ``__all__`` (the pairs
of :mod:`test_torch_exports`), each function, each class's ``__init__`` and
each public method of a class is one case: the JAX parameter names, less
those in ``DEPARTURES`` (every parameter of the callables in
``DEPARTING_CALLABLES``), must be parameters of the port's counterpart.
Each departure names its reason, and every departure must stand in
ROADMAP.md's "Not ported, and why". A second test holds every shared
parameter's default to the JAX one wherever both are plain values.
"""

import importlib
import inspect
import os

import numpy as np
import pytest

from sq_learn_tpu_torch import config_context
from test_torch_exports import (GROUND_RULES, NO_OBJECT, PALLAS, REPO,
                                WITH_ALL, _port_name)

#: JAX parameter name → the reason the port does not take it
DEPARTURES = {
    "key": "jax keys: the counterpart is the port's generator",
    "use_pallas": GROUND_RULES,
    "pallas_interpret": PALLAS,
    "axis_name": NO_OBJECT,
    "devices_per_host": NO_OBJECT,
    "reset_watchdog": NO_OBJECT,
}

#: JAX callable (by name) whose every parameter departs → reason
DEPARTING_CALLABLES = {
    "fetch_openml": "the dataset fetchers need a download",
    "fetch_covtype": "the dataset fetchers need a download",
}

#: defaults compared by value: both sides must be one of these
PLAIN = (type(None), bool, int, float, str, tuple)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _signature(f):
    try:
        return inspect.signature(f)
    except (TypeError, ValueError):
        return None


def _cases():
    """(case id, JAX callable, port callable), one per distinct pair."""
    out, seen = [], set()

    def add(label, a, b):
        if _signature(a) is None or _signature(b) is None:
            return
        pair = (getattr(a, "__qualname__", label),
                getattr(a, "__module__", ""),
                getattr(b, "__qualname__", label),
                getattr(b, "__module__", ""))
        if pair not in seen:
            seen.add(pair)
            out.append((label, a, b))

    for name in WITH_ALL:
        theirs = importlib.import_module(name)
        port = importlib.import_module(_port_name(name))
        for attr in theirs.__all__:
            a, b = getattr(theirs, attr), getattr(port, attr, None)
            if b is None or not callable(a):
                continue
            if not inspect.isclass(a):
                add(f"{name}.{attr}", a, b)
                continue
            add(f"{name}.{attr}.__init__", a.__init__,
                b.__init__ if inspect.isclass(b) else b)
            for meth, f in inspect.getmembers(a):
                if not meth.startswith("_") and callable(f) \
                        and not inspect.isclass(f):
                    add(f"{name}.{attr}.{meth}", f, getattr(b, meth, None))
    return out


CASES = _cases()


def _params(f):
    """{name: Parameter} of ``f``, without its * and ** collectors."""
    return {n: p for n, p in _signature(f).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def test_the_cases_cover_the_shared_surface():
    labels = {label for label, _, _ in CASES}
    for label in ("sq_learn_tpu.set_config",
                  "sq_learn_tpu.utils.check_array",
                  "sq_learn_tpu.parallel.elastic.ElasticCoordinator.__init__",
                  "sq_learn_tpu.resilience.supervisor.CircuitBreaker.__init__",
                  "sq_learn_tpu.obs.enable"):
        assert label in labels, label
    assert len(CASES) > 300


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_port_takes_every_jax_parameter(case):
    label, theirs, port = case
    assert port is not None, f"the port lacks {label}"
    name = label.split(".")[-1]
    departing = set(DEPARTURES)
    if name in DEPARTING_CALLABLES:
        departing |= set(_params(theirs))
    lacking = set(_params(theirs)) - set(_params(port)) - departing
    assert not lacking, (
        f"{label}: the port's {port.__qualname__} lacks {sorted(lacking)}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_shared_parameters_keep_the_jax_defaults(case):
    label, theirs, port = case
    ours = _params(port)
    for name, p in _params(theirs).items():
        if name not in ours:
            continue
        a, b = p.default, ours[name].default
        if a is p.empty or b is p.empty:
            continue
        if isinstance(a, PLAIN) and isinstance(b, PLAIN):
            assert type(a) is type(b) and a == b, (
                f"{label}({name}=...): JAX {a!r}, port {b!r}")


def test_every_departure_has_its_line_in_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    section = text[text.index("**Not ported, and why**"):]
    section = section[:section.index("\n### ")]
    for name in [*DEPARTURES, *DEPARTING_CALLABLES]:
        assert f"`{name}`" in section or f"`{name}=" in section, name
    for reason in {*DEPARTURES.values(), *DEPARTING_CALLABLES.values()}:
        assert reason.split(":")[0] in section, reason


def test_a_departure_without_an_object_is_rejected_with_its_reason(tmp_path):
    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.parallel.elastic import ElasticCoordinator

    with pytest.raises(TypeError, match="reset_watchdog has no object in "
                                        "eager torch"):
        obs.enable(reset_watchdog=True)
    assert not obs.enabled()
    with pytest.raises(TypeError, match="devices_per_host has no object in "
                                        "eager torch"):
        ElasticCoordinator(str(tmp_path / "run"), str(tmp_path / "store"),
                           devices_per_host=2)


def test_the_roadmaps_smallest_inputs_behave_as_in_the_jax_package():
    import sq_learn_tpu as sq
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu.utils import check_array as jax_check
    from sq_learn_tpu_torch.utils import check_array

    row = np.array([[1.0, np.nan, 3.0]], np.float32)
    with sq.config_context(assume_finite=True):
        expected = jax_check(row)
    with sqt.config_context(assume_finite=True):
        got = check_array(row, device="cpu")
    np.testing.assert_array_equal(got.numpy(), expected)
    message = ("Found array with 1 sample(s) while a minimum of 2 is "
               "required.")
    for fn, kw in ((jax_check, {}), (check_array, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            fn(np.ones((1, 3)), ensure_min_samples=2, **kw)
        assert str(exc.value) == message
