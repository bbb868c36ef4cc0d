"""The port's spans inside fit and predict, as a ``torch.profiler`` sees
them: one range per span, nested as the layers are, on the profiler's
clock, with obs on or off; and nothing of it changes what a fit or a
predict computes.

The CPU tests trace the plain versions of the kernels. The one test
marked ``cuda`` checks on the card that every synchronizing call of a
small fit and a predict lies inside a ``sync.*`` range:

    python -m pytest --noconftest tests/test_torch_obs_spans.py -m cuda
"""

import os
import re
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.models import KNeighborsClassifier, QKMeans
from sq_learn_tpu_torch.models import qkmeans as qkmeans_module
from sq_learn_tpu_torch.models.qkmeans import _stop_rule_read_due
from sq_learn_tpu_torch.obs import recorder
from sq_learn_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a program range's name: dotted lower-case words (``aten::`` ops, the
#: runtime's calls and the profiler's own events have none)
PROGRAM = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")

#: each span of the fit, under the span that holds it
FIT_PARENTS = {
    "qkmeans.fused_init": {"qkmeans.fit"},
    "qkmeans.stats": {"qkmeans.fused_init"},
    "sync.qkmeans.stats": {"qkmeans.stats"},
    "qkmeans.seed": {"qkmeans.fused_init"},
    "qkmeans.fused_fit": {"qkmeans.fit"},
    "qkmeans.lloyd": {"qkmeans.fused_fit"},
    "qkmeans.lloyd_iter": {"qkmeans.lloyd"},
    # the first read precedes the first step
    "sync.qkmeans.stop_rule": {"qkmeans.lloyd", "qkmeans.lloyd_iter"},
    "qkmeans.gumbel": {"qkmeans.lloyd_iter"},
    "kernels.lloyd_step": {"qkmeans.lloyd_iter"},
    "qkmeans.e_step": {"qkmeans.lloyd_iter"},
    "qkmeans.relocate": {"qkmeans.lloyd_iter"},
    "qkmeans.update": {"qkmeans.lloyd_iter"},
    "qkmeans.finish": {"qkmeans.fused_fit"},
    "sync.qkmeans.best": {"qkmeans.fused_fit"},
    "sync.qkmeans.fetch": {"qkmeans.fused_fit"},
    "qkmeans.quantum_stats": {"qkmeans.fit"},
    "sync.qkmeans.quantum_stats": {"qkmeans.quantum_stats"},
    "sync.qkmeans.sketch_rows": {"qkmeans.fit"},
    "qkmeans.fit": {None},
    "sync.validation": {None},
}

#: each span of the predict, under the span that holds it
PREDICT_PARENTS = {
    "knn.predict": {None},
    "knn.validate": {"knn.predict"},
    "sync.validation": {"knn.validate"},
    "knn.search": {"knn.predict"},
    "kernels.argkmin": {"knn.search"},
    "sync.knn.fetch": {"knn.predict"},
    "knn.vote": {"knn.predict"},
}

FITS = {
    "delta_means": dict(delta=0.5, true_distance_estimate=False, sketch=0),
    "delta_means_sketched": dict(delta=0.5, true_distance_estimate=False,
                                 sketch=256),
    "classic": dict(delta=0.0),
    "ipe": dict(delta=0.5, true_distance_estimate=True, sketch=0),
}


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield
    obs.disable()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    C = rng.normal(scale=4.0, size=(4, 10))
    y = rng.integers(0, 4, 1200)
    return (C[y] + rng.normal(size=(1200, 10))).astype(np.float32), y


def _ranges(prof):
    """(name, start ns, end ns) of the program's ranges, by start."""
    return sorted(
        ((ev.name(), ev.start_ns(), ev.end_ns())
         for ev in prof.profiler.kineto_results.events()
         if ev.device_type() == torch.autograd.DeviceType.CPU
         and PROGRAM.fullmatch(ev.name())),
        key=lambda r: (r[1], -r[2]))


def _parents(ranges):
    """{range index: index of the innermost range holding it, or None}."""
    out, stack = {}, []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] < b:
            stack.pop()
        out[i] = stack[-1] if stack else None
        stack.append(i)
    return out


def _traced(fn, *, with_obs=False):
    """(fn's result, program ranges, obs recorder or None) of ``fn()``
    under a CPU profiler."""
    if with_obs:
        obs.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = fn()
    finally:
        rec = obs.disable()
    return out, _ranges(prof), rec


def _assert_nesting(ranges, expected):
    parents = _parents(ranges)
    seen = set()
    for i, (name, _, _) in enumerate(ranges):
        p = parents[i]
        assert name in expected, name
        assert (None if p is None else ranges[p][0]) in expected[name], (
            name, None if p is None else ranges[p][0])
        seen.add(name)
    return seen


def _count(ranges, name):
    return sum(1 for r in ranges if r[0] == name)


def _fit(X, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = QKMeans(n_clusters=4, n_init=3, random_state=5, **kw).fit(X)
    return {"labels": est.labels_, "centers": est.cluster_centers_,
            "inertia": est.inertia_, "n_iter": est.n_iter_}


@pytest.mark.parametrize("case", sorted(FITS))
def test_a_fit_opens_every_layers_span_nested(blobs, case, monkeypatch):
    X, _ = blobs
    kw = FITS[case]
    steps = []

    def counted(*args, **kwargs):
        steps.append(1)
        return kernels.lloyd_step(*args, **kwargs)

    monkeypatch.setattr(qkmeans_module, "lloyd_step", counted)
    _, ranges, _ = _traced(lambda: _fit(X, kw))
    seen = _assert_nesting(ranges, FIT_PARENTS)
    n_iter = _count(ranges, "qkmeans.lloyd_iter")
    assert n_iter > 1
    if case == "ipe":
        assert not steps
        assert _count(ranges, "qkmeans.e_step") == n_iter
    else:
        assert n_iter == len(steps) == _count(ranges, "kernels.lloyd_step")
        assert "qkmeans.e_step" not in seen
    max_iter = QKMeans().max_iter
    reads = sum(1 for s in range(n_iter + 1)
                if s < max_iter and _stop_rule_read_due(s))
    assert _count(ranges, "sync.qkmeans.stop_rule") == reads
    assert ("qkmeans.gumbel" in seen) == (case.startswith("delta_means"))
    assert ("qkmeans.quantum_stats" in seen) == (kw["delta"] > 0)
    assert ("sync.qkmeans.stats" in seen) == (kw["delta"] > 0)
    for name in ("sync.qkmeans.sketch_rows", "sync.qkmeans.quantum_stats"):
        assert (name in seen) == (case == "delta_means_sketched"), name
    for name in ("qkmeans.fit", "qkmeans.fused_init", "qkmeans.stats",
                 "qkmeans.seed", "qkmeans.fused_fit", "qkmeans.lloyd",
                 "qkmeans.finish", "sync.qkmeans.best", "sync.qkmeans.fetch",
                 "sync.validation"):
        assert _count(ranges, name) == 1, name
    assert _count(ranges, "qkmeans.relocate") == n_iter
    assert _count(ranges, "qkmeans.update") == n_iter


def test_a_predict_opens_its_spans_nested(blobs):
    X, y = blobs
    knn = KNeighborsClassifier(n_neighbors=5).fit(X[:900], y[:900])
    _, ranges, _ = _traced(lambda: knn.predict(X[900:]))
    seen = _assert_nesting(ranges, PREDICT_PARENTS)
    assert seen == set(PREDICT_PARENTS)
    for name in PREDICT_PARENTS:
        assert _count(ranges, name) == 1, name


def _launches():
    return kernels.lloyd_step.launches, kernels.argkmin.launches


def _predict(X, y):
    knn = KNeighborsClassifier(n_neighbors=5).fit(X[:900], y[:900])
    return knn.predict(X[900:]), knn.predict_proba(X[900:])


@pytest.mark.parametrize("case", ["delta_means", "classic"])
def test_results_are_the_same_traced_or_not(blobs, case):
    X, y = blobs

    def run():
        before = _launches()
        out = _fit(X, FITS[case]), _predict(X, y)
        return out, tuple(b - a for a, b in zip(before, _launches()))

    plain = run()
    for with_obs, traced in ((True, False), (False, True), (True, True)):
        if traced:
            got, _, _ = _traced(run, with_obs=with_obs)
        else:
            obs.enable()
            try:
                got = run()
            finally:
                obs.disable()
        (fit, (labels, proba)), launches = got
        assert launches == plain[1]
        for key, want in plain[0][0].items():
            np.testing.assert_array_equal(fit[key], want, err_msg=key)
        np.testing.assert_array_equal(labels, plain[0][1][0])
        np.testing.assert_array_equal(proba, plain[0][1][1])


def test_a_record_starts_on_its_ranges_clock(blobs):
    X, y = blobs
    _, ranges, rec = _traced(lambda: _predict(X, y), with_obs=True)
    by_name = {}
    for name, a, _ in ranges:
        by_name.setdefault(name, []).append(a)
    spans = [s for s in rec.spans if s["name"] in by_name]
    assert {s["name"] for s in spans} >= set(PREDICT_PARENTS)
    for s in spans:
        starts = by_name[s["name"]]
        assert min(abs(s["start_ns"] - a) for a in starts) < 1_000_000, s
        # the profiler times the device: sync= is not honoured
        assert s["synced"] is False


def test_spans_with_obs_and_the_profiler_off():
    assert not obs.enabled()
    assert obs.span("qkmeans.lloyd_iter") is obs.NULL_SPAN
    assert obs.span("knn.vote", sync=torch.ones(2)) is obs.NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = obs.span("knn.vote")
        with sp as entered:
            assert entered.sync(3) == 3 and entered.set(a=1) is entered
    assert sp is not obs.NULL_SPAN and obs.get_recorder() is None
    assert [r[0] for r in _ranges(prof)] == ["knn.vote"]
    assert obs.span("knn.vote") is obs.NULL_SPAN


def test_an_obs_record_carries_its_start_and_a_sync_off_the_profiler():
    obs.enable()
    t0 = time.time_ns()
    with obs.span("sync.unit", sync=torch.ones(2)):
        pass
    rec = obs.disable()
    (s,) = rec.spans
    assert t0 <= s["start_ns"] <= time.time_ns()
    assert s["synced"] is True
    assert not obs.schema.validate_record(s)


def test_spans_run_in_a_process_without_torch():
    obs.span("a.b")  # torch is loaded here: the first span binds its flag
    assert recorder._profiler is torch.autograd.profiler
    code = ("import sys; sys.modules['torch'] = None\n"
            "from sq_learn_tpu_torch import obs\n"
            "assert obs.span('a.b') is obs.NULL_SPAN\n"
            "obs.enable()\n"
            "with obs.span('a.b'):\n"
            "    pass\n"
            "assert obs.disable().spans[0]['start_ns'] > 0\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CUDA mode "
                    "here, and the check reads the card's syncs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_sync_of_a_fit_and_a_predict_is_in_a_sync_span(cuda_device):
    rng = np.random.default_rng(4)
    C = rng.normal(scale=4.0, size=(6, 32))
    y = rng.integers(0, 6, 20_000)
    Xh = (C[y] + rng.normal(size=(20_000, 32))).astype(np.float32)
    X = torch.from_numpy(Xh).to(cuda_device)
    base = dict(n_clusters=6, n_init=4, random_state=1, delta=0.5,
                true_distance_estimate=False, device=cuda_device)
    fits = [{**base, **extra}
            for extra in ({"sketch": 0}, {"sketch": 2048}, {"delta": 0.0})]
    knn = KNeighborsClassifier(n_neighbors=7, device=cuda_device).fit(
        X[:16_000], y[:16_000])
    queries = X[16_000:]

    def run():
        launches = _launches()
        for kw in fits:
            QKMeans(**kw).fit(X)
        knn.predict(queries)
        # the kernels ran: the card's path, not the plain versions
        assert all(b > a for a, b in zip(launches, _launches()))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run()  # builds the kernels, starts the libraries
    torch.cuda.synchronize()
    syncs = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append((time.time_ns(), "".join(
                f"  {f.filename}:{f.lineno} {f.name}\n"
                for f in traceback.extract_stack()
                if "sq_learn_tpu_torch" in f.filename)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            # the profiler's own start and stop sync: only the run counts
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.time_ns()
                run()
                t1 = time.time_ns()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ranges = [r for r in _ranges(prof) if r[0].startswith("sync.")]
    syncs = [(t, where) for t, where in syncs if t0 <= t <= t1]
    assert syncs and ranges
    outside = [where for t, where in syncs
               if not any(a <= t <= b for _, a, b in ranges)]
    assert not outside, "synchronizing calls in no sync.* span:\n" + (
        "\n".join(outside))
