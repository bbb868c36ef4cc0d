"""The trace reading's arithmetic on a hand-made list of profiler events:
busy and idle time, the device time of a wrapped call's launches, and the
breakdown."""

import pytest
import torch

from perfbench import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end, corr=0):
        self._v = (name, device, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


def _events():
    return [
        Event(trace.WINDOW, CPU, 0, 1000),
        Event("perfbench.argkmin", CPU, 100, 200),
        Event("cudaLaunchKernel", CPU, 110, 120, corr=7),
        Event("cudaLaunchKernel", CPU, 150, 160, corr=8),
        Event("cudaLaunchKernel", CPU, 300, 310, corr=9),
        Event("aten::sum", CPU, 600, 900),
        Event("argkmin_short", CUDA, 130, 400, corr=7),    # launched inside
        Event("argkmin_merge", CUDA, 400, 450, corr=8),    # launched inside
        Event("reduce_kernel", CUDA, 500, 520, corr=9),    # outside the call
        Event("Memcpy DtoH (Device -> Pageable)", CUDA, 990, 1100),
        Event("perfbench.argkmin", CUDA, 130, 450),        # annotation only
    ]


def test_busy_idle_and_the_calls_device_time():
    got = trace.summarize(_events())
    assert got["window_s"] == pytest.approx(1000e-9)
    # kernels 130–450 and 500–520, the copy clipped to 990–1000
    assert got["busy_s"] == pytest.approx((320 + 20 + 10) * 1e-9)
    assert got["range_device_s"] == {"perfbench.argkmin":
                                     pytest.approx(320e-9)}
    assert got["range_calls"] == {"perfbench.argkmin": 1}
    assert got["device_ops"][0] == ["argkmin_short", pytest.approx(270e-9)]
    idle = dict(got["idle_gaps"])
    # gaps 0–130 (mid 65: nothing open), 450–500 and 520–990 (aten::sum)
    assert idle["host"] == pytest.approx(130e-9 + 50e-9)
    assert idle["aten::sum"] == pytest.approx(470e-9)


def test_activity_of_events_without_a_type():
    kinds = [trace.activity(e) for e in _events()]
    assert kinds == ["cpu_op", "cpu_op", "cuda_runtime", "cuda_runtime",
                     "cuda_runtime", "cpu_op", "kernel", "kernel", "kernel",
                     "gpu_memcpy", "gpu_user_annotation"]


def test_no_window_no_reading():
    with pytest.raises(RuntimeError):
        trace.summarize(_events()[1:])


def _fit_ctx(calls, fits):
    import types

    from perfbench import peaks

    return types.SimpleNamespace(
        kind="fit", calls={"lloyd_step": calls}, window_s=2.0,
        work=[{"n_iter": 3, "seconds": 0.5}] * fits,
        trace={"window_s": 2.0, "busy_s": 1.0,
               "range_device_s": {"perfbench.lloyd_step": 1e-3}},
        peaks=peaks.PEAKS["H100"])


def test_the_loops_work_is_read_from_the_recorded_calls():
    from perfbench import harness, work

    call = {"n": 1000, "m": 8, "k": 3, "R": 4, "x_itemsize": 4}
    calls = [{**call, "active": a} for a in (4, 4, 2, 0, 4)]
    ctx = _fit_ctx(calls, 2)
    assert harness.reader("iters_per_fit")(ctx) == 2.5
    ops = sum(work.lloyd_step_work(1000, 8, 3, a)[1] for a in (4, 4, 2, 0, 4))
    assert harness.reader("fit_mfu")(ctx) == pytest.approx(
        100 * ops / (2.0 * 495e12))
    least = sum(work.least_seconds(*work.lloyd_step_work(1000, 8, 3, a),
                                   ctx.peaks)[0] for a in (4, 4, 2, 0, 4))
    assert harness.reader("lloyd_roofline")(ctx)["value"] == pytest.approx(
        100 * least / 1e-3)
    assert harness.reader("iters_per_fit")(_fit_ctx([], 2)) is None


def test_the_recorder_reads_running_restarts_after_the_window():
    import types

    from perfbench import jobs

    def step(X, centers, *, active=None):
        return X.sum()

    module = types.SimpleNamespace(step=step)
    rec = jobs.Recorder(module, "step", lambda X, centers, active=None: {
        "R": centers.shape[0],
        "active": centers.shape[0] if active is None else active}, True)
    X = torch.ones(5, 2)
    module.step(X, torch.zeros(4, 3))
    module.step(X, torch.zeros(4, 3),
                active=torch.tensor([True, False, True, False]))
    assert rec.read_calls() == [{"R": 4, "active": 4}, {"R": 4, "active": 2}]
    rec.restore()
    assert module.step is step


def test_random_states_differ_by_seed_and_request():
    from perfbench import jobs

    got = {jobs.random_state(s, i) for s in (1, 2**31 + 7, 2**40)
           for i in range(-1, 50)}
    assert len(got) == 3 * 51
    assert all(0 <= r < 2**31 for r in got)
    assert jobs.random_state(5, 3) == jobs.random_state(5, 3)
