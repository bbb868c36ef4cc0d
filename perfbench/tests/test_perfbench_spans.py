"""The program ranges' reading (``spans.py``) on a hand-made list of
profiler events: nested ranges, a device interval straddling a range's
edge, a range with no device work; the existing summary's keys are not
moved by the program's ranges; and the four readings, with nothing when
the program opened no range."""

import pytest
import torch
from test_perfbench_trace import Event

from perfbench import spans, trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _events():
    return [
        Event(trace.WINDOW, CPU, 0, 1000),
        Event("qkmeans.lloyd_iter", CPU, 100, 500),
        Event("perfbench.lloyd_step", CPU, 140, 260),
        Event("kernels.lloyd_step", CPU, 150, 250),
        Event("cudaLaunchKernel", CPU, 160, 170, corr=1),
        Event("qkmeans.update", CPU, 300, 450),
        Event("aten::where", CPU, 305, 330),
        Event("cudaLaunchKernel", CPU, 310, 320, corr=2),
        Event("qkmeans.lloyd_iter", CPU, 600, 900),       # no device work
        Event("sync.qkmeans.stop_rule", CPU, 920, 980),
        Event("lloyd_score", CUDA, 200, 400, corr=1),     # past its range
        Event("where_kernel", CUDA, 480, 520, corr=2),    # past the step
    ]


def test_the_program_ranges_wall_self_idle_and_device_time():
    got = spans.summarize_program(_events())
    r = got["ranges"]
    assert set(r) == {"qkmeans.lloyd_iter", "kernels.lloyd_step",
                      "qkmeans.update", "sync.qkmeans.stop_rule"}
    step = r["qkmeans.lloyd_iter"]
    assert step["calls"] == 2
    assert step["wall_s"] == pytest.approx(700e-9)
    # less the kernel entry's 100 and the update's 150 in the first step
    assert step["self_s"] == pytest.approx(450e-9)
    # busy 200–400 and 480–500 in the first step, nothing in the second
    assert step["idle_s"] == pytest.approx((180 + 300) * 1e-9)
    assert step["self_idle_s"] == pytest.approx((80 + 300) * 1e-9)
    # both launches lie in the first step: their device time whole
    assert step["device_s"] == pytest.approx(240e-9)
    kernel = r["kernels.lloyd_step"]
    assert kernel["idle_s"] == pytest.approx(50e-9)
    assert kernel["device_s"] == pytest.approx(200e-9)
    assert r["qkmeans.update"]["idle_s"] == pytest.approx(50e-9)
    assert r["qkmeans.update"]["device_s"] == pytest.approx(40e-9)
    assert r["sync.qkmeans.stop_rule"]["idle_s"] == pytest.approx(60e-9)
    assert r["sync.qkmeans.stop_rule"]["device_s"] == 0
    assert got["idle_s"] == pytest.approx(760e-9)
    assert got["idle_in_ranges_s"] == pytest.approx(540e-9)
    assert got["idle_in_ranges_share"] == pytest.approx(540 / 760)


def test_the_devices_reading_is_not_moved_by_the_programs_ranges():
    with_ranges = trace.summarize(_events())
    without = trace.summarize([e for e in _events()
                               if not spans._is_program(e.name())])
    for key in ("busy_s", "window_s", "range_device_s", "range_calls",
                "device_ops", "device_events"):
        assert with_ranges[key] == without[key], key
    assert with_ranges["range_device_s"] == {
        "perfbench.lloyd_step": pytest.approx(200e-9)}


def test_the_readings():
    program = spans.summarize_program(_events())
    got = spans.readings(program, "fit", 1)
    assert got["lloyd_gap_ms"]["value"] == pytest.approx(1e3 * 240e-9)
    assert "kernels.lloyd_step" in got["lloyd_gap_ms"]["note"]
    assert got["host_waits.fit"]["value"] == 1
    assert "init_ms.fit" not in got
    assert spans.readings(program, "predict", 1) == {}


def test_the_readings_of_a_predict_and_an_init():
    events = [
        Event(trace.WINDOW, CPU, 0, 1000),
        Event("knn.predict", CPU, 0, 400),
        Event("knn.validate", CPU, 10, 60),
        Event("knn.search", CPU, 60, 100),
        Event("knn.predict", CPU, 500, 700),
        Event("qkmeans.fused_init", CPU, 800, 900),
        Event("qkmeans.stats", CPU, 800, 850),
        Event("qkmeans.seed", CPU, 850, 900),
        Event("cudaLaunchKernel", CPU, 70, 80, corr=3),
        Event("argkmin_short", CUDA, 100, 300, corr=3),
    ]
    program = spans.summarize_program(events)
    got = spans.readings(program, "predict", 2)
    assert got["predict_gap_ms"]["value"] == pytest.approx(
        1e3 * (200 + 200) * 1e-9 / 2)
    init = spans.readings(program, "fit", 1)["init_ms.fit"]
    assert init["value"] == pytest.approx(1e3 * 100e-9)
    assert "stats 5e-05 ms" in init["note"]


def test_nothing_to_read_without_program_ranges():
    events = [e for e in _events() if not spans._is_program(e.name())]
    program = spans.summarize_program(events)
    assert program["ranges"] == {}
    assert program["idle_in_ranges_s"] == 0
    for kind in ("fit", "predict"):
        assert spans.readings(program, kind, 3) == {}
    assert spans.readings(None, "fit", 3) == {}
