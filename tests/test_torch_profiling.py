"""The port's profiling utilities (``sq_learn_tpu_torch.utils.profiling``)
against the JAX package's (``sq_learn_tpu.utils.profiling``), on the CPU.

- The FLOP formulas, the host-CPU peak (with and without
  ``SQ_CPU_PEAK_FLOPS``) and a CPU ``mfu`` equal the JAX functions' on the
  same inputs, exactly.
- The H100 table resolves by card name for every ``math``,
  ``SQ_GPU_PEAK_FLOPS`` overrides its ``fp32`` rate only, and an unknown card returns None
  with an ``unknown_chip`` gauge (a stand-in device, as
  ``tests/test_obs.py`` does for the JAX package).
- ``obs.snapshot()["measured_mfu"]`` equals the JAX summary's field for
  the same ``profiling.mfu`` gauge, and both are None without one.
- ``Timer`` spans and ``benchmark`` gauges carry the JAX package's names;
  ``Timer`` waits only for cards, and ``trace`` writes a loadable Chrome
  trace under a ``utils.trace`` span.
"""

import json

import numpy as np
import pytest
import torch

from sq_learn_tpu import obs as jax_obs
from sq_learn_tpu.utils import profiling as jax_profiling
from sq_learn_tpu_torch import config_context, obs
from sq_learn_tpu_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"


class _Card:
    """A stand-in CUDA device: the port resolves a card by its name."""

    type = "cuda"

    def __init__(self, name):
        self.name = name


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for name in ("SQ_CPU_PEAK_FLOPS", "SQ_GPU_PEAK_FLOPS",
                 "SQ_TPU_PEAK_FLOPS"):
        monkeypatch.delenv(name, raising=False)
    with config_context(device="cpu"):
        yield
    obs.disable()
    jax_obs.disable()


@pytest.mark.parametrize("shape", [(1, 1, 1), (70_000, 784, 10),
                                   (10_000, 784, 60_000), (3, 5, 7)])
def test_flop_formulas_equal_jax(shape):
    assert profiling.matmul_flops(*shape) == jax_profiling.matmul_flops(
        *shape)
    assert profiling.lloyd_iter_flops(*shape) == \
        jax_profiling.lloyd_iter_flops(*shape)


def test_slice_shapes_flops():
    # 10 restarts of the Lloyd step at the slice shape, and the k-NN
    # search's products: the numerators chip_smoke.py's profiling phase
    # divides by its medians
    assert 10 * profiling.lloyd_iter_flops(70_000, 784, 10) == 2.1952e10
    assert profiling.matmul_flops(10_000, 784, 60_000) == 9.408e11


@pytest.mark.parametrize("knob", [None, "1.5e12"])
def test_host_cpu_peak_equals_jax(monkeypatch, knob):
    if knob is not None:
        monkeypatch.setenv("SQ_CPU_PEAK_FLOPS", knob)
    assert profiling.host_cpu_peak_flops() == \
        jax_profiling.host_cpu_peak_flops()
    if knob is not None:
        assert profiling.host_cpu_peak_flops() == 1.5e12
    assert profiling.device_peak_flops() == profiling.host_cpu_peak_flops()
    assert profiling.device_peak_flops("cpu", math="bf16") == \
        profiling.host_cpu_peak_flops()


@pytest.mark.parametrize("knob", [None, "2e11"])
def test_cpu_mfu_equals_jax(monkeypatch, knob):
    if knob is not None:
        monkeypatch.setenv("SQ_CPU_PEAK_FLOPS", knob)
    rec, jrec = obs.enable(), jax_obs.enable()
    for flops, seconds in ((1e9, 1.0), (3.7e10, 0.0123), (5.0, 7.0)):
        ours = profiling.mfu(flops, seconds)
        theirs = jax_profiling.mfu(flops, seconds)
        assert isinstance(ours, float) and np.isfinite(ours) and ours > 0
        assert ours == theirs
    ev = [e for e in rec.gauge_events if e["name"] == "profiling.mfu"][-1]
    jev = [e for e in jrec.gauge_events if e["name"] == "profiling.mfu"][-1]
    assert ev["value"] == jev["value"]
    assert ev["attrs"] == dict(jev["attrs"], math="fp32")
    assert ev["attrs"]["cpu_estimate"] is True


@pytest.mark.parametrize("math,peak", [
    ("fp32", 67e12), ("tf32", 495e12), ("bf16", 989e12), ("fp16", 989e12),
    ("fp8", 1979e12), ("int8", 1979e12)])
def test_h100_table_by_name(math, peak):
    assert profiling.device_peak_flops(_Card(H100), math) == peak
    assert profiling.GPU_PEAKS[H100] is profiling.H100_SXM_PEAK_FLOPS
    assert profiling.H100_SXM_HBM_BYTES_PER_S == 3.35e12
    rec = obs.enable()
    assert profiling.mfu(peak * 0.25, 0.5, device=_Card(H100),
                         math=math) == 0.5
    assert rec.gauge_events[-1]["attrs"] == {"math": math}
    assert obs.snapshot()["measured_mfu"] == 0.5


def test_gpu_override_and_unknown_card(monkeypatch):
    assert profiling.device_peak_flops(_Card("NVIDIA H100 PCIe")) is None
    assert "NVIDIA H100 PCIe" not in profiling.GPU_PEAKS
    monkeypatch.setenv("SQ_GPU_PEAK_FLOPS", "1e14")
    # the override is the fp32 rate; the tensor-core maths keep the table's
    assert profiling.device_peak_flops(_Card("NVIDIA H100 PCIe")) == 1e14
    assert profiling.device_peak_flops(_Card(H100), "fp32") == 1e14
    for math in profiling.MATH[1:]:
        assert profiling.device_peak_flops(_Card("NVIDIA H100 PCIe"),
                                           math) is None
        assert profiling.device_peak_flops(_Card(H100), math) == \
            profiling.H100_SXM_PEAK_FLOPS[math]
    # the card's override leaves the host estimate alone
    assert profiling.device_peak_flops("cpu") == \
        profiling.host_cpu_peak_flops()


def test_unknown_card_degrades_gracefully(monkeypatch):
    rec = obs.enable()
    assert profiling.mfu(1e12, 1.0, device=_Card("NVIDIA B9000")) is None
    ev = rec.gauge_events[-1]
    assert ev["name"] == "profiling.mfu" and ev["value"] is None
    assert ev["attrs"] == {"unknown_chip": True,
                           "device_kind": "NVIDIA B9000",
                           "reason": "unknown_chip", "math": "fp32"}
    assert profiling.mfu(1e12, 0.0, device=_Card(H100)) is None
    assert rec.gauge_events[-1]["attrs"]["reason"] == "nonpositive_seconds"
    assert obs.snapshot()["measured_mfu"] is None
    # a card this process cannot see resolves to no peak either
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_peak_flops(torch.device("cuda:0")) is None
    assert profiling.mfu(1e12, 1.0, device="cuda") is None
    assert rec.gauge_events[-1]["attrs"]["device_kind"] == "unknown"


def test_unknown_math_raises():
    with pytest.raises(ValueError, match="math"):
        profiling.device_peak_flops(_Card(H100), math="fp64")
    with pytest.raises(ValueError, match="math"):
        profiling.mfu(1.0, 1.0, math="tf16")


@pytest.mark.parametrize("value", [0.123456789, 0.5, 1, None])
def test_measured_mfu_equals_jax_summary(value):
    obs.enable()
    jax_obs.enable()
    assert obs.snapshot()["measured_mfu"] is None
    assert jax_obs.snapshot()["measured_mfu"] is None
    obs.gauge("profiling.mfu", value)
    jax_obs.gauge("profiling.mfu", value)
    ours = obs.snapshot()["measured_mfu"]
    assert ours == jax_obs.snapshot()["measured_mfu"]
    assert ours == (None if value is None else round(float(value), 6))


def test_timer_span_and_benchmark_gauges_match_jax():
    import jax
    import jax.numpy as jnp

    rec, jrec = obs.enable(), jax_obs.enable()
    with profiling.Timer(name="unit.timer") as t:
        torch.ones(8).sum()
    with jax_profiling.Timer(name="unit.timer") as jt:
        jnp.ones((8,)).block_until_ready()
    assert t.elapsed is not None and t.elapsed >= 0 and jt.elapsed >= 0
    assert [s["name"] for s in rec.spans] == [s["name"]
                                              for s in jrec.spans]
    with profiling.Timer():
        pass
    assert rec.spans[-1]["name"] == "utils.Timer"

    def triple(x):
        return x * 3

    median, times = profiling.benchmark(triple, torch.ones(16), repeats=3,
                                        warmup=2)
    profiling.benchmark(triple, torch.ones(16), repeats=3, name="named")
    jax_profiling.benchmark(jax.jit(triple), jnp.ones((16,)), repeats=3,
                            warmup=2, name="triple")
    jax_profiling.benchmark(jax.jit(triple), jnp.ones((16,)), repeats=3,
                            name="named")
    assert len(times) == 3 and median == sorted(times)[1]
    assert set(rec.gauges) == set(jrec.gauges) == {
        "benchmark.triple.warmup_s", "benchmark.triple.median_s",
        "benchmark.named.warmup_s", "benchmark.named.median_s"}
    ours = {e["name"]: e["attrs"] for e in rec.gauge_events}
    theirs = {e["name"]: e["attrs"] for e in jrec.gauge_events}
    assert ours == theirs


def test_benchmark_without_obs_records_nothing():
    median, times = profiling.benchmark(lambda: torch.zeros(3), repeats=2)
    assert len(times) == 2 and median >= 0
    assert obs.snapshot() is None


def test_timer_waits_only_for_cards(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    with profiling.Timer(sync=torch.ones(2)):
        pass
    with profiling.Timer(sync="cpu"):
        pass
    profiling.benchmark(lambda: torch.ones(2), repeats=2)
    if not torch.cuda.is_initialized():
        with profiling.Timer():
            pass
    assert calls == []
    with profiling.Timer(sync="cuda:1"):
        pass
    assert calls == [torch.device("cuda:1")]


def test_timer_default_waits_for_every_card_in_use(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda i: 2 << 20 if i == 3 else 0)
    with profiling.Timer():
        pass
    assert calls == [1, 3]


def test_trace_writes_a_chrome_trace(tmp_path):
    rec = obs.enable()
    with profiling.trace(str(tmp_path / "tr")) as handle:
        a = torch.ones((64, 64))
        (a @ a).sum()
    assert handle.path is not None and handle.path.startswith(
        str(tmp_path / "tr"))
    with open(handle.path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    spans = [s for s in rec.spans if s["name"] == "utils.trace"]
    assert len(spans) == 1
    assert spans[0]["attrs"]["log_dir"] == str(tmp_path / "tr")
