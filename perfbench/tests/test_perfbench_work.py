"""The frozen work functions at the cells' shapes, and against the program's
own counts that they were copied from."""

import pytest
import torch

from perfbench import peaks, work
from sq_learn_tpu_torch.ops import kernels


def test_lloyd_at_784():
    nbytes, ops = work.lloyd_step_work(70_000, 784, 10, 10)
    assert nbytes == 226_307_640
    assert ops == 11_579_680_000
    t, bound = work.least_seconds(nbytes, ops, peaks.PEAKS["H100"])
    assert bound == "bytes"
    assert t == pytest.approx(6.7555e-05, rel=1e-4)


def test_lloyd_at_78():
    nbytes, ops = work.lloyd_step_work(2_830_743, 78, 6, 10)
    assert nbytes == 1_132_334_920
    t, bound = work.least_seconds(nbytes, ops, peaks.PEAKS["H100"])
    assert bound == "bytes"
    assert t == pytest.approx(3.3801e-04, rel=1e-4)


def test_argkmin_at_the_split():
    nbytes, ops = work.argkmin_work(10_000, 60_000, 784, 7)
    assert ops == 940_800_000_000
    t, bound = work.least_seconds(nbytes, ops, peaks.PEAKS["H100"])
    assert bound == "operations"
    assert t == pytest.approx(1.9006e-03, rel=1e-4)


@pytest.mark.parametrize("shape", [(70_000, 784, 10, 10),
                                   (2_830_743, 78, 6, 10), (1797, 64, 10, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lloyd_copy_matches_the_program_but_the_noise(shape, dtype):
    n, m, k, R = shape
    item = 2 if dtype == torch.bfloat16 else 4
    assert work.lloyd_step_work(n, m, k, R, item) == \
        kernels.lloyd_step_work(n, m, k, R, dtype, 0.0)
    b, o = kernels.lloyd_step_work(n, m, k, R, dtype, 0.5)
    assert work.lloyd_step_work(n, m, k, R, item) == (b - 4 * R * n * k, o)


@pytest.mark.parametrize("shape", [(10_000, 60_000, 784, 7), (5, 9, 3, 1)])
def test_argkmin_copy_matches_the_program(shape):
    assert work.argkmin_work(*shape) == kernels.argkmin_work(*shape)


def test_peaks_by_card_name():
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["flops"] == 495e12
    assert peaks.peaks_for("cpu") is None
