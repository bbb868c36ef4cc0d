"""The plain reference: plain PyTorch, independent of the program.

``judge`` holds the float64 comparisons that decide ``correct``; ``qkmeans``
and ``knn`` are plain versions of the two timed jobs, which the control
runs in the program's place with its products in TF32 (:func:`round_tf32`).
Nothing here imports the program or JAX.
"""

import torch


def round_tf32(t):
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties to even: what the tensor cores do to a float32 operand before a
    TF32 product. Products of rounded operands accumulated in float32 are
    TF32 products, on any device."""
    b = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(b, 13), 1)
    b = torch.bitwise_and(b + (0x0FFF + lsb), ~0x1FFF)
    return b.view(torch.float32)


def no_rounding(t):
    return t
