"""Published dense peaks of the cards the benchmark knows, keyed by a part
of the name ``torch.cuda.get_device_name()`` gives.

Shares of a peak are priced against the highest rate the card offers for
products of float32 inputs, TF32 on the tensor cores, so that a
float32-accurate tensor-core kernel (3xTF32) still reads under 100 %.
"""

#: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    "H100": {"flops": 495e12, "bytes_per_s": 3.35e12,
             "source": "NVIDIA H100 SXM data sheet: 495 TFLOP/s TF32 "
                       "tensor core (dense), 3.35 TB/s HBM3"},
}


def peaks_for(kind):
    """The peaks of the card named ``kind``, or None for a card the table
    does not hold (the shares of a peak are then not reported)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
