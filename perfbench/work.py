"""The operations and bytes each kernel's work needs, frozen here so that a
later change to the program cannot move the yardstick.

Copies of ``lloyd_step_work`` and ``argkmin_work`` of
``sq_learn_tpu_torch/ops/kernels.py``: every input read once and every
output written once. One departure: the Lloyd count leaves out the
δ-window's Gumbel noise operand (4·R·n·k bytes), which an implementation
may draw where it uses it instead of reading it.
"""


def lloyd_step_work(n, m, k, R, x_itemsize=4):
    """(bytes, operations) of one fused Lloyd step over R restarts: X, the
    weights and row norms and the centers read once; labels, distances,
    per-cluster sums, counts and inertia written once; 2·n·m·k·R
    distance-product operations, n·m multiplies w·x and n·m·R adds for the
    weighted sums."""
    inputs = n * m * x_itemsize + 8 * n + 4 * R * k * m
    outputs = 8 * R * n + 4 * R * k * m + 4 * R * k + 4 * R
    return inputs + outputs, 2 * n * m * k * R + n * m * R + n * m


def argkmin_work(nq, nt, m, k):
    """(bytes, operations) of one k-nearest search: the train rows, their
    norms and the queries read once, the (nq, k) indices and distances
    written once; 2·nq·nt·m operations for the score products."""
    return 4 * (nt * m + nt + nq * m) + 8 * nq * k, 2 * nq * nt * m


def least_seconds(nbytes, ops, peaks):
    """(seconds, bound): the least time the card needs for the work, the
    larger of operations over the peak rate and bytes over the peak
    bandwidth, and which of the two binds ("operations" or "bytes")."""
    t_ops = ops / peaks["flops"]
    t_bytes = nbytes / peaks["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
