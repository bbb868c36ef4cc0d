"""Tensor operations and the port's hand-written kernels."""
