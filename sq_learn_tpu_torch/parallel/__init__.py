"""Batched initialization kernels (single device)."""
