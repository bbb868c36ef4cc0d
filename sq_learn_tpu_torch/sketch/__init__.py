"""Spectral statistics of the runtime model (exact part)."""
