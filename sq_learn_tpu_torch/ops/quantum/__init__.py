"""Quantum-routine library (the μ(A) norms so far)."""
