"""Quantum register simulation (counterpart of
``sq_learn_tpu/ops/quantum/state.py``).

The reference's ``QuantumState`` (``Utility.py:25-58``): registers and
L2-normalized amplitudes, measured by sampling register indices with
probability amplitude². Draws take an explicit ``torch.Generator``, and
large-N measurement returns multinomial counts instead of materialized
draws.
"""

import numpy as np
import torch

from .sampling import estimate_wald, multinomial_counts


class QuantumState:
    """A minimal simulated quantum register.

    Parameters
    ----------
    registers : tensor or array of shape (d,) or (d, ...), or a list
        Values (or vectors) attached to each basis state.
    amplitudes : tensor or array of shape (d,)
        Amplitudes; normalized internally so probabilities sum to 1.
    """

    def __init__(self, registers, amplitudes):
        amplitudes = torch.as_tensor(amplitudes)
        if not amplitudes.is_floating_point():
            amplitudes = amplitudes.to(torch.float32)
        if amplitudes.ndim != 1:
            raise ValueError("amplitudes must be 1-D")
        self.norm_factor = torch.linalg.norm(amplitudes)
        self.amplitudes = amplitudes / self.norm_factor
        self.probabilities = self.amplitudes**2
        self.registers = (torch.as_tensor(registers)
                          if not isinstance(registers, list) else registers)
        n_reg = (len(self.registers) if isinstance(self.registers, list)
                 else self.registers.shape[0])
        if n_reg != amplitudes.shape[0]:
            raise ValueError("registers and amplitudes must have the same length")
        # the reference asserts Σp == 1 (Utility.py:49); after a float32
        # norm and divide the sum is 1 only to a few ulp
        np.testing.assert_allclose(
            float(torch.sum(self.probabilities)), 1.0, atol=1e-5)

    def measure_indices(self, generator, n_times=1):
        """Sample ``n_times`` basis-state indices."""
        return torch.multinomial(self.probabilities.to(generator.device),
                                 int(n_times), replacement=True,
                                 generator=generator)

    def measure(self, generator, n_times=1):
        """Sample ``n_times`` register values (reference ``measure``, :51)."""
        idx = self.measure_indices(generator, n_times)
        if isinstance(self.registers, list):
            return [self.registers[int(i)] for i in idx.tolist()]
        return self.registers[idx.to(self.registers.device)]

    def measure_counts(self, generator, n_times):
        """Outcome counts of ``n_times`` measurements — O(d) memory
        regardless of N (never materializes draws)."""
        return multinomial_counts(generator, n_times,
                                  self.probabilities.to(generator.device))

    def measure_frequencies(self, generator, n_times):
        """Wald frequency estimates per basis state."""
        return estimate_wald(self.measure_counts(generator, n_times), n_times)

    def get_state(self):
        """Dict {register: probability} (reference ``get_state``, :57)."""
        probs = self.probabilities.cpu().numpy()
        if isinstance(self.registers, list):
            return {_hashable(r): float(probs[i])
                    for i, r in enumerate(self.registers)}
        regs = self.registers.cpu().numpy()
        return {_hashable(regs[i]): float(probs[i]) for i in range(len(probs))}


def _hashable(value):
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr.item()
    return tuple(arr.ravel().tolist())


def coupon_collect(generator, quantum_state, max_draws=1_000_000):
    """Number of measurements until every basis state has been observed
    (reference ``coupon_collect``, ``Utility.py:75-85``).

    The draws are made in chunks; the count is the position of the draw
    that completes the set, so it has the distribution of drawing one at a
    time (capped at ``max_draws``, as the JAX loop is). One host fetch per
    chunk.
    """
    probs = quantum_state.probabilities.to(generator.device)
    d = probs.shape[0]
    chunk = max(1024, 4 * d)
    seen = torch.zeros(d, dtype=torch.bool, device=probs.device)
    first = torch.full((d,), -1, dtype=torch.int64, device=probs.device)
    drawn = 0
    while drawn < max_draws:
        size = min(chunk, max_draws - drawn)
        idx = torch.multinomial(probs, size, replacement=True,
                                generator=generator)
        pos = torch.arange(drawn, drawn + size, device=probs.device)
        # first position of each state in this chunk (size if absent)
        firsts = torch.full((d,), drawn + size, dtype=torch.int64,
                            device=probs.device)
        firsts.scatter_reduce_(0, idx, pos, reduce="amin")
        new = ~seen & (firsts < drawn + size)
        first = torch.where(new, firsts, first)
        seen |= new
        drawn += size
        if bool(seen[probs > 0].all()):
            if bool(seen.all()):
                return int(first.max()) + 1
            return max_draws
    return max_draws
