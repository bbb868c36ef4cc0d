"""Random-state discipline (counterpart of ``sq_learn_tpu/utils/keys.py``).

The JAX package threads explicit ``jax.random`` keys; the port threads an
explicit :class:`torch.Generator` that lives on the device the draws are
made on. Nothing reads or seeds torch's global generator. The two
frameworks give different numbers from the same seed, so parity tests make
their noise with numpy and hand it to both sides.
"""

import numbers

import numpy as np
import torch


def as_generator(random_state, device):
    """Coerce a ``random_state``-style argument to a generator on ``device``.

    Parameters
    ----------
    random_state : None, int, np.random.RandomState or torch.Generator
        ``None`` seeds from fresh OS entropy; an int seeds deterministically;
        a generator on ``device`` is used as it is, one on another device
        seeds a new generator from its initial seed.
    device : torch.device
    """
    device = torch.device(device)
    if isinstance(random_state, torch.Generator):
        if random_state.device.type == device.type:
            return random_state
        seed = random_state.initial_seed()
    elif random_state is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    elif isinstance(random_state, (int, np.integer)):
        seed = int(random_state)
    elif isinstance(random_state, np.random.RandomState):
        seed = int(random_state.randint(0, 2**31 - 1))
    else:
        raise ValueError(
            f"random_state must be None, an int, a RandomState or a "
            f"torch.Generator; got {type(random_state).__name__}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def gumbel(shape, generator, device):
    """Standard Gumbel noise, ``-log(E)`` with ``E ~ Exp(1)``."""
    noise = torch.empty(shape, dtype=torch.float32, device=device)
    return noise.exponential_(generator=generator).log_().neg_()


def check_random_state(seed):
    """Turn ``seed`` into a numpy ``RandomState`` for host-side index
    bookkeeping (the splitters): None is numpy's global one, an int seeds
    a new one, a ``RandomState`` is used as it is."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(int(seed))
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a RandomState instance")
