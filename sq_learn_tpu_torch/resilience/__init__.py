"""Failure-budgeted runtime: fault injection, transfer supervision and
circuit breaking (counterpart of ``sq_learn_tpu/resilience``).

- :mod:`.faults` — deterministic, env-armed (``SQ_FAULTS=<spec>``)
  injectors for transfer failures and stalls, NaN-corrupted tiles,
  mid-pass interrupts, probe timeouts and the shard-store reads
  (:mod:`sq_learn_tpu_torch.oocore`); the elastic-mesh kinds parse and
  wait for their plane.
- :mod:`.supervisor` — bounded retries, keyed backoff and per-tile
  deadlines around every streamed tile's upload (:func:`~.supervisor.put`)
  and every shard read (:func:`~.supervisor.supervised_read`), and the
  probe-fed circuit breaker. An open breaker raises
  :class:`~.supervisor.BreakerOpenError`; nothing moves to the CPU.
- Resumable streamed passes live in :mod:`sq_learn_tpu_torch.streaming`
  (``SQ_STREAM_CKPT_DIR``), their files in
  :mod:`sq_learn_tpu_torch.utils.checkpoint`.

Quickstart::

    from sq_learn_tpu_torch import resilience

    resilience.faults.arm("put_fail:tiles=2,times=1")   # or SQ_FAULTS=...
    ... a streamed fit recovers through the supervisor's retries ...
    resilience.faults.disarm()
    print(resilience.breaker.state())

The plane's contract smoke is ``python -m
sq_learn_tpu_torch.resilience.smoke`` (``--device {cuda,cpu}``, the card
by default).
"""

from . import faults, supervisor
from .faults import (FaultSpecError, InjectedFault, InjectedInterrupt,
                     InjectedReadError, InjectedTransferError)
from .supervisor import (BreakerOpenError, NonFiniteAccumulatorError,
                         breaker)

__all__ = [
    "BreakerOpenError",
    "FaultSpecError",
    "InjectedFault",
    "InjectedInterrupt",
    "InjectedReadError",
    "InjectedTransferError",
    "NonFiniteAccumulatorError",
    "breaker",
    "faults",
    "supervisor",
]
