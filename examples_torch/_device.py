"""Shared plumbing of the port's drivers (the counterpart of
``examples/_common.py``).

It puts the repository's root on ``sys.path``, gives a driver's parser
``--device`` and runs the driver under that device. There is no backend
probe and no CPU fallback: without CUDA a driver raises unless it is
given ``--device cpu``, and a card that fails fails the run.

The module is not named ``_common``: in one process the JAX drivers'
bare ``import _common`` and this one must not meet in ``sys.modules``.
"""

import contextlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def add_device_argument(ap):
    """Give the parser ``--device {cuda,cpu}`` (default: the configured
    device, which is the card unless the caller set another)."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to compute (default: the configured "
                         "device, the card)")
    return ap


@contextlib.contextmanager
def on_device(name):
    """Run the body with ``name`` (or, for None, the configured device)
    as the configured device. The device is resolved first, so that a
    missing card raises before any work. Yields the ``torch.device``."""
    import sq_learn_tpu_torch as sqt

    device = sqt.resolve_device(name)
    with sqt.config_context(device=str(device)):
        yield device


def synchronize(device):
    """Wait for the work queued on ``device`` (a no-op on the CPU), so
    that a host clock read after it times the work, not its launch."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
