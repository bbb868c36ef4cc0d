"""The environment variables ``obs`` reads, under the JAX package's rules
(its ``_knobs`` registry, which the port does not copy): a flag whose
default is off turns on only at ``"1"``."""

import os


def flag(name):
    """True when the default-off flag ``name`` is set to ``"1"``."""
    return os.environ.get(name) == "1"


def raw(name, default=None):
    """The raw string value of ``name``, or ``default`` when unset."""
    return os.environ.get(name, default)
