"""Rule registry: one module per rule, all instantiable with no args
(counterpart of ``sq_learn_tpu/analysis/rules/__init__.py``).

Adding a rule = write a :class:`~sq_learn_tpu_torch.analysis.core.Rule`
subclass in a new module here, append it to ``ALL_RULES`` and give it a
bad fixture in :mod:`sq_learn_tpu_torch.analysis.selftest`.

The JAX package's sixth rule, ``jit-purity``, has no object here: the
port compiles nothing, so no function body is traced. Asking for it by
name raises a ``KeyError`` that says so.
"""

from .knobs import KnobRegistryRule
from .rng import RngDisciplineRule
from .locks import LockDisciplineRule
from .obsschema import ObsSchemaRule
from .estimator import EstimatorContractRule

ALL_RULES = (
    KnobRegistryRule,
    RngDisciplineRule,
    LockDisciplineRule,
    ObsSchemaRule,
    EstimatorContractRule,
)

#: the JAX package's rules that have no object in the port, and why
NOT_PORTED = {
    "jit-purity": ("the port compiles nothing (eager torch and "
                   "hand-written CUDA kernels), so there is no traced "
                   "function body to keep pure"),
}

__all__ = ["ALL_RULES", "NOT_PORTED", "get_rules"] + [
    r.__name__ for r in ALL_RULES]


def get_rules(names=None):
    """Fresh rule instances (all, or the named subset)."""
    by_name = {r.name: r for r in ALL_RULES}
    if names is None:
        return [r() for r in ALL_RULES]
    for n in names:
        if n in NOT_PORTED:
            raise KeyError(f"rule {n!r} is not ported: {NOT_PORTED[n]}")
    unknown = sorted(set(names) - set(by_name))
    if unknown:
        raise KeyError(f"unknown rules {unknown}; "
                       f"known: {sorted(by_name)}")
    return [by_name[n]() for n in names]
