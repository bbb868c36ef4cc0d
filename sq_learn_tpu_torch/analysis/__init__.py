"""sqcheck over the port — the project's static invariant checker
(counterpart of ``sq_learn_tpu/analysis/``).

The port's code-level contracts (registry-gated env knobs, draws from an
explicit ``torch.Generator``, lock-guarded state shared between threads,
one obs schema, the sklearn estimator contract) are enforced here as
AST-level rules. Run it as ``python -m sq_learn_tpu_torch.analysis``; it
lints ``sq_learn_tpu_torch/`` by default against the committed
``baseline.json``.

The package is dependency-free (stdlib ``ast`` only), imports nothing of
the JAX package, and never imports the code it analyzes — rules that
need project metadata (the knob registry, ``obs.schema.RECORD_TYPES``)
parse it out of the source statically, so the checker also works on
fixture trees in tests.
"""

from .core import Finding, Rule, AnalysisContext, load_baseline, run
from .rules import ALL_RULES, NOT_PORTED, get_rules

__all__ = [
    "ALL_RULES",
    "AnalysisContext",
    "Finding",
    "NOT_PORTED",
    "Rule",
    "get_rules",
    "load_baseline",
    "run",
]
