"""Quantum-runtime ledger: theoretical query counts next to measured time
(counterpart of ``sq_learn_tpu/obs/ledger.py``).

Every quantum step of a run records (a) its theoretical quantum query and
sample counts (tomography shots, phase-estimation spectrum queries,
amplitude-estimation calls, cost-model evaluations), (b) the ε/δ budgets
that priced them and (c) the measured wall clock of the classical
simulation of the same step. One run's entries state the paper's
trade-off.

Accounting conventions (the JAX package's, pinned by the tests):

- **Tomography shots** (:func:`tomography_shot_count`): Algorithm 4.1
  measures a d-dimensional state N = 36·d·ln d/δ² times for magnitudes
  and N more times for signs, so one vector costs 2·N shots and r rows
  2·N·r. The ``'inf'`` norm drops the factor d from N. The Gaussian fast
  path simulates the same estimator at the same δ, so its theoretical
  count is the same.
- **A zero budget records zero queries**: δ=0/ε=0 is the exact classical
  computation, and the entry says so (``short_circuit: true``).
- **Phase estimation**: one consistent-PE pass over s singular values
  counts s spectrum queries; a search of n iterations counts n·s (an
  upper bound for searches that stop early, flagged ``upper_bound``).

Classical estimators (TruncatedSVD, k-NN) record entries with empty query
dicts: the classical wall clock the quantum counts are traded against.
"""

import time

from . import recorder


def tomography_shot_count(n_vectors, d, delta, norm="L2"):
    """Theoretical measurement count of tomography on ``n_vectors`` states
    of dimension ``d`` at error ``delta``: 2·N·n_vectors with N from
    :func:`~sq_learn_tpu_torch.ops.quantum.tomography.tomography_n_measurements`
    (reference ``Utility.py:307-311``). δ=0 is the exact classical
    short-circuit — zero quantum measurements."""
    if float(delta) == 0.0 or n_vectors <= 0:
        return 0
    from ..ops.quantum.tomography import tomography_n_measurements

    return 2 * tomography_n_measurements(int(d), float(delta), norm) \
        * int(n_vectors)


def phase_estimation_queries(n_values, n_iterations=1):
    """Consistent-PE spectrum queries: ``n_values`` per pass over the
    spectrum, ``n_iterations`` passes (1 for a single batched estimate)."""
    return int(n_values) * int(n_iterations)


def record(estimator, step, wall_s=None, queries=None, budget=None, **attrs):
    """Append one ledger entry (and its JSONL line) to the active run.

    ``queries``: dict of theoretical quantum query counts (numbers).
    ``budget``: dict of the error budgets that priced them (ε, δ, η...).
    No-op when observability is disabled.
    """
    rec = recorder.get_recorder()
    if rec is None:
        return
    entry = {"type": "ledger", "estimator": estimator, "step": step,
             "queries": {k: float(v) for k, v in (queries or {}).items()},
             "budget": {k: float(v) for k, v in (budget or {}).items()}}
    if wall_s is not None:
        entry["wall_s"] = round(float(wall_s), 6)
    if attrs:
        entry["attrs"] = recorder._jsonable(attrs)
    rec.record(entry, kind="ledger_entries")


def entries():
    """The active run's ledger entries (empty when disabled)."""
    rec = recorder.get_recorder()
    return list(rec.ledger_entries) if rec is not None else []


def totals():
    """Query counts summed per key and the wall clock summed over the
    run's entries."""
    agg = {}
    wall = 0.0
    for e in entries():
        for k, v in e["queries"].items():
            agg[k] = agg.get(k, 0.0) + v
        wall += e.get("wall_s", 0.0)
    return {"queries": agg, "wall_s": round(wall, 6)}


class timed_step:
    """Context manager pairing a ledger entry with the measured wall clock
    of its scope::

        with obs.ledger.timed_step("qpca", "topk_extract",
                                   queries={...}, budget={...}):
            <classical simulation of the quantum step>

    Queries and budget may also be filled in mid-scope with
    ``.set_queries`` / ``.set_budget`` (counts that depend on a
    data-dependent selection). Records nothing when observability is
    disabled, or when the scope raises.
    """

    def __init__(self, estimator, step, queries=None, budget=None, **attrs):
        self.estimator = estimator
        self.step = step
        self.queries = dict(queries or {})
        self.budget = dict(budget or {})
        self.attrs = attrs

    def set_queries(self, **queries):
        self.queries.update(queries)
        return self

    def set_budget(self, **budget):
        self.budget.update(budget)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            record(self.estimator, self.step,
                   wall_s=time.perf_counter() - self._t0,
                   queries=self.queries, budget=self.budget, **self.attrs)
        return False
