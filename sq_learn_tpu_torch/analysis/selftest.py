"""Lint selftest — every rule still fires on a deliberately-broken
fixture and stays quiet on its good twin (counterpart of
``sq_learn_tpu/analysis/selftest.py``).

A checker whose rules silently stopped matching is worse than no
checker, so ``python -m sq_learn_tpu_torch.analysis --selftest`` proves
each rule red-on-bad and green-on-good before a clean lint is trusted.
The fixtures of the four rules the port shares with the JAX package
(``knob-registry``, ``lock-discipline``, ``obs-schema``,
``estimator-contract``) are the JAX package's, verbatim; the
``rng-discipline`` fixture is torch's.

Fixtures are written to a temp tree and analyzed through the same
:func:`sq_learn_tpu_torch.analysis.core.run` entry the CLI uses —
baseline semantics excluded (covered by
``tests/test_torch_analysis.py``).
"""

import os
import tempfile

from .core import run
from .rules import get_rules

#: minimal registry fixture (same `_K(...)` shape the real one uses)
_KNOBS_FIXTURE = '''
def _K(name, kind, default, scope, doc, anchor):
    return (name, kind, default, scope, doc, anchor)

_ENTRIES = [
    _K("SQ_GOOD", "int", 3, "lib", "a used knob", None),
    _K("SQ_DEAD", "int", 0, "lib", "a never-read knob", None),
]
'''

_SCHEMA_FIXTURE = '''
RECORD_TYPES = ("counter", "ghost")
'''

#: rule -> (bad fixture, expected message fragments, good fixture)
FIXTURES = {
    "knob-registry": (
        '''
import os
from . import _knobs

def bad():
    a = os.environ.get("SQ_RAW")
    b = _knobs.get_int("SQ_NOT_REGISTERED")
    return a, b
''',
        ["raw environment read", "not in the _knobs registry",
         "'SQ_DEAD' is registered but never read"],
        '''
from . import _knobs

def good():
    return _knobs.get_int("SQ_GOOD")
''',
    ),
    "rng-discipline": (
        '''
import numpy as np
import torch
from torch import randperm

def draw(n, x):
    rng = np.random.default_rng()
    np.random.seed(0)
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    u = torch.rand((n,), dtype=torch.float64)
    p = randperm(n)
    x.exponential_()
    return rng, u, p, x
''',
        ["unseeded np.random.default_rng()",
         "np.random.seed(...) uses the module-global RNG",
         "torch.manual_seed(...) touches torch's global seed",
         "torch.cuda.manual_seed_all(...) touches torch's global seed",
         "torch.rand(...) draws from torch's default generator",
         "torch.randperm(...) draws from torch's default generator",
         ".exponential_(...) draws from torch's default generator"],
        '''
import numpy as np
import torch
from torch import randperm

def draw(n, x, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.Generator()
    g.manual_seed(seed)
    u = torch.rand((n,), dtype=torch.float64, generator=g)
    p = randperm(n, generator=g)
    x.exponential_(generator=g)
    return rng, u, p, x
''',
    ),
    "lock-discipline": (
        '''
import threading

class Pool:
    _GUARDED_BY = {"_lock": ("_count", "_closed")}

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._closed = False

    def bump(self):
        self._count += 1

    def close(self):
        with self._lock:
            self._count = 0
        self._closed = True
''',
        ["Pool.bump() writes guarded attribute self._count",
         "Pool.close() writes guarded attribute self._closed"],
        '''
import threading

class Pool:
    _GUARDED_BY = {"_lock": ("_count", "_closed")}
    _ASSUMES_LOCK = ("_reset",)

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._closed = False

    def bump(self):
        with self._lock:
            self._count += 1

    def _reset(self):
        self._count = 0

    def _drain_locked(self):
        self._count = 0

    def close(self):
        with self._lock:
            self._reset()
            self._closed = True
''',
    ),
    "obs-schema": (
        '''
def counter_add(name, delta):
    pass

def emit(rec):
    rec.record({"type": "bogus", "name": "x"})
    for i in range(10):
        counter_add("hot.loop", 1)
''',
        ["record type 'bogus' is not declared",
         "per-item counter_add() inside a loop",
         "record type 'ghost' is never constructed"],
        '''
def counter_add(name, delta):
    pass

def emit(rec):
    rec.record({"type": "counter", "name": "x"})
    rec.record({"type": "ghost"})
    total = 0
    for i in range(10):
        total += 1
    counter_add("hot.loop", total)
''',
    ),
    "estimator-contract": (
        '''
class BaseEstimator:
    pass

class Broken(BaseEstimator):
    def __init__(self, gamma=1.0, tol=None):
        self.gamma = gamma * 2.0
        self.report = []

    def fit(self, X, y=None):
        self.coef = X.sum(0)
        return (self, self.coef)
''',
        ["must assign hyperparameter 'gamma' verbatim",
         "never assigns hyperparameter 'tol'",
         "assigns non-hyperparameter public attribute 'report'",
         "Broken.fit() must return self",
         "assigns public fitted attribute 'coef' without the trailing "
         "underscore"],
        '''
class BaseEstimator:
    pass

class Clean(BaseEstimator):
    def __init__(self, gamma=1.0, tol=None):
        self.gamma = gamma
        self.tol = tol

    def fit(self, X, y=None):
        self.coef_ = X.sum(0)
        self._scratch = None
        return self
''',
    ),
}


def _write_tree(base, name, body, with_meta):
    tree = os.path.join(base, name)
    pkg = os.path.join(tree, "pkg")
    os.makedirs(os.path.join(pkg, "obs"))
    for d in (pkg, os.path.join(pkg, "obs")):
        with open(os.path.join(d, "__init__.py"), "w") as fh:
            fh.write("")
    if with_meta:
        with open(os.path.join(pkg, "_knobs.py"), "w") as fh:
            fh.write(_KNOBS_FIXTURE)
        with open(os.path.join(pkg, "obs", "schema.py"), "w") as fh:
            fh.write(_SCHEMA_FIXTURE)
    with open(os.path.join(pkg, "mod.py"), "w") as fh:
        fh.write(body)
    return tree


def run_fixture(rule_name, body, base=None):
    """Findings from one rule over one fixture module body."""
    with tempfile.TemporaryDirectory(dir=base) as tmp:
        tree = _write_tree(tmp, rule_name.replace("-", "_"), body,
                           with_meta=True)
        findings, errors = run([tree], get_rules([rule_name]), root=tree)
        if errors:
            raise AssertionError(f"fixture did not parse: {errors}")
        return findings


def run_selftest(verbose=False):
    """0 when every rule fires on bad and stays quiet on good."""
    failures = []
    for rule_name, (bad, expected, good) in sorted(FIXTURES.items()):
        bad_findings = run_fixture(rule_name, bad)
        text = "\n".join(f.message for f in bad_findings)
        for fragment in expected:
            if fragment not in text:
                failures.append(
                    f"{rule_name}: bad fixture did not produce "
                    f"{fragment!r} (got: {text or '<nothing>'})")
        good_findings = run_fixture(rule_name, good)
        # the knob fixture's registry intentionally carries one dead
        # knob so the bad case proves the finalize check; it fires on
        # the good tree too, so filter it there
        real = [f for f in good_findings
                if "SQ_DEAD" not in f.message]
        if real:
            failures.append(
                f"{rule_name}: good fixture produced findings: "
                + "; ".join(f.message for f in real))
        if verbose:
            status = ("FAIL" if any(x.startswith(rule_name)
                                    for x in failures) else "ok")
            print(f"selftest {rule_name:20s} {status} "
                  f"({len(bad_findings)} bad-fixture findings)")
    for f in failures:
        print(f"selftest failure: {f}")
    if verbose and not failures:
        print(f"selftest: all {len(FIXTURES)} rules fire on their bad "
              f"fixtures and pass their good twins")
    return 1 if failures else 0
