"""Rule ``estimator-contract`` — the sklearn surface stays sklearn
(counterpart of ``sq_learn_tpu/analysis/rules/estimator.py``).

For every class inheriting (transitively within its module) from
``BaseEstimator``: ``__init__`` assigns each hyperparameter verbatim
(``self.p = p``) and nothing else public; every ``return`` in ``fit``/
``partial_fit`` returns ``self``; public fitted attributes assigned
outside ``__init__`` end with ``_`` (``utils/checkpoint.py`` serializes
exactly those).

Escapes the code declares explicitly: an ``__init__`` that delegates to
``super().__init__(...)`` is exempt from the every-param-assigned check
(the sklearn-compat subclasses), a ``return`` whose value is a call or
a bare name is accepted (delegation chains — ``return
self._fit_store(...)``, ``return out`` from the tiny-fit router — are
resolved at runtime by the parity tests, not here), and attributes
listed in a class-level ``_NONSTANDARD_FITTED_ATTRS`` tuple keep their
reference-parity names without the trailing underscore (QPCA's surface
predates the convention; the differential tests read those exact
names).
"""

import ast

from ..core import Finding, Rule

_FIT_METHODS = ("fit", "partial_fit")


def _estimator_classes(tree):
    """ClassDefs that inherit from BaseEstimator, resolving single-file
    inheritance chains by name (cross-module bases are matched on the
    terminal name — ``from ..base import BaseEstimator``)."""
    classes = {n.name: n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)}

    def base_names(cd):
        for b in cd.bases:
            if isinstance(b, ast.Name):
                yield b.id
            elif isinstance(b, ast.Attribute):
                yield b.attr

    def is_estimator(cd, seen=()):
        for name in base_names(cd):
            if name == "BaseEstimator":
                return True
            nxt = classes.get(name)
            if nxt is not None and name not in seen:
                if is_estimator(nxt, seen + (name,)):
                    return True
        return False

    return [cd for cd in classes.values() if is_estimator(cd)]


def _nonstandard_attrs(cd):
    """The class's declared ``_NONSTANDARD_FITTED_ATTRS`` tuple (public
    fitted attributes kept under reference-parity names)."""
    for node in cd.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_NONSTANDARD_FITTED_ATTRS"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return {s for s in (
                e.value for e in node.value.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str))}
    return set()


def _init_params(init):
    args = init.args
    names = [a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)]
    return [n for n in names if n != "self"]


def _self_assigns(func):
    """(attr, value_node, line) for every simple `self.x = ...` in this
    function (same lexical scope only)."""
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    yield t.attr, node.value, t.lineno
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            t = node.target
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                yield t.attr, node.value, t.lineno


class EstimatorContractRule(Rule):
    name = "estimator-contract"
    description = ("__init__ assigns hyperparams verbatim, fit returns "
                   "self, public fitted attrs end in '_'")

    def check_module(self, ctx, tree, relpath, source):
        findings = []
        for cd in _estimator_classes(tree):
            findings.extend(self._check_class(cd, relpath))
        return findings

    def _check_class(self, cd, relpath):
        methods = {n.name: n for n in cd.body
                   if isinstance(n, ast.FunctionDef)}
        exempt = _nonstandard_attrs(cd)
        init = methods.get("__init__")
        params = _init_params(init) if init else []
        if init is not None:
            yield from self._check_init(cd, init, params, exempt,
                                        relpath)
        for name in _FIT_METHODS:
            fit = methods.get(name)
            if fit is not None:
                yield from self._check_fit(cd, fit, relpath)
        for mname, method in methods.items():
            if mname == "__init__":
                continue
            yield from self._check_fitted_attrs(cd, method, params,
                                                exempt, relpath)

    def _check_init(self, cd, init, params, exempt, relpath):
        assigned = set()
        delegates = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "__init__"
            and isinstance(n.func.value, ast.Call)
            and isinstance(n.func.value.func, ast.Name)
            and n.func.value.func.id == "super"
            for n in ast.walk(init))
        for attr, value, line in _self_assigns(init):
            assigned.add(attr)
            if attr in params:
                if not (isinstance(value, ast.Name)
                        and value.id == attr):
                    yield Finding(
                        self.name, relpath, line,
                        f"{cd.name}.__init__ must assign hyperparameter "
                        f"{attr!r} verbatim (self.{attr} = {attr}); "
                        f"derive in fit instead")
            elif not attr.startswith("_") and attr not in exempt:
                yield Finding(
                    self.name, relpath, line,
                    f"{cd.name}.__init__ assigns non-hyperparameter "
                    f"public attribute {attr!r} — sklearn contract "
                    f"allows only verbatim hyperparams here")
        if not delegates:
            for p in params:
                if p not in assigned:
                    yield Finding(
                        self.name, relpath, init.lineno,
                        f"{cd.name}.__init__ never assigns "
                        f"hyperparameter {p!r} to self.{p}")

    def _check_fit(self, cd, fit, relpath):
        returns = [n for n in ast.walk(fit) if isinstance(n, ast.Return)]
        for r in returns:
            v = r.value
            if isinstance(v, ast.Name) and v.id == "self":
                continue
            # delegation (`return self._fit_store(...)`, `return
            # super().fit(...)`) and router results (`return out`) are
            # runtime-checked by the parity tests — only flag returns
            # that are provably not the estimator
            if isinstance(v, (ast.Call,)) or (
                    isinstance(v, ast.Name)):
                continue
            yield Finding(
                self.name, relpath, r.lineno,
                f"{cd.name}.{fit.name}() must return self")
        if not returns:
            yield Finding(
                self.name, relpath, fit.lineno,
                f"{cd.name}.{fit.name}() must return self (no return "
                f"statement found)")

    def _check_fitted_attrs(self, cd, method, params, exempt, relpath):
        for attr, _value, line in _self_assigns(method):
            if (attr.startswith("_") or attr.endswith("_")
                    or attr in params or attr in exempt):
                continue
            yield Finding(
                self.name, relpath, line,
                f"{cd.name}.{method.name}() assigns public fitted "
                f"attribute {attr!r} without the trailing underscore")
