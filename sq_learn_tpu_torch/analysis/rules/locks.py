"""Rule ``lock-discipline`` — `_GUARDED_BY` attrs written under lock
(counterpart of ``sq_learn_tpu/analysis/rules/locks.py``).

A class opts in by declaring ``_GUARDED_BY = {"_lock": ("_attr", ...)}``
(the classes shared between threads: ``StorageLedger``, ``BudgetLedger``,
``ShardPrefetcher``, ``_BufferPool``, ``MicroBatchDispatcher``,
``Controller``, ``CircuitBreaker``, ``AsyncStreamCheckpointer`` and the
elastic world's ``LeaseSupervisor``). Every
write to a guarded ``self.<attr>`` outside ``__init__`` must sit inside
a ``with self.<lock>:`` block (a local alias ``lk = self._lock; with
lk:`` also counts). Methods that by contract run with the lock already
held are either named ``*_locked`` or listed in ``_ASSUMES_LOCK``.
Nested functions (worker-thread bodies) start with no lock held — the
closure runs on another thread.
"""

import ast

from ..core import Finding, Rule, dotted_name, const_str


def _guarded_table(classdef):
    """(attr -> lock, assumes_lock_methods) from the class body."""
    guarded, assumes = {}, set()
    for node in classdef.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        target = node.targets[0].id
        if target == "_GUARDED_BY" and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                lock = const_str(k)
                if lock is None or not isinstance(v, (ast.Tuple,
                                                      ast.List)):
                    continue
                for e in v.elts:
                    attr = const_str(e)
                    if attr:
                        guarded[attr] = lock
        elif target == "_ASSUMES_LOCK" and isinstance(
                node.value, (ast.Tuple, ast.List)):
            assumes |= {s for s in (const_str(e)
                                    for e in node.value.elts) if s}
    return guarded, assumes


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("_GUARDED_BY attributes are only written inside "
                   "`with <lock>:` blocks")

    def check_module(self, ctx, tree, relpath, source):
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, relpath))
        return findings

    def _check_class(self, classdef, relpath):
        guarded, assumes = _guarded_table(classdef)
        if not guarded:
            return
        for node in classdef.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if (node.name == "__init__" or node.name in assumes
                    or node.name.endswith("_locked")):
                continue
            yield from self._check_scope(node, relpath, guarded,
                                         classdef.name, node.name,
                                         held=frozenset(), aliases={})

    def _check_scope(self, scope, relpath, guarded, cls, method, held,
                     aliases):
        """Walk one function scope tracking which locks the lexical
        `with` stack holds; recurse into nested defs with an empty
        held-set (closures run on other threads)."""
        for stmt in (scope.body if isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.With, ast.AsyncWith)) else scope):
            yield from self._check_stmt(stmt, relpath, guarded, cls,
                                        method, held, aliases)

    def _check_stmt(self, stmt, relpath, guarded, cls, method, held,
                    aliases):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from self._check_scope(stmt, relpath, guarded, cls,
                                         f"{method}.{stmt.name}",
                                         frozenset(), dict(aliases))
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locks = set()
            for item in stmt.items:
                name = self._lock_name(item.context_expr, aliases)
                if name:
                    locks.add(name)
            inner = held | frozenset(locks)
            for s in stmt.body:
                yield from self._check_stmt(s, relpath, guarded, cls,
                                            method, inner, aliases)
            return
        # track simple `lk = self._lock` aliases
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            src = dotted_name(stmt.value)
            if src and src.startswith("self."):
                aliases[stmt.targets[0].id] = src[len("self."):]
        # writes in this statement (including inside compound headers)
        for target_attr, line in self._self_writes(stmt):
            lock = guarded.get(target_attr)
            if lock is not None and lock not in held:
                yield Finding(
                    self.name, relpath, line,
                    f"{cls}.{method}() writes guarded attribute "
                    f"self.{target_attr} outside `with self.{lock}:`")
        # recurse into compound-statement bodies
        for field in ("body", "orelse", "finalbody"):
            for s in getattr(stmt, field, ()):
                yield from self._check_stmt(s, relpath, guarded, cls,
                                            method, held, aliases)
        for handler in getattr(stmt, "handlers", ()):
            for s in handler.body:
                yield from self._check_stmt(s, relpath, guarded, cls,
                                            method, held, aliases)

    @staticmethod
    def _lock_name(expr, aliases):
        name = dotted_name(expr)
        if name and name.startswith("self."):
            return name[len("self."):]
        if isinstance(expr, ast.Name):
            return aliases.get(expr.id)
        return None

    @staticmethod
    def _self_writes(stmt):
        """(attr, line) for every `self.<attr>` assignment target in
        this one statement (tuple unpacking included)."""
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = stmt.targets

        def flatten(t):
            if isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    yield from flatten(e)
            else:
                yield t

        for t in targets:
            for leaf in flatten(t):
                if (isinstance(leaf, ast.Attribute)
                        and isinstance(leaf.value, ast.Name)
                        and leaf.value.id == "self"):
                    yield leaf.attr, leaf.lineno
