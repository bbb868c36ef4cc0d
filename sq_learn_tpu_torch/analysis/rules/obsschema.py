"""Rule ``obs-schema`` — emitted record types match ``obs/schema.py``
(counterpart of ``sq_learn_tpu/analysis/rules/obsschema.py``).

The schema module exports ``RECORD_TYPES`` (machine-readable); this rule parses it statically and cross-checks every
record-construction site: a dict literal ``{"type": "x", ...}`` or a
``dict(..., type="x")`` call with an unknown type is a finding, and a
schema type no construction site ever mentions is a finding at
``schema.py`` (the validator would be dead code for it). Record
*readers* (report/trace CLIs) compare against the same literals, which
is exactly the cross-check we want — every spelling of a type anywhere
must exist in the schema.

Hot-path discipline rides along: a ``counter_add``/``gauge`` call
lexically inside a ``for``/``while`` body is flagged — accumulate in a
local and emit ONE pre-aggregated record after the loop (the
dispatcher's ``_aot_hits`` pattern).
"""

import ast
import os

from ..core import Finding, Rule, dotted_name, const_str

_HELPERS = {"counter_add": "counter", "gauge": "gauge", "span": "span"}


def _walk_same_scope(root):
    """ast.walk that does not descend into nested function bodies (a
    helper defined inside a loop only runs per-iteration if called —
    its own body is that function's problem)."""
    stack = [root]
    while stack:
        node = stack.pop()
        if node is not root and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def parse_record_types(source):
    """RECORD_TYPES tuple parsed out of ``obs/schema.py`` source."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return ()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "RECORD_TYPES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return tuple(s for s in (const_str(e)
                                     for e in node.value.elts) if s)
    return ()


class ObsSchemaRule(Rule):
    name = "obs-schema"
    description = ("record types exist in obs/schema.py RECORD_TYPES, "
                   "every schema type is emitted, counters are "
                   "pre-aggregated outside loops")

    def __init__(self):
        self.schema_relpath = None
        self.types = None
        self.sites = []  # (type, relpath, line) construction sites

    def _record_types(self, ctx):
        if self.types is None:
            src = ""
            if self.schema_relpath:
                src = ctx.sources.get(self.schema_relpath, "")
            if not src:
                for cand in (os.path.join("obs", "schema.py"),
                             os.path.join("sq_learn_tpu_torch", "obs",
                                          "schema.py")):
                    src = ctx.read(cand)
                    if src:
                        self.schema_relpath = cand
                        break
            self.types = parse_record_types(src)
        return self.types

    def check_module(self, ctx, tree, relpath, source):
        if relpath.replace(os.sep, "/").endswith("obs/schema.py"):
            self.schema_relpath = relpath
            self.types = None
            return ()
        # construction sites are only judged in finalize() — the walk
        # may visit modules before obs/schema.py itself.
        for node in ast.walk(tree):
            t, line = self._record_type_at(node)
            if t is not None:
                self.sites.append((t, relpath, line))
        return list(self._counters_in_loops(tree, relpath))

    @staticmethod
    def _record_type_at(node):
        """('type', line) when this node constructs or matches an obs
        record type: a dict literal with a "type" key, or a
        ``dict(..., type=...)`` call."""
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if const_str(k) == "type":
                    t = const_str(v)
                    if t:
                        return t, node.lineno
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id == "dict"):
            for kw in node.keywords:
                if kw.arg == "type":
                    t = const_str(kw.value)
                    if t:
                        return t, node.lineno
        return None, None

    def _counters_in_loops(self, tree, relpath):
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for loop in ast.walk(func):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for node in _walk_same_scope(loop):
                    if not isinstance(node, ast.Call):
                        continue
                    fn = dotted_name(node.func) or ""
                    leaf = fn.rsplit(".", 1)[-1]
                    # the anti-pattern is the PER-ITEM emit: a literal
                    # counter name with a constant delta inside the
                    # loop. A flusher iterating (name, delta) pairs is
                    # the blessed pre-aggregation shape and passes.
                    if (leaf == "counter_add" and node.args
                            and const_str(node.args[0]) is not None
                            and len(node.args) >= 2
                            and isinstance(node.args[1], ast.Constant)):
                        yield Finding(
                            self.name, relpath, node.lineno,
                            f"per-item counter_add() inside a loop in "
                            f"{func.name}() — accumulate locally and "
                            f"emit one pre-aggregated counter after "
                            f"the loop")

    def finalize(self, ctx):
        types = self._record_types(ctx)
        if not types:
            return [Finding(
                self.name, self.schema_relpath or "obs/schema.py", 1,
                "obs/schema.py RECORD_TYPES table not found")]
        findings = []
        mentioned = set()
        for t, relpath, line in self.sites:
            mentioned.add(t)
            if t not in types:
                findings.append(Finding(
                    self.name, relpath, line,
                    f"record type {t!r} is not declared in "
                    f"obs/schema.py RECORD_TYPES"))
        for t in types:
            if t not in mentioned:
                findings.append(Finding(
                    self.name, self.schema_relpath, 1,
                    f"schema record type {t!r} is never constructed "
                    f"anywhere in the analyzed tree"))
        return findings
