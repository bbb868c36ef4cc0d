"""Rule architecture, file walker, baseline, and the entry point that
runs the rules (counterpart of ``sq_learn_tpu/analysis/core.py``).

A :class:`Rule` sees every module twice: once per file
(:meth:`Rule.check_module`, with the parsed AST) and once at the end
(:meth:`Rule.finalize`) for cross-file invariants (a knob registered but
never read, a schema record type never emitted). Findings are suppressed
by a committed JSON baseline keyed on ``(rule, path, message)`` — line
numbers stay out of the key so unrelated edits don't churn it.
"""

import ast
import json
import os

__all__ = [
    "AnalysisContext",
    "Finding",
    "Rule",
    "import_aliases",
    "load_baseline",
    "match_baseline",
    "run",
    "walk_python_files",
]


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule, path, line, message):
        self.rule = rule
        self.path = path
        self.line = int(line)
        self.message = message

    def key(self):
        """Baseline suppression key (line-number free)."""
        return (self.rule, self.path, self.message)

    def __repr__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self):
        return {"rule": self.rule, "path": self.path,
                "message": self.message}


class AnalysisContext:
    """Shared state for one analysis run over a project tree.

    ``root`` anchors the relative paths findings report; rules stash
    cross-file state on themselves between ``check_module`` calls and
    read project metadata (registry source, schema source, reference
    trees for textual scans) through the helpers here.
    """

    def __init__(self, root, paths=None):
        self.root = os.path.abspath(root)
        self.paths = [os.path.abspath(p) for p in (paths or [self.root])]
        self.sources = {}  # relpath -> source text (analyzed files)

    def relpath(self, path):
        return os.path.relpath(os.path.abspath(path), self.root)

    def read(self, relpath):
        """Source of a project file by root-relative path ('' on a
        miss) — rules use this for metadata files that may sit outside
        the analyzed paths (the registry when linting a single
        subpackage)."""
        if relpath in self.sources:
            return self.sources[relpath]
        try:
            with open(os.path.join(self.root, relpath)) as fh:
                return fh.read()
        except OSError:
            return ""


class Rule:
    """Base class: subclasses set ``name``/``description`` and override
    one or both hooks. Hooks return iterables of :class:`Finding`."""

    name = "base"
    description = ""

    def check_module(self, ctx, tree, relpath, source):
        return ()

    def finalize(self, ctx):
        return ()


def walk_python_files(paths):
    """Every ``*.py`` under ``paths`` (files or directories),
    deterministic order, skipping caches and hidden dirs."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(out))


def load_baseline(path):
    """The committed suppression list: ``[{rule, path, message,
    justification}, ...]``. Missing file = empty baseline."""
    try:
        with open(path) as fh:
            entries = json.load(fh)
    except OSError:
        return []
    for e in entries:
        for field in ("rule", "path", "message", "justification"):
            if not isinstance(e.get(field), str) or not e[field]:
                raise ValueError(
                    f"baseline entry {e!r} needs non-empty str {field!r}")
    return entries


def match_baseline(findings, baseline):
    """Split ``findings`` into (fresh, suppressed) against the baseline
    and report baseline entries that no longer match anything (stale
    entries must be pruned, or the baseline rots)."""
    keys = {(e["rule"], e["path"], e["message"]) for e in baseline}
    fresh = [f for f in findings if f.key() not in keys]
    suppressed = [f for f in findings if f.key() in keys]
    live = {f.key() for f in suppressed}
    stale = [e for e in baseline
             if (e["rule"], e["path"], e["message"]) not in live]
    return fresh, suppressed, stale


def run(paths, rules, root=None):
    """Run ``rules`` over every Python file under ``paths``.

    Returns ``(findings, errors)`` where ``errors`` are file-level
    problems (syntax errors) that should fail the run loudly rather
    than silently skipping a file.
    """
    root = os.path.abspath(root or os.path.commonpath(
        [os.path.abspath(p) for p in paths]))
    ctx = AnalysisContext(root, paths)
    findings, errors = [], []
    for path in walk_python_files(ctx.paths):
        relpath = ctx.relpath(path)
        try:
            with open(path) as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as exc:
            errors.append(f"{relpath}: {exc}")
            continue
        ctx.sources[relpath] = source
        for rule in rules:
            findings.extend(rule.check_module(ctx, tree, relpath, source))
    for rule in rules:
        findings.extend(rule.finalize(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, errors


# -- small AST helpers shared by the rules --------------------------------

def dotted_name(node):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node):
    """The value of a string-literal node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def import_aliases(tree):
    """alias -> full module path for plain imports and from-imports
    (``import numpy as np`` → np: numpy; ``from torch import rand`` →
    rand: torch.rand)."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases
