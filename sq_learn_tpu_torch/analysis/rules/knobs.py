"""Rule ``knob-registry`` — every env read rides the knob registry
(counterpart of ``sq_learn_tpu/analysis/rules/knobs.py``).

Flags (a) raw ``os.environ``/``os.getenv`` **reads** outside
``_knobs.py`` (writes, ``del``, ``.pop``/``.update`` cleanup, and
``dict(os.environ)``/``{**os.environ}`` subprocess-env copies stay
legal), (b) accessor calls whose literal knob name does not resolve in
the registry, and (c) registry entries never referenced by any accessor
call or by the tests, examples and chip scripts (finalize). The registry itself is
parsed statically out of ``_knobs.py`` — the checker never imports the
code under analysis.
"""

import ast
import os

from ..core import Finding, Rule, dotted_name, const_str

#: _knobs accessor functions whose first argument is a knob name
_ACCESSORS = {"get_raw", "get_str", "get_int", "get_float", "get_bool",
              "is_set", "setdefault", "knob", "resolve"}

#: auxiliary trees/files scanned textually for knob references in
#: finalize (tests and the chip scripts set knobs through the
#: environment, not the accessors)
_AUX_PATHS = ("tests", "examples", "chip_smoke.py", "chip_profile.py",
              "chip_variants.py")


def parse_registry(source):
    """(entries, families) parsed from ``_knobs.py`` source: entries is
    {name: (scope, anchor, line)}; families the trailing-``*`` names."""
    entries = {}
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return entries, ()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_ENTRIES"
                and isinstance(node.value, ast.List)):
            continue
        for call in node.value.elts:
            if not (isinstance(call, ast.Call) and len(call.args) >= 6):
                continue
            name = const_str(call.args[0])
            scope = const_str(call.args[3])
            anchor = const_str(call.args[5])
            if name:
                entries[name] = (scope or "lib", anchor, call.lineno)
    families = tuple(n for n in entries if n.endswith("*"))
    return entries, families


def resolve_name(name, entries, families):
    """Registry entry name governing ``name``, or None."""
    if name in entries:
        return name
    for fam in families:
        if name.startswith(fam[:-1]):
            return fam
    return None


class KnobRegistryRule(Rule):
    name = "knob-registry"
    description = ("os.environ reads go through sq_learn_tpu_torch._knobs; "
                   "every accessor name is registered; every registry "
                   "entry is read somewhere")

    def __init__(self):
        self.registry_source = None
        self.registry_relpath = None
        self.referenced = set()  # registry entry names seen in accessors

    def _registry(self, ctx):
        if self.registry_source is None:
            src = ctx.sources.get(self.registry_relpath, "")
            if not src:
                for cand in ("_knobs.py",
                             os.path.join("sq_learn_tpu_torch",
                                          "_knobs.py")):
                    src = ctx.read(cand)
                    if src:
                        self.registry_relpath = cand
                        break
            self.registry_source = src
        return parse_registry(self.registry_source or "")

    def check_module(self, ctx, tree, relpath, source):
        if os.path.basename(relpath) == "_knobs.py":
            # remember the analyzed registry for finalize; the raw-read
            # and accessor checks don't apply to the registry itself
            self.registry_relpath = relpath
            self.registry_source = None
            return ()
        findings = []
        entries, families = self._registry(ctx)
        for node in ast.walk(tree):
            findings.extend(self._raw_read(node, relpath))
            findings.extend(
                self._accessor(node, relpath, entries, families))
        return findings

    def _raw_read(self, node, relpath):
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn in ("os.environ.get", "os.getenv",
                      "os.environ.setdefault"):
                yield Finding(
                    self.name, relpath, node.lineno,
                    f"raw environment read {fn}(...) — use the "
                    f"sq_learn_tpu_torch._knobs accessors")
        elif isinstance(node, ast.Subscript):
            if (dotted_name(node.value) == "os.environ"
                    and isinstance(node.ctx, ast.Load)):
                yield Finding(
                    self.name, relpath, node.lineno,
                    "raw environment read os.environ[...] — use the "
                    "sq_learn_tpu_torch._knobs accessors")
        elif isinstance(node, ast.Compare):
            for op, right in zip(node.ops, node.comparators):
                if (isinstance(op, (ast.In, ast.NotIn))
                        and dotted_name(right) == "os.environ"):
                    yield Finding(
                        self.name, relpath, node.lineno,
                        "raw membership test on os.environ — use "
                        "_knobs.is_set")

    def _accessor(self, node, relpath, entries, families):
        if not isinstance(node, ast.Call):
            return
        fn = dotted_name(node.func)
        if not fn or "." not in fn:
            return
        head, _, tail = fn.rpartition(".")
        if not head.endswith("_knobs") or tail not in _ACCESSORS:
            return
        if not node.args:
            return
        for name, exact in self._literal_names(node.args[0]):
            hit = resolve_name(name, entries, families)
            if hit is not None:
                self.referenced.add(hit)
            elif exact:
                yield Finding(
                    self.name, relpath, node.lineno,
                    f"knob {name!r} is not in the _knobs registry")
            else:
                # f-string prefix: only flag when NO family could match
                if not any(f.startswith(name) or name.startswith(f[:-1])
                           for f in families):
                    yield Finding(
                        self.name, relpath, node.lineno,
                        f"dynamic knob name with prefix {name!r} matches "
                        f"no registered family entry")

    @staticmethod
    def _literal_names(arg):
        """(name, is_exact) candidates from an accessor's name arg:
        string literals are exact; f-strings yield their leading
        constant prefix (matched against family entries)."""
        s = const_str(arg)
        if s is not None:
            return [(s, True)]
        if isinstance(arg, ast.JoinedStr) and arg.values:
            prefix = const_str(arg.values[0])
            if prefix:
                return [(prefix, False)]
        return []

    def finalize(self, ctx):
        entries, families = self._registry(ctx)
        if not entries:
            return [Finding(
                self.name, self.registry_relpath or "_knobs.py", 1,
                "no knob registry found (_knobs.py with an _ENTRIES "
                "table)")]
        aux = self._aux_text(ctx)
        findings = []
        for name, (scope, _anchor, line) in sorted(entries.items()):
            if name in self.referenced:
                continue
            probe = name[:-1] if name.endswith("*") else name
            if probe in aux:
                continue
            if scope != "lib" and any(probe in src
                                      for src in ctx.sources.values()):
                continue
            findings.append(Finding(
                self.name, self.registry_relpath or "_knobs.py", line,
                f"knob {name!r} is registered but never read (no "
                f"accessor call, no bench/test/CI reference)"))
        return findings

    @staticmethod
    def _aux_text(ctx):
        chunks = []
        for rel in _AUX_PATHS:
            path = os.path.join(ctx.root, rel)
            if os.path.isfile(path):
                chunks.append(ctx.read(rel))
            elif os.path.isdir(path):
                for dirpath, dirnames, filenames in os.walk(path):
                    dirnames[:] = [d for d in dirnames
                                   if not d.startswith(".")
                                   and d != "__pycache__"]
                    for f in filenames:
                        if f.endswith((".py", ".sh", ".yml", ".json")):
                            chunks.append(ctx.read(os.path.relpath(
                                os.path.join(dirpath, f), ctx.root)))
        return "\n".join(chunks)
