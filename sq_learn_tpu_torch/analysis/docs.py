"""``--docs`` / ``--check-docs`` — the port's knob table is generated,
not hand-maintained (counterpart of ``sq_learn_tpu/analysis/docs.py``).

``--docs`` renders the port's registry into markdown (committed as
``docs/torch/knobs.md``; ``docs/knobs.md`` is the JAX package's);
``--check-docs`` exits non-zero when (a) the committed table drifts from
a fresh render, (b) a knob-shaped token in the port's prose docs
(``docs/torch/*.md``) does not resolve in the registry, or (c) a
registry entry's declared doc anchor file never mentions it.

The table lives in ``docs/torch/``, not beside ``docs/knobs.md``: the
JAX package's own ``--check-docs`` resolves every knob-shaped token of
``docs/*.md`` in its registry, which does not hold the port's own knobs
(``SQ_GPU_PEAK_FLOPS``).
"""

import importlib.util
import os
import re

__all__ = ["load_registry_module", "render_knob_table", "check_docs",
           "DOCS_RELPATH"]

DOCS_DIR = os.path.join("docs", "torch")
DOCS_RELPATH = os.path.join(DOCS_DIR, "knobs.md")
REGISTRY_RELPATH = os.path.join("sq_learn_tpu_torch", "_knobs.py")

_TOKEN_RE = re.compile(r"\b(_?SQ_[A-Z0-9_]+\*?)\b")

_SCOPE_TITLES = (
    ("lib", "Library knobs"),
    ("external", "External knobs (owned upstream, registered so reads "
                 "are auditable)"),
)


def load_registry_module(root, relpath=None):
    """Import ``_knobs.py`` standalone from its file (it only imports
    ``os``, so this is safe without triggering the package — and works
    on fixture trees)."""
    path = os.path.join(root, relpath or REGISTRY_RELPATH)
    spec = importlib.util.spec_from_file_location("_sqcheck_torch_knobs",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fmt_default(knob):
    if knob.kind == "flag":
        return "on" if knob.default else "off"
    if knob.default is None:
        return "unset"
    return f"``{knob.default!r}``"


def render_knob_table(knobs_mod):
    """The committed ``docs/torch/knobs.md``, rendered from the
    registry."""
    lines = [
        "# Environment knobs of the PyTorch/CUDA port",
        "",
        "<!-- GENERATED FILE — do not edit. Regenerate with",
        "     `python -m sq_learn_tpu_torch.analysis --docs > "
        "docs/torch/knobs.md`;",
        "     `python -m sq_learn_tpu_torch.analysis --check-docs` "
        "fails on drift. -->",
        "",
        "Every environment knob `sq_learn_tpu_torch` reads, generated",
        "from the single source of truth `sq_learn_tpu_torch/_knobs.py`.",
        "All reads go through the typed accessors there (`get_bool`/",
        "`get_int`/`get_float`/`get_str`/`get_raw`); the static checker",
        "(rule `knob-registry`) rejects raw `os.environ` reads and",
        "unregistered names. Flag semantics: a default-off flag enables",
        "only on `=1`; a default-on flag disables only on `=0`. The JAX",
        "package's table is `docs/knobs.md`.",
        "",
    ]
    by_scope = {}
    for k in knobs_mod.iter_knobs():
        by_scope.setdefault(k.scope, []).append(k)
    for scope, title in _SCOPE_TITLES:
        entries = by_scope.pop(scope, [])
        if not entries:
            continue
        lines += [f"## {title}", "",
                  "| Knob | Kind | Default | Documented in |"
                  " Description |",
                  "|---|---|---|---|---|"]
        for k in sorted(entries, key=lambda e: e.name):
            anchor = f"`{k.anchor}`" if k.anchor else "—"
            lines.append(
                f"| `{k.name}` | {k.kind} | {_fmt_default(k)} | "
                f"{anchor} | {k.doc} |")
        lines.append("")
    if by_scope:
        raise ValueError(f"unrendered knob scopes: {sorted(by_scope)}")
    return "\n".join(lines).rstrip() + "\n"


def _doc_files(root):
    docdir = os.path.join(root, DOCS_DIR)
    if not os.path.isdir(docdir):
        return []
    return sorted(os.path.join(DOCS_DIR, f)
                  for f in os.listdir(docdir) if f.endswith(".md"))


def check_docs(root, knobs_mod=None):
    """Run all three doc cross-checks; returns a list of problem
    strings (empty = docs and registry agree)."""
    problems = []
    if knobs_mod is None:
        try:
            knobs_mod = load_registry_module(root)
        except (OSError, SyntaxError) as exc:
            return [f"cannot load knob registry: {exc}"]
    regen = (f"`python -m sq_learn_tpu_torch.analysis --docs > "
             f"{DOCS_RELPATH}`")
    # (a) committed generated table is fresh
    want = render_knob_table(knobs_mod)
    try:
        with open(os.path.join(root, DOCS_RELPATH)) as fh:
            have = fh.read()
    except OSError:
        have = None
    if have is None:
        problems.append(f"{DOCS_RELPATH} is missing — generate it with "
                        f"{regen}")
    elif have != want:
        problems.append(f"{DOCS_RELPATH} drifted from the registry — "
                        f"regenerate with {regen}")
    # (b) every knob token in the prose docs resolves
    for rel in _doc_files(root):
        if rel == DOCS_RELPATH:
            continue
        with open(os.path.join(root, rel)) as fh:
            text = fh.read()
        for lineno, line in enumerate(text.splitlines(), 1):
            for tok in _TOKEN_RE.findall(line):
                if knobs_mod.resolve(tok.rstrip("*")) is None:
                    problems.append(
                        f"{rel}:{lineno}: knob-shaped token {tok!r} "
                        f"does not resolve in the _knobs registry")
    # (c) every anchored knob is mentioned by its anchor file
    for k in knobs_mod.iter_knobs():
        if not k.anchor:
            continue
        try:
            with open(os.path.join(root, k.anchor)) as fh:
                text = fh.read()
        except OSError:
            problems.append(
                f"knob {k.name!r} declares missing anchor {k.anchor!r}")
            continue
        if k.name not in text:
            problems.append(
                f"knob {k.name!r} is not mentioned in its declared "
                f"anchor {k.anchor!r}")
    return problems
