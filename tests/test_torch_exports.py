"""Export parity: the port offers every public name of the JAX package,
but for the ones ``ROADMAP.md`` gives a reason for.

For every module of ``sq_learn_tpu`` with a counterpart in
``sq_learn_tpu_torch`` (same path), the JAX module's ``__all__`` less the
port module's public names (its ``__all__``, else its names without a
leading underscore) must equal that module's entry in ``NOT_PORTED``;
every module without a counterpart must stand in ``NOT_PORTED_MODULES``.
Each entry names its reason, and every name in either table must appear
in ``ROADMAP.md`` ("Not ported, and why"). A name the port drops, or
gains, without a line there fails here.
"""

import ast
import importlib
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reasons ``ROADMAP.md`` gives
NO_OBJECT = "no object in eager torch"
GROUND_RULES = "out by the ground rules"
JAX_KEYS = "jax keys: the counterpart is utils/random.py"
PALLAS = "the Pallas kernels: the counterparts are csrc/"

#: JAX module → {name in its __all__ the port does not export: reason}
NOT_PORTED = {
    "sq_learn_tpu": {"native": GROUND_RULES},
    "sq_learn_tpu.analysis.rules": {"JitPurityRule": NO_OBJECT},
    "sq_learn_tpu.obs": {"RetracingError": NO_OBJECT,
                         "RetracingWarning": NO_OBJECT,
                         "RetracingWatchdog": NO_OBJECT,
                         "watchdog": NO_OBJECT, "xla": NO_OBJECT},
    "sq_learn_tpu.serving.aot": {"compile_cache_dir": NO_OBJECT,
                                 "enable_persistent_cache": NO_OBJECT,
                                 "persistent_cache_stats": NO_OBJECT},
    "sq_learn_tpu.sketch": {"dispatch_host": GROUND_RULES,
                            "finalize_host": GROUND_RULES},
    "sq_learn_tpu.sketch.engine": {"dispatch_host": GROUND_RULES,
                                   "finalize_host": GROUND_RULES},
    "sq_learn_tpu.streaming": {"kernel_cache_sizes": NO_OBJECT},
    "sq_learn_tpu.utils": {"as_key": JAX_KEYS, "key_iter": JAX_KEYS,
                           "split": JAX_KEYS},
}

#: JAX module without a counterpart → reason
NOT_PORTED_MODULES = {
    "sq_learn_tpu._compat": NO_OBJECT,
    "sq_learn_tpu.analysis.rules.jitpure": NO_OBJECT,
    "sq_learn_tpu.native": GROUND_RULES,
    "sq_learn_tpu.obs.watchdog": NO_OBJECT,
    "sq_learn_tpu.obs.xla": NO_OBJECT,
    "sq_learn_tpu.ops.pallas_kernels": PALLAS,
    "sq_learn_tpu.utils.keys": JAX_KEYS,
}


def _modules(package):
    """Dotted names of a package's modules, from its files (nothing is
    imported); ``__main__`` modules are CLIs and left out."""
    root = os.path.join(REPO, package)
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, REPO).replace(os.sep, ".")
        for f in files:
            if not f.endswith(".py") or f == "__main__.py":
                continue
            out.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(out)


def _port_name(name):
    return "sq_learn_tpu_torch" + name[len("sq_learn_tpu"):]


def _declares_all(name):
    """True when the module's source assigns ``__all__`` (read, not
    imported)."""
    path = os.path.join(REPO, *name.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return any(isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)
        for node in tree.body)


JAX_MODULES = _modules("sq_learn_tpu")
PAIRS = [m for m in JAX_MODULES
         if importlib.util.find_spec(_port_name(m)) is not None]
WITH_ALL = [m for m in PAIRS if _declares_all(m)]


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in dir(module) if not n.startswith("_")]
    return set(names)


def test_every_module_without_a_counterpart_is_listed():
    missing = {m for m in JAX_MODULES if m not in PAIRS
               and not m.startswith("sq_learn_tpu.native.")}
    assert missing == set(NOT_PORTED_MODULES)
    assert "sq_learn_tpu.obs.regress" in WITH_ALL
    assert set(NOT_PORTED) <= set(WITH_ALL)


@pytest.mark.parametrize("name", WITH_ALL)
def test_the_port_exports_the_jax_modules_names(name):
    theirs = importlib.import_module(name).__all__
    port = importlib.import_module(_port_name(name))
    lacking = set(theirs) - _public(port)
    assert lacking == set(NOT_PORTED.get(name, {})), (
        f"{_port_name(name)} lacks {sorted(lacking)}; "
        f"listed: {sorted(NOT_PORTED.get(name, {}))}")
    for exported in set(theirs) - lacking:
        assert hasattr(port, exported), exported


def test_every_listed_name_has_its_line_in_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    section = text[text.index("**Not ported, and why**"):]
    section = section[:section.index("\n### ")]
    for names in NOT_PORTED.values():
        for name in names:
            assert f"`{name}`" in section or f".{name}`" in section, name
    for module in NOT_PORTED_MODULES:
        path = module[len("sq_learn_tpu."):].replace(".", "/")
        assert (f"`{path}.py`" in section or f"`{path}/`" in section
                or f"{path}.py" in section), module
    for reason in {*NOT_PORTED_MODULES.values(),
                   *(r for names in NOT_PORTED.values()
                     for r in names.values())}:
        assert reason.split(":")[0] in section, reason
