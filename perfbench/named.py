"""Find a piece of the benchmark by its name: ``perfbench/<folder>/<name>.py``
is loaded as a module, so that a later cell, recipe, job or metric is a new
file and never an edit."""

import importlib.util
import os

BENCH = os.path.dirname(os.path.abspath(__file__))


def load(folder, name):
    """The module ``perfbench/<folder>/<name>.py``."""
    path = os.path.join(BENCH, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"perfbench/{folder} has no {name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
