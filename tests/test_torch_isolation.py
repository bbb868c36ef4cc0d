"""The port stands alone: no JAX and nothing of ``sq_learn_tpu``.

In a fresh interpreter where ``import jax`` and ``import sklearn`` fail,
every module of ``sq_learn_tpu_torch`` (the serving plane and the elastic
world included),
``chip_smoke.py``, ``chip_profile.py``, ``chip_variants.py`` and every
driver of ``examples_torch/`` (one for each script of ``examples/``)
import,
the ``obs`` package writes an artifact that its ``audit``, ``frontier``
and ``report`` subcommands read, and no ``sq_learn_tpu`` module gets
loaded.
``chip_smoke.py``
itself fails, and prints no result, without a card or without the
repository beside it.
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["sklearn"] = None  # the card's machine has no sklearn
import sq_learn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sq_learn_tpu_torch.__path__, "sq_learn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for script in ("chip_smoke", "chip_profile", "chip_variants"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import glob, os
drivers = []
for path in sorted(glob.glob(os.path.join("examples_torch", "*.py"))):
    driver = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(
        "examples_torch_" + driver, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert driver.startswith("_") or callable(module.main), driver
    drivers.append(driver)
import os, tempfile
from sq_learn_tpu_torch import obs
from sq_learn_tpu_torch.obs.__main__ import main as obs_main
path = os.path.join(tempfile.mkdtemp(), "run.jsonl")
obs.enable(path)
with obs.span("probe"):
    obs.guarantees.record_guarantee("probe", 0.0, 0.1, fail_prob=0.0)
    obs.ledger.record("probe", "step", queries={"q": 1})
    obs.frontier.record_tradeoff("probe", 0.1, accuracy=1.0, q_runtime=2.0)
obs.disable()
assert obs.schema.validate_jsonl(path)["errors"] == []
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()) as cli:
    assert obs_main(["audit", path]) == 0
    assert obs_main(["frontier", path]) == 0
assert "probe" in cli.getvalue() and "flagged: none" in cli.getvalue()
with contextlib.redirect_stdout(io.StringIO()) as cli:
    assert obs_main(["report", path]) == 0
assert "obs run report" in cli.getvalue()
bad = sorted(m for m in sys.modules
             if m == "sq_learn_tpu" or m.startswith("sq_learn_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None and sys.modules["sklearn"] is None
print(len(names), "modules")
print(" ".join(names))
print(" ".join(drivers))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return env


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15
    # the modules of q-means' quantum modes, the runtime models and QLSSVC
    names = set(out.stdout.splitlines()[1].split())
    assert {"sq_learn_tpu_torch.models.qlssvc", "sq_learn_tpu_torch.svm",
            "sq_learn_tpu_torch.metrics.pairwise",
            "sq_learn_tpu_torch.utils.plotting",
            "sq_learn_tpu_torch.sketch.engine",
            "sq_learn_tpu_torch.ops.quantum.estimation"} <= names
    # obs's research half and its subcommand entry point
    assert {"sq_learn_tpu_torch.obs", "sq_learn_tpu_torch.obs.recorder",
            "sq_learn_tpu_torch.obs.ledger",
            "sq_learn_tpu_torch.obs.guarantees",
            "sq_learn_tpu_torch.obs.frontier",
            "sq_learn_tpu_torch.obs.schema",
            "sq_learn_tpu_torch.obs.__main__"} <= names
    # the serving plane and obs's serving readers
    assert {"sq_learn_tpu_torch.serving",
            "sq_learn_tpu_torch.serving.aot",
            "sq_learn_tpu_torch.serving.cache",
            "sq_learn_tpu_torch.serving.control",
            "sq_learn_tpu_torch.serving.dispatcher",
            "sq_learn_tpu_torch.serving.quantize",
            "sq_learn_tpu_torch.serving.registry",
            "sq_learn_tpu_torch.serving.slo",
            "sq_learn_tpu_torch.obs.budget",
            "sq_learn_tpu_torch.obs.control",
            "sq_learn_tpu_torch.obs.probe",
            "sq_learn_tpu_torch.obs.report"} <= names
    # the experiment scaffolding and the remaining classical estimators
    assert {"sq_learn_tpu_torch.preprocessing", "sq_learn_tpu_torch.pipeline",
            "sq_learn_tpu_torch.feature_extraction",
            "sq_learn_tpu_torch.utils.murmurhash",
            "sq_learn_tpu_torch.models.minibatch",
            "sq_learn_tpu_torch.models.truncated_svd"} <= names
    # the mesh plane, the multi-process world and the elastic world
    assert {f"sq_learn_tpu_torch.parallel.{name}" for name in (
        "mesh", "init", "lloyd", "pca", "neighbors", "streaming",
        "distributed", "elastic")} <= names
    assert "sq_learn_tpu_torch.obs.fleet" in names
    # the drivers of examples_torch/: one for every script of examples/
    drivers = out.stdout.splitlines()[2].split()
    jax_drivers = sorted(name[:-3] for name in os.listdir(
        os.path.join(REPO, "examples")) if name.endswith(".py")
        and name != "_common.py")
    assert drivers == ["_device", *jax_drivers]


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
