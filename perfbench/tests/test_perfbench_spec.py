"""BENCHMARK.json against the benchmark's contract, and every piece it names
found by name under perfbench/."""

import ast
import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_command_and_paths():
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in cmd)
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
        assert not path.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, path))
    for word in cmd[1:]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in SPEC[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"])
            assert 1 <= len(entry["why"]) <= 200
            assert "\n" not in entry["why"] and "\t" not in entry["why"]
    for m in METRICS:
        allowed = {"name", "unit", "better", "source", "workloads"}
        if m in SPEC["end_to_end"]:
            allowed |= {"bound"}
        else:
            allowed |= {"layer", "moves"}
        assert set(m) <= allowed and {"name", "unit", "better",
                                      "source"} <= set(m), m
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    cells = [w["name"] for w in SPEC["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(NAME.match(w["config"]) and NAME.match(w["traffic"])
               for w in SPEC["workloads"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in cells:
        got = {m["name"] for m in harness.cell_metrics(SPEC, cell, 0)}
        assert "setup_s" in got and len(got) >= 2
        layer = harness.cell_metrics(SPEC, cell, 1)
        assert layer
        for m in layer:
            assert m["moves"] in got, (cell, m["name"])
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200


def test_every_piece_found_by_name():
    for conf in SPEC["configs"]:
        assert conf["file"].startswith("perfbench/")
        data = json.load(open(os.path.join(ROOT, conf["file"])))
        assert data["name"] == conf["name"]
        assert sorted(data["reduced"]) == sorted(conf["reduced"])
        assert len(conf["reduced"]) <= 16
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for w in SPEC["workloads"]:
        cell, config, traffic, limits, _ = harness.load_cell(w["name"])
        assert os.path.isfile(os.path.join(harness.BENCH, "jobs",
                                           f"{traffic['job']}.py"))
        assert os.path.isfile(os.path.join(harness.BENCH, "data",
                                           f"{config['recipe']}.py"))
        assert limits["limits"]
        assert w["chips"] == 1
    for m in METRICS:
        assert callable(harness.reader(m["name"]))


def test_configs_used_and_layers_named_alike():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"estimators", "q-means loop", "kernels", "device"}


def test_shares_named_as_the_contract_asks():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("sub", ["", "data", "jobs", "reference",
                                 "metrics"])
def test_no_source_imports_jax_or_the_jax_package(sub):
    folder = os.path.join(harness.BENCH, sub)
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] not in harness.FORBIDDEN, (name, mod)
                if sub == "reference":
                    assert not mod.startswith("sq_learn_tpu_torch"), name
