"""sqcheck over the port (``sq_learn_tpu_torch.analysis``) against the JAX
package's checker (``sq_learn_tpu.analysis``), on the CPU.

It mirrors ``tests/test_analysis.py`` for the rules the two share and the
core (rules red on bad fixtures and green on good ones, baseline split,
line-free keys, unjustified entries rejected, syntax errors reported, the
knob registry, the generated docs, the CLI's exit codes and
``--selftest``), and adds:

- both checkers on the same fixture trees, written under each package's
  name, give the same findings for ``knob-registry``,
  ``estimator-contract``, ``obs-schema`` and ``lock-discipline``;
- the torch ``rng-discipline`` fires on a draw without ``generator=`` and
  on ``torch.manual_seed``, and stays quiet with ``generator=``;
- ``jit-purity`` raises a ``KeyError`` that says why it is not ported;
- the shipped port tree is lint-clean under its committed baseline, every
  entry justified, and ``--check-docs`` is clean;
- the eight classes shared between threads declare ``_GUARDED_BY``, the
  JAX package's maps less attributes the port does not keep.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

from sq_learn_tpu.analysis import get_rules as jax_get_rules
from sq_learn_tpu.analysis import run as jax_run
from sq_learn_tpu.analysis.selftest import FIXTURES as JAX_FIXTURES
from sq_learn_tpu_torch import _knobs, config_context
from sq_learn_tpu_torch.analysis import (ALL_RULES, NOT_PORTED, Finding,
                                         get_rules, load_baseline, run)
from sq_learn_tpu_torch.analysis.core import match_baseline
from sq_learn_tpu_torch.analysis.docs import (DOCS_RELPATH, check_docs,
                                              load_registry_module,
                                              render_knob_table)
from sq_learn_tpu_torch.analysis.rules.knobs import (parse_registry,
                                                     resolve_name)
from sq_learn_tpu_torch.analysis.selftest import (_KNOBS_FIXTURE,
                                                  _SCHEMA_FIXTURE, FIXTURES,
                                                  run_fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "sq_learn_tpu_torch", "analysis",
                        "baseline.json")
SHARED = ("knob-registry", "estimator-contract", "obs-schema",
          "lock-discipline")


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


# ---------------------------------------------------------------- rules

@pytest.mark.parametrize("rule_name", sorted(FIXTURES))
def test_rule_fires_on_bad_fixture(rule_name, tmp_path):
    bad, expected, _ = FIXTURES[rule_name]
    findings = run_fixture(rule_name, bad, base=str(tmp_path))
    assert findings, f"{rule_name} silent on its bad fixture"
    text = "\n".join(f.message for f in findings)
    for fragment in expected:
        assert fragment in text
    assert all(f.rule == rule_name for f in findings)


@pytest.mark.parametrize("rule_name", sorted(FIXTURES))
def test_rule_quiet_on_good_fixture(rule_name, tmp_path):
    _, _, good = FIXTURES[rule_name]
    findings = run_fixture(rule_name, good, base=str(tmp_path))
    # the shared fixture registry carries one intentionally-dead knob
    # (exercised by the knob-registry bad case)
    real = [f for f in findings if "SQ_DEAD" not in f.message]
    assert real == [], [f.message for f in real]


def test_all_rules_have_selftest_fixtures():
    assert {r.name for r in ALL_RULES} == set(FIXTURES)
    # the JAX package's rules, less the one with no object in the port
    assert {r.name for r in ALL_RULES} | set(NOT_PORTED) == set(JAX_FIXTURES)


def test_unknown_rule_name_raises():
    with pytest.raises(KeyError):
        get_rules(["no-such-rule"])


def test_jit_purity_raises_with_its_reason():
    with pytest.raises(KeyError, match="not ported: the port compiles "
                                       "nothing"):
        get_rules(["jit-purity"])
    with pytest.raises(KeyError, match="jit-purity"):
        get_rules(["knob-registry", "jit-purity"])


def test_syntax_error_is_reported_not_raised(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    findings, errors = run([str(bad)], get_rules(["rng-discipline"]),
                           root=str(tmp_path))
    assert findings == []
    assert len(errors) == 1 and "broken.py" in errors[0]


# ------------------------------------------ the shared rules against JAX

def _write_tree(base, package, body):
    """A fixture package ``package`` under ``base``: the fixture registry,
    the fixture schema and ``mod.py`` holding ``body``."""
    pkg = os.path.join(base, package)
    os.makedirs(os.path.join(pkg, "obs"))
    for rel, text in (("__init__.py", ""), ("obs/__init__.py", ""),
                      ("_knobs.py", _KNOBS_FIXTURE),
                      ("obs/schema.py", _SCHEMA_FIXTURE),
                      ("mod.py", body)):
        with open(os.path.join(pkg, rel), "w") as fh:
            fh.write(text)
    return pkg


def _normalized(findings, package):
    return sorted(
        (f.rule, f.path.replace(package, "PKG"), f.line,
         f.message.replace(package, "PKG"))
        for f in findings)


@pytest.mark.parametrize("which", ["bad", "good"])
@pytest.mark.parametrize("rule_name", SHARED)
def test_shared_rule_findings_equal_jax(rule_name, which, tmp_path):
    # the four shared rules keep the JAX package's fixtures verbatim
    assert FIXTURES[rule_name] == JAX_FIXTURES[rule_name]
    bad, _, good = FIXTURES[rule_name]
    body = bad if which == "bad" else good
    out = {}
    for package, runner, rules in (
            ("sq_learn_tpu", jax_run, jax_get_rules),
            ("sq_learn_tpu_torch", run, get_rules)):
        root = str(tmp_path / package)
        pkg = _write_tree(root, package, body)
        findings, errors = runner([pkg], rules([rule_name]), root=root)
        assert errors == []
        out[package] = _normalized(findings, package)
    assert out["sq_learn_tpu_torch"] == out["sq_learn_tpu"]
    if which == "bad":
        assert out["sq_learn_tpu"]


def test_shared_rules_agree_on_a_mixed_tree(tmp_path):
    """Every shared rule at once over one tree that holds all four bad
    fixtures (one module each)."""
    out = {}
    for package, runner, rules in (
            ("sq_learn_tpu", jax_run, jax_get_rules),
            ("sq_learn_tpu_torch", run, get_rules)):
        root = str(tmp_path / package)
        pkg = _write_tree(root, package, "")
        for rule_name in SHARED:
            with open(os.path.join(pkg, rule_name.replace("-", "_")
                                   + ".py"), "w") as fh:
                fh.write(FIXTURES[rule_name][0])
        findings, errors = runner([pkg], rules(list(SHARED)), root=root)
        assert errors == []
        out[package] = _normalized(findings, package)
    assert out["sq_learn_tpu_torch"] == out["sq_learn_tpu"]
    assert {f[0] for f in out["sq_learn_tpu"]} == set(SHARED)


# ------------------------------------------------ the torch rng rule

@pytest.mark.parametrize("line,fragment", [
    ("u = torch.rand((n,))", "torch.rand(...) draws from torch's default"),
    ("u = torch.randn(n, 3)", "torch.randn(...) draws"),
    ("u = torch.randint(0, 5, (n,))", "torch.randint(...) draws"),
    ("u = torch.multinomial(p, 2)", "torch.multinomial(...) draws"),
    ("u = torch.binomial(c, p)", "torch.binomial(...) draws"),
    ("u = torch.normal(0.0, 1.0, (n,))", "torch.normal(...) draws"),
    ("u = torch.bernoulli(p)", "torch.bernoulli(...) draws"),
    ("u = torch.poisson(p)", "torch.poisson(...) draws"),
    ("u = th.randperm(n)", "torch.randperm(...) draws"),
    ("u = torch.empty(n).uniform_()", ".uniform_(...) draws"),
    ("u = torch.empty(n).normal_(0, 1)", ".normal_(...) draws"),
    ("u = torch.empty(n).exponential_()", ".exponential_(...) draws"),
    ("u = torch.manual_seed(0)", "torch.manual_seed(...) touches torch's "
                                 "global seed"),
    ("u = torch.cuda.manual_seed(0)", "torch.cuda.manual_seed(...) "
                                      "touches"),
    ("u = np.random.rand(n)", "np.random.rand(...) uses the module-global"),
    ("u = random.random()", "random.random(...) uses the stdlib global"),
])
def test_rng_rule_fires(line, fragment, tmp_path):
    body = (f"import random\nimport numpy as np\nimport torch\n"
            f"import torch as th\n\ndef f(n, p, c):\n    {line}\n"
            f"    return u\n")
    findings = run_fixture("rng-discipline", body, base=str(tmp_path))
    assert len(findings) == 1 and fragment in findings[0].message


@pytest.mark.parametrize("line", [
    "u = torch.rand((n,), generator=g)",
    "u = th.randperm(n, generator=g, device=p.device)",
    "u = torch.multinomial(p, 2, replacement=True, generator=g)",
    "u = torch.empty(n).exponential_(generator=g).log_()",
    "u = g.manual_seed(7)",
    "u = np.random.default_rng(7).normal(size=n)",
    "u = torch.empty(n).fill_(1.0)",
])
def test_rng_rule_quiet_with_a_generator(line, tmp_path):
    body = (f"import numpy as np\nimport torch\nimport torch as th\n\n"
            f"def f(n, p, g):\n    {line}\n    return u\n")
    assert run_fixture("rng-discipline", body, base=str(tmp_path)) == []


def test_rng_rule_allowlist(tmp_path):
    pkg = tmp_path / "pkg" / "utils"
    pkg.mkdir(parents=True)
    for name in ("random.py", "validation.py", "other.py"):
        (pkg / name).write_text("import torch\ntorch.manual_seed(0)\n")
    findings, _ = run([str(tmp_path / "pkg")],
                      get_rules(["rng-discipline"]), root=str(tmp_path))
    assert [f.path for f in findings] == [os.path.join("pkg", "utils",
                                                       "other.py")]


# ------------------------------------------------------------- baseline

def _mk(rule, path, message):
    return Finding(rule, path, 7, message)


def test_baseline_split_fresh_suppressed_stale():
    findings = [_mk("r1", "a.py", "m1"), _mk("r1", "a.py", "m2")]
    baseline = [
        {"rule": "r1", "path": "a.py", "message": "m1",
         "justification": "known"},
        {"rule": "r9", "path": "gone.py", "message": "old",
         "justification": "stale"},
    ]
    fresh, suppressed, stale = match_baseline(findings, baseline)
    assert [f.message for f in fresh] == ["m2"]
    assert [f.message for f in suppressed] == ["m1"]
    assert [e["message"] for e in stale] == ["old"]


def test_baseline_key_is_line_free():
    findings = [_mk("r", "p.py", "m"), Finding("r", "p.py", 99, "m")]
    baseline = [{"rule": "r", "path": "p.py", "message": "m",
                 "justification": "both"}]
    fresh, suppressed, stale = match_baseline(findings, baseline)
    assert fresh == [] and stale == [] and len(suppressed) == 2


def test_load_baseline_rejects_missing_justification(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps([{"rule": "r", "path": "p", "message": "m"}]))
    with pytest.raises(ValueError):
        load_baseline(str(p))


def test_committed_baseline_entries_are_justified():
    entries = load_baseline(BASELINE)
    assert 0 < len(entries) <= 10
    for e in entries:
        assert e["justification"] and "TODO" not in e["justification"]
        assert e["path"].startswith("sq_learn_tpu_torch/")


# -------------------------------------------------- knob registry

def test_registry_round_trip(monkeypatch):
    monkeypatch.setenv("SQ_OOC_SHARD_BYTES", "1024")
    assert _knobs.get_int("SQ_OOC_SHARD_BYTES") == 1024
    monkeypatch.delenv("SQ_OOC_SHARD_BYTES")
    assert _knobs.get_int("SQ_OOC_SHARD_BYTES") == (8 << 20)
    assert _knobs.get_int("SQ_OOC_SHARD_BYTES", 5) == 5
    monkeypatch.setenv("SQ_GPU_PEAK_FLOPS", "1e14")
    assert _knobs.get_float("SQ_GPU_PEAK_FLOPS") == 1e14


def test_flag_semantics(monkeypatch):
    monkeypatch.delenv("SQ_OBS", raising=False)
    assert _knobs.get_bool("SQ_OBS") is False
    monkeypatch.setenv("SQ_OBS", "1")
    assert _knobs.get_bool("SQ_OBS") is True
    monkeypatch.setenv("SQ_OBS", "yes")
    assert _knobs.get_bool("SQ_OBS") is False
    monkeypatch.delenv("SQ_SERVE_CACHE", raising=False)
    assert _knobs.get_bool("SQ_SERVE_CACHE") is True
    monkeypatch.setenv("SQ_SERVE_CACHE", "0")
    assert _knobs.get_bool("SQ_SERVE_CACHE") is False


def test_unregistered_knob_read_raises():
    with pytest.raises(_knobs.UnknownKnobError):
        _knobs.get_raw("SQ_NOT_A_KNOB")
    # the JAX package's override of its TPU peak is not the port's knob
    with pytest.raises(_knobs.UnknownKnobError):
        _knobs.get_raw("SQ_TPU_PEAK_FLOPS")


def test_family_resolution():
    # the port registers no family; the rule's static parse still
    # resolves one on a registry that does
    entries, families = parse_registry(
        _KNOBS_FIXTURE.replace(
            '_K("SQ_DEAD"', '_K("SQ_TOL_*", "float", None, "lib", "f", '
                            'None),\n    _K("SQ_DEAD"'))
    assert families == ("SQ_TOL_*",)
    assert resolve_name("SQ_TOL_LATENCY", entries, families) == "SQ_TOL_*"
    assert resolve_name("SQ_GOOD", entries, families) == "SQ_GOOD"
    assert resolve_name("SQ_NOPE", entries, families) is None
    assert _knobs.resolve("SQ_NOPE") is None


def test_no_raw_env_reads_outside_registry():
    findings, errors = run(
        [os.path.join(REPO, "sq_learn_tpu_torch")],
        get_rules(["knob-registry"]), root=REPO)
    assert errors == []
    assert findings == [], [str(f) for f in findings]


# ------------------------------------------------------------ docs

def test_knob_table_render_and_drift_gate():
    mod = load_registry_module(REPO)
    rendered = render_knob_table(mod)
    with open(os.path.join(REPO, DOCS_RELPATH)) as fh:
        committed = fh.read()
    assert rendered == committed, (
        f"{DOCS_RELPATH} drifted — regenerate with `python -m "
        f"sq_learn_tpu_torch.analysis --docs > {DOCS_RELPATH}`")
    for k in mod.iter_knobs():
        assert f"`{k.name}`" in rendered
    assert "`SQ_GPU_PEAK_FLOPS`" in rendered


def test_check_docs_clean_at_head():
    assert check_docs(REPO) == []


def test_check_docs_flags_unregistered_token(tmp_path):
    (tmp_path / "sq_learn_tpu_torch").mkdir()
    with open(os.path.join(REPO, "sq_learn_tpu_torch", "_knobs.py")) as fh:
        (tmp_path / "sq_learn_tpu_torch" / "_knobs.py").write_text(
            fh.read())
    (tmp_path / "docs" / "torch").mkdir(parents=True)
    (tmp_path / "docs" / "torch" / "notes.md").write_text(
        "set SQ_IMAGINARY_KNOB=1 to win\n")
    problems = check_docs(str(tmp_path))
    assert any("SQ_IMAGINARY_KNOB" in p for p in problems)
    assert any("is missing" in p for p in problems)


# --------------------------------------------------------- self-run

def test_shipped_tree_is_lint_clean():
    baseline = load_baseline(BASELINE)
    findings, errors = run(
        [os.path.join(REPO, "sq_learn_tpu_torch")], get_rules(), root=REPO)
    assert errors == []
    fresh, _suppressed, stale = match_baseline(findings, baseline)
    assert fresh == [], [str(f) for f in fresh]
    assert stale == [], [e["message"] for e in stale]


def test_obs_schema_record_types_export():
    from sq_learn_tpu_torch.obs import schema
    assert isinstance(schema.RECORD_TYPES, tuple)
    assert "counter" in schema.RECORD_TYPES
    assert len(schema.RECORD_TYPES) == len(set(schema.RECORD_TYPES))


#: (module, class) of the port's classes shared between threads, and the
#: JAX package's counterpart
GUARDED = [
    ("obs.storage", "StorageLedger"),
    ("obs.budget", "BudgetLedger"),
    ("oocore.prefetch", "ShardPrefetcher"),
    ("serving.dispatcher", "_BufferPool"),
    ("serving.dispatcher", "MicroBatchDispatcher"),
    ("serving.control", "Controller"),
    ("resilience.supervisor", "CircuitBreaker"),
    ("utils.checkpoint", "AsyncStreamCheckpointer"),
]


@pytest.mark.parametrize("module,name", GUARDED)
def test_thread_shared_classes_declare_guarded_maps(module, name):
    ours = getattr(importlib.import_module(f"sq_learn_tpu_torch.{module}"),
                   name)
    theirs = getattr(importlib.import_module(f"sq_learn_tpu.{module}"),
                     name)
    assert "_GUARDED_BY" in vars(ours)
    assert set(ours._GUARDED_BY) == set(theirs._GUARDED_BY)
    for lock, attrs in ours._GUARDED_BY.items():
        assert attrs and set(attrs) <= set(theirs._GUARDED_BY[lock])
        missing = set(theirs._GUARDED_BY[lock]) - set(attrs)
        # MicroBatchDispatcher keeps no _sites_seen; nothing else is left out
        assert missing == ({"_sites_seen"}
                           if name == "MicroBatchDispatcher" else set())
    assert set(getattr(ours, "_ASSUMES_LOCK", ())) == set(
        getattr(theirs, "_ASSUMES_LOCK", ()))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "sq_learn_tpu_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_exit_codes(tmp_path):
    ok = _cli("--root", REPO)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 fresh" in ok.stdout and "0 stale" in ok.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport torch\nV = os.environ.get('SQ_X')\n"
                   "torch.manual_seed(0)\n")
    red = _cli("--root", REPO, "--no-baseline", str(bad))
    assert red.returncode == 1, red.stdout + red.stderr
    assert "raw environment read" in red.stdout
    assert "touches torch's global seed" in red.stdout


def test_cli_selftest_and_check_docs():
    selftest = _cli("--selftest")
    assert selftest.returncode == 0, selftest.stdout + selftest.stderr
    assert f"all {len(FIXTURES)} rules fire" in selftest.stdout
    docs = _cli("--root", REPO, "--check-docs")
    assert docs.returncode == 0, docs.stdout + docs.stderr
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [line.split()[0] for line in listed.stdout.splitlines()] == [
        r.name for r in ALL_RULES]
