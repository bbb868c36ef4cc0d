"""The port's q-means, streaming and mesh drivers (``examples_torch/``)
against the JAX package's (``examples/``), on the CPU, and the port's
CSV stream against the JAX package's.

Each driver runs twice at the same arguments: the JAX driver in a
subprocess (``JAX_PLATFORMS=cpu``, offline), the port's ``main([...,
"--device", "cpu"])`` in this process. The port prints the JAX driver's
lines (numbers masked), and its numbers are held to the JAX driver's.
jax threefry and torch Philox draws never match, so a k-means++ init or a
δ-window pick differs between the drivers: where a number follows such a
draw it is held in distribution, against the range the JAX package's own
number spans over random_state 0–9 (0–11 for the runtime study), measured
by this file's script mode and written below:

- ``delta_tradeoff`` at its defaults (20 000 × 78, n_init=10): shape and
  k equal; at every δ the port's ARI within SWEEP_MARGIN of JAX_SWEEP_ARI
  (the JAX package's ARI range at that δ).
- ``runtime_tradeoff`` (3 072 × 32, fixed): leg 1's ARI within
  RT_MARGIN of JAX_RT_ARI, its ``quantum_runtime_model`` at rtol 1e-3
  (the printed precision); leg 2's holdout 1-NN accuracy within
  ``acc_tol`` of 1 536 queries, ``accumulate_q_runtime`` at rtol 1e-3; the
  audit flags nothing, records the JAX package's sites with the same
  draws at each but ``sketch.stats`` (the port computes a fit's
  statistics on every fit, ``sketch/cache.py``; the JAX package serves
  repeats from its digest cache); the artifact validates and ``python -m
  sq_learn_tpu_torch.obs frontier`` renders the printed table.
- ``streaming_fit``: ``n_steps_`` at the checkpoint and at the end equal;
  both inertias within STREAM_INERTIA_RTOL of JAX_STREAM_INERTIA's range;
  the first 10 rows' labels the same partition; and the resumed fit
  bit-equal to an uninterrupted ingest of the same file.
- ``sharded_fit`` at 4 shards (the JAX driver under
  ``--xla_force_host_platform_device_count=4``): the mesh line, q-means'
  ``n_iter_`` and cluster count equal and its inertia at rtol 1e-4 (the
  blobs lie so far apart that the δ-window moves no label), the qPCA
  explained-variance ratio and TruncatedSVD's σ₁ at rtol 1e-4, the
  quantum transform's shape and the exact 5-NN accuracy equal.
- ``csv_stream_batches`` equal to the JAX package's, native and NumPy,
  on a file with a blank line, a whitespace-only line, a non-numeric
  field, an extra field and a short last batch.
- Every driver of the port raises without CUDA when ``--device`` is not
  given (the configured device is the card).

Run as a script from the repository root (``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_examples_qkmeans.py``, ~5 min,
~2 GB) it measures the JAX package's ranges above and the numbers
``chip_smoke.py``'s ``examples`` phase holds the card to.
"""

import contextlib
import io
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_examples_helpers import (acc_tol, line_after,  # noqa: E402
                                     load_driver, masked, numbers,
                                     run_jax_driver)

DELTAS = (0.0, 0.1, 0.3, 0.5, 1.0)
RT_DELTAS = (0.0, 2.0, 8.0, 32.0)
RT_ERRS = (0.4, 1.6, 6.4)
SEEDS = range(10)
RT_SEEDS = range(12)

#: the JAX package's δ-sweep ARI (min, max) over random_state 0–9 at
#: delta_tradeoff's defaults (this file's script mode)
JAX_SWEEP_ARI = {0.0: (1.0, 1.0), 0.1: (1.0, 1.0),
                 0.3: (0.9106336396931322, 0.9960908900559725),
                 0.5: (0.8068788074629861, 0.845357319176317),
                 1.0: (0.7701114062424389, 0.7996688268417864)}
SWEEP_MARGIN = 0.03
#: leg 1 of runtime_tradeoff: the JAX package's ARI (min, max) over
#: random_state 0–11
JAX_RT_ARI = {0.0: (0.7724104510582867, 1.0),
              2.0: (0.7724360514789496, 1.0),
              8.0: (0.7724144511740647, 1.0),
              32.0: (0.7724360514789496, 0.998438008626302)}
RT_MARGIN = 0.01
#: streaming_fit's inertia (min, max) over MiniBatchQKMeans random_state
#: 0–9, at the checkpoint and at the end: ten draws within 1e-7 of each
#: other (the blobs lie far apart)
JAX_STREAM_INERTIA = {"saved": (12373.373046875, 12373.3740234375),
                      "end": (6592.65869140625, 6592.6591796875)}
STREAM_INERTIA_RTOL = 1e-4


def port_run(name, args):
    """(printed text, returned dict) of the port's driver on the CPU."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = load_driver(name).main([*args, "--device", "cpu"])
    return buf.getvalue(), result


def within(value, span, margin):
    lo, hi = span
    return lo - margin <= value <= hi + margin


@pytest.fixture(scope="module")
def sweep_runs():
    return run_jax_driver("delta_tradeoff.py"), *port_run("delta_tradeoff",
                                                          ())


@pytest.fixture(scope="module")
def runtime_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime")
    jax_out = run_jax_driver("runtime_tradeoff.py", "--out",
                             str(tmp / "jax.jsonl"))
    return jax_out, *port_run("runtime_tradeoff",
                              ("--out", str(tmp / "port.jsonl")))


@pytest.fixture(scope="module")
def stream_runs():
    return run_jax_driver("streaming_fit.py"), *port_run("streaming_fit", ())


@pytest.fixture(scope="module")
def sharded_runs():
    jax_out = run_jax_driver(
        "sharded_fit.py",
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    return jax_out, *port_run("sharded_fit", ("--shards", "4"))


# -- delta_tradeoff ------------------------------------------------------------


def _sweep_table(text):
    """{δ: ARI} of a δ-sweep's printed table."""
    rows = {}
    for line in text.splitlines():
        if line.count("|") == 3 and "ARI" not in line:
            delta, ari, _ = numbers(line)[:3]
            rows[delta] = ari
    return rows


def test_delta_tradeoff_prints_the_jax_drivers_lines(sweep_runs):
    jax_out, port_out, _ = sweep_runs
    assert masked(port_out) == masked(jax_out)


def test_delta_tradeoff_numbers_agree(sweep_runs):
    jax_out, _, port = sweep_runs
    assert port["shape"] == (20000, 78) and port["k"] == 6
    assert line_after(jax_out, "dataset:").startswith("dataset: 20000x78, k=6")
    jax_rows = _sweep_table(jax_out)
    assert sorted(jax_rows) == sorted(port["sweep"]) == list(DELTAS)
    for delta in DELTAS:
        # the constants hold the JAX driver's own draw
        assert within(jax_rows[delta], JAX_SWEEP_ARI[delta], 0.0005)
        assert within(port["sweep"][delta]["ari"], JAX_SWEEP_ARI[delta],
                      SWEEP_MARGIN), (delta, port["sweep"][delta])
    assert port["sweep"][0.0]["ari"] == pytest.approx(1.0)


# -- runtime_tradeoff ----------------------------------------------------------


def _runtime_legs(text):
    """({δ: (ARI, q_runtime or None)}, {ε+δ: (accuracy, q_runtime)})."""
    leg1, leg2 = {}, {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("delta="):
            vals = numbers(line)
            leg1[vals[0]] = (vals[1], vals[2] if len(vals) > 2 else None)
        elif line.startswith("eps+delta="):
            err, acc, q_rt = numbers(line)
            leg2[err] = (acc, q_rt)
    return leg1, leg2


def _audit_sites(text):
    """{site: draws} of a printed guarantee audit."""
    sites = {}
    for line in text.split("guarantee audit")[1].split(
            "accuracy vs")[0].splitlines():
        if "over tol" in line:
            sites[line.split("declared")[1].split()[1]] = int(
                line.split("/")[1].split()[0])
    return sites


def test_runtime_tradeoff_prints_the_jax_drivers_lines(runtime_runs):
    jax_out, port_out, _ = runtime_runs
    head = "guarantee audit"
    assert (masked(port_out.split(head)[0])
            == masked(jax_out.split(head)[0]))
    for line in ("accuracy vs theoretical quantum runtime:",
                 "-- sweep example_qkmeans_delta --",
                 "-- sweep example_qpca_eps_delta --"):
        assert line in port_out and line in jax_out
    assert "python -m sq_learn_tpu_torch.obs frontier" in port_out


def test_runtime_tradeoff_numbers_agree(runtime_runs):
    jax_out, port_out, port = runtime_runs
    leg1, leg2 = _runtime_legs(jax_out)
    assert sorted(leg1) == list(RT_DELTAS) and sorted(leg2) == list(RT_ERRS)
    for delta, (ari, q_rt) in leg1.items():
        assert within(ari, JAX_RT_ARI[delta], 0.00005)
        point = port["qkmeans"][delta]
        assert within(point["ari"], JAX_RT_ARI[delta], RT_MARGIN), (
            delta, point)
        if q_rt is None:
            assert point["q_runtime"] is None
        else:
            assert point["q_runtime"] == pytest.approx(q_rt, rel=1e-3)
    for err, (acc, q_rt) in leg2.items():
        point = port["qpca"][err]
        assert abs(point["acc"] - acc) <= acc_tol(acc, 1536)
        assert point["q_runtime"] == pytest.approx(q_rt, rel=1e-3)
    assert port["flagged"] == []
    jax_sites, port_sites = _audit_sites(jax_out), _audit_sites(port_out)
    assert sorted(port_sites) == sorted(jax_sites)
    assert sum(port_sites.values()) == port["draws"]
    for site, draws in jax_sites.items():
        if site != "sketch.stats":
            assert port_sites[site] == draws, site


def test_runtime_tradeoff_artifact_renders_the_printed_frontier(runtime_runs):
    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.obs.__main__ import main as obs_main

    _, _, port = runtime_runs
    assert obs.schema.validate_jsonl(port["out"])["errors"] == []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert obs_main(["frontier", port["out"]]) == 0
    assert port["frontier"].strip() in buf.getvalue()


# -- streaming_fit -------------------------------------------------------------


def test_streaming_fit_prints_the_jax_drivers_lines(stream_runs):
    jax_out, port_out, _ = stream_runs
    jax_lines, port_lines = masked(jax_out), masked(port_out)
    # the first line names the file (a fresh temporary path) and the parser
    assert port_lines[0].split(" to ")[0] == jax_lines[0].split(" to ")[0]
    assert "(parser: NumPy stream)" in port_lines[0]
    assert port_lines[1:] == jax_lines[1:]


def test_streaming_fit_numbers_agree(stream_runs, tmp_path):
    jax_out, _, port = stream_runs
    saved_steps, saved_inertia = numbers(line_after(jax_out,
                                                    "checkpointed"))
    steps, inertia = numbers(line_after(jax_out, "resumed to"))
    assert port["rows"] == 20000
    assert (port["saved_steps"], port["n_steps"]) == (saved_steps, steps) \
        == (10, 20)
    for key, value, mine in (("saved", saved_inertia, port["saved_inertia"]),
                             ("end", inertia, port["inertia"])):
        lo, hi = JAX_STREAM_INERTIA[key]
        assert lo - 0.05 <= value <= hi + 0.05
        assert lo * (1 - STREAM_INERTIA_RTOL) <= mine <= hi * (
            1 + STREAM_INERTIA_RTOL), (key, mine)
    jax_labels = np.asarray(numbers(line_after(jax_out, "labels of first")
                                    .split(":")[1]), int)
    pairs = {(int(a), int(b)) for a, b in zip(jax_labels, port["labels"])}
    assert len(pairs) == len(set(jax_labels)) == len(set(port["labels"]))


def test_streaming_fit_resume_is_bit_equal_to_one_ingest(stream_runs,
                                                         tmp_path):
    """The checkpointed, reloaded and resumed stream ends where one
    uninterrupted ingest of the same file ends, bit for bit."""
    from sq_learn_tpu_torch import config_context

    _, _, port = stream_runs
    driver = load_driver("streaming_fit")
    path = str(tmp_path / "events.csv")
    driver.write_events(path)
    with config_context(device="cpu"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = driver.new_estimator()
        for batch in driver.csv_stream_batches(path, batch_rows=1024):
            est.partial_fit(batch)
    assert est.n_steps_ == port["n_steps"]
    np.testing.assert_array_equal(est.cluster_centers_, port["centers"])
    assert est.inertia_ == port["inertia"]


_CSV = ("a,b,c\n"
        "1,2,3\n"
        "\n"
        "4.5,x7,6e1\n"
        "   \t\n"
        "7,8,9,10\n"
        "inf,-nan,1_000\n"
        "-1.5e-2,,.5\n"
        "10,11\n")


@pytest.mark.parametrize("native", [True, False])
def test_csv_stream_matches_the_jax_packages(tmp_path, monkeypatch, native):
    """One line of lookahead for the columns, blank and whitespace-only
    lines skipped, a non-numeric field NaN (``x7``: no numeric prefix),
    an extra field dropped, a short last batch; the same stream stops
    and resumes."""
    from sq_learn_tpu import native as jax_native

    if not native:
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    elif jax_native._load() is None:
        pytest.fail("the JAX package's native library did not load")
    path = tmp_path / "f.csv"
    path.write_text(_CSV)
    driver = load_driver("streaming_fit")
    for rows in (1, 2, 4, 100):
        mine = list(driver.csv_stream_batches(path, batch_rows=rows))
        ref = list(jax_native.csv_stream_batches(str(path), batch_rows=rows))
        assert [b.shape for b in mine] == [b.shape for b in ref]
        assert sum(len(b) for b in mine) == 6 and mine[0].shape[1] == 3
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    stream = driver.csv_stream_batches(path, batch_rows=4)
    first = next(stream)
    rest = list(stream)
    assert first.shape == (4, 3) and [b.shape for b in rest] == [(2, 3)]
    assert np.isnan(first[1, 1]) and first[1, 2] == 60.0
    assert list(driver.csv_stream_batches(tmp_path / "f.csv", 3,
                                          skip_header=9)) == []
    with pytest.raises(ValueError, match="batch_rows"):
        driver.csv_stream_batches(path, batch_rows=0)


# -- sharded_fit ---------------------------------------------------------------


def test_sharded_fit_prints_the_jax_drivers_lines(sharded_runs):
    jax_out, port_out, _ = sharded_runs
    assert masked(port_out) == masked(jax_out)
    assert line_after(port_out, "mesh:") == line_after(jax_out, "mesh:") \
        == "mesh: 4 x cpu"


def test_sharded_fit_numbers_agree(sharded_runs):
    jax_out, _, port = sharded_runs
    inertia, n_iter, clusters = numbers(line_after(jax_out, "q-means:"))
    assert port["n_iter"] == n_iter and port["clusters"] == clusters == 5
    assert port["inertia"] == pytest.approx(inertia, rel=1e-4)
    evr = numbers(line_after(jax_out, "qPCA: explained"))[-1]
    assert port["explained_variance_ratio"] == pytest.approx(evr, abs=5e-5)
    assert port["transform_shape"] == tuple(
        int(v) for v in numbers(line_after(jax_out, "qPCA quantum")))
    assert port["knn_accuracy"] == pytest.approx(
        numbers(line_after(jax_out, "sharded KNN"))[-1], abs=5e-4)
    sigma1 = numbers(line_after(jax_out, "sharded TruncatedSVD"))[-1]
    assert port["sigma1"] == pytest.approx(sigma1, rel=1e-4, abs=0.05)


# -- no card, no run -----------------------------------------------------------

DRIVERS = {"delta_tradeoff": (), "runtime_tradeoff": ("--out", "unused"),
           "streaming_fit": (), "sharded_fit": ("--shards", "2"),
           "mnist_trial": (), "qpca_demo": (), "tomography_histogram": (),
           "qpca_error_tradeoff": ()}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_raises_without_cuda(name, monkeypatch, tmp_path):
    """Without ``--device`` a driver computes on the configured device,
    the card, and raises before any work where there is none."""
    from sq_learn_tpu_torch import config_context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    driver = load_driver(name)
    with config_context(device="cuda"), pytest.raises(
            RuntimeError, match="CUDA is not available"):
        driver.main(list(DRIVERS[name]))
    assert list(tmp_path.iterdir()) == []


# -- the script mode: the JAX package's ranges and the smoke's numbers ---------


def jax_sweep_aris(seeds=SEEDS):
    """delta_tradeoff's sweep through the JAX package at each
    random_state: {δ: [ARI]}."""
    from sklearn.metrics import adjusted_rand_score

    from sq_learn_tpu.datasets import load_cicids
    from sq_learn_tpu.models import QKMeans
    from sq_learn_tpu.preprocessing import StandardScaler

    X, y, _ = load_cicids(n_samples=20_000)
    X = StandardScaler().fit_transform(X)
    out = {d: [] for d in DELTAS}
    for seed in seeds:
        for d in DELTAS:
            est = QKMeans(n_clusters=6, n_init=10, delta=d,
                          true_distance_estimate=False,
                          random_state=seed).fit(X)
            out[d].append(float(adjusted_rand_score(
                y, np.asarray(est.labels_))))
    return out


def jax_runtime_aris(seeds=RT_SEEDS):
    """runtime_tradeoff's leg 1 through the JAX package at each
    random_state: {δ: [ARI]}."""
    from sklearn.metrics import adjusted_rand_score

    from sq_learn_tpu.models import QKMeans

    rng = np.random.default_rng(0)
    k, m = 6, 32
    centers = rng.normal(scale=1.6, size=(k, m))
    X = np.concatenate([rng.normal(loc=c, scale=1.0, size=(512, m))
                        for c in centers]).astype(np.float32)
    y = np.repeat(np.arange(k), 512)
    perm = rng.permutation(len(X))
    X, y = X[perm], y[perm]
    return {d: [float(adjusted_rand_score(y, np.asarray(QKMeans(
        n_clusters=k, n_init=2, delta=d, true_distance_estimate=False,
        random_state=seed).fit(X).labels_))) for seed in seeds]
        for d in RT_DELTAS}


def jax_stream_inertias(tmp, seeds=SEEDS):
    """streaming_fit's ingest through the JAX package at each
    random_state: {"saved": [inertia after 10 batches], "end": [...]}."""
    from sq_learn_tpu.models import MiniBatchQKMeans
    from sq_learn_tpu.native import csv_stream_batches

    path = os.path.join(tmp, "events.csv")
    load_driver("streaming_fit").write_events(path)
    out = {"saved": [], "end": []}
    for seed in seeds:
        est = MiniBatchQKMeans(n_clusters=5, delta=0.3,
                               true_distance_estimate=False,
                               random_state=seed)
        for i, batch in enumerate(csv_stream_batches(path, 1024)):
            est.partial_fit(batch)
            if i == 9:
                out["saved"].append(float(est.inertia_))
        out["end"].append(float(est.inertia_))
        assert est.n_steps_ == 20
    return out


def measure():
    import tempfile

    warnings.simplefilter("ignore")
    span = lambda v: (min(v), max(v))  # noqa: E731
    sweep = jax_sweep_aris()
    print("JAX_SWEEP_ARI =", {d: span(v) for d, v in sweep.items()})
    print("  per seed:", sweep)
    rt = jax_runtime_aris()
    print("JAX_RT_ARI =", {d: span(v) for d, v in rt.items()})
    print("  per seed:", rt)
    with tempfile.TemporaryDirectory() as tmp:
        stream = jax_stream_inertias(tmp)
    print("JAX_STREAM_INERTIA =", {k: span(v) for k, v in stream.items()})
    print("  per seed:", stream)
    with tempfile.TemporaryDirectory() as tmp:
        print(run_jax_driver("runtime_tradeoff.py", "--out",
                             os.path.join(tmp, "jax.jsonl")))
    print(run_jax_driver("delta_tradeoff.py"))
    print(run_jax_driver("streaming_fit.py"))
    print(run_jax_driver(
        "sharded_fit.py",
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}))


if __name__ == "__main__":
    measure()
