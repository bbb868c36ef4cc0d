"""The port's elastic-world smoke on the CPU (``python -m
sq_learn_tpu_torch.parallel.elastic_smoke --device cpu``): exit 0, an
``ok`` summary with no error (the simulator at 1, 2 and 3 hosts, a real
2-worker fit and a real 3-worker fit with a SIGKILL, each bit-equal to
the simulator), and a merged fleet timeline the port's schema validates
and ``obs fleet`` reconciles. The JAX package's smoke cannot run here
(``sq_learn_tpu/parallel/distributed.py`` imports
``jaxlib.xla_extension``, which this jaxlib lacks: ROADMAP.md §3), so the
smoke's final state is held against the JAX package's in-process
simulator, ``elastic_fit_local``, on the same store: bit for bit.

Leases are 10 s (``SQ_ELASTIC_LEASE_S=10``) so that a loaded test
machine cannot declare a live peer dead; the checks are bits and the
fold ledger, never times."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_smoke_helpers import (REPO, assert_ok, child_env,  # noqa: E402
                                  run_port, validate)

#: the smoke's store and fit (sq_learn_tpu_torch/parallel/elastic_smoke.py)
ROWS, SHARD_BYTES, K, SEED, EPOCHS, WINDOW = 240, 6 * 48, 4, 5, 2, 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    artifact = tmp_path_factory.mktemp("port_elastic") / "merged.jsonl"
    out, summary = run_port("parallel.elastic_smoke", "elastic_smoke",
                            artifact, SQ_ELASTIC_LEASE_S="10")
    return out, summary, artifact


@pytest.fixture(scope="module")
def jax_simulator(tmp_path_factory):
    from sq_learn_tpu.oocore.store import open_store, store_from_array
    from sq_learn_tpu.parallel import elastic as jax_elastic

    X = np.asarray(np.random.default_rng(11).normal(size=(ROWS, 6)),
                   np.float64)
    path = str(tmp_path_factory.mktemp("jax_elastic") / "store")
    store_from_array(path, X, shard_bytes=SHARD_BYTES)
    return {n: jax_elastic.elastic_fit_local(
        open_store(path), K, n_hosts=n, seed=SEED, epochs=EPOCHS,
        window=WINDOW) for n in (1, 2, 3)}


def test_the_port_smoke_holds_its_contract(port):
    out, summary, _ = port
    assert_ok(out, summary, "elastic_smoke")
    assert summary["device"] == "cpu"
    assert summary["launches"] == {"lloyd_step": 0, "argkmin": 0}
    assert summary["uninterrupted"]["generation"] == 0
    killed = summary["killed"]
    assert (killed["generation"], killed["n_hosts"], killed["shrinks"]) \
        == (1, 2, 1)
    assert killed["killed"] == [2] and killed["exit_codes"]["2"] == -9


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_the_final_state_is_the_jax_simulators(port, jax_simulator,
                                               n_hosts):
    state = port[1]["state"]
    want = jax_simulator[n_hosts]
    np.testing.assert_array_equal(np.asarray(state["centers"]),
                                  want["centers"])
    np.testing.assert_array_equal(np.asarray(state["counts"]),
                                  want["counts"])
    np.testing.assert_array_equal(np.asarray(state["folds"]), want["folds"])
    assert state["inertia"] == want["inertia"]


def test_the_merged_timeline_validates_and_reconciles(port):
    _, summary, artifact = port
    assert summary["merged"] == str(artifact)
    errors, by_type = validate(artifact)
    assert errors == []
    assert by_type.get("elastic", 0) > 0 and by_type.get("clock", 0) > 0
    rc = summary["fleet"]["reconciliation"]
    assert rc["ok"] and rc["windows"] == EPOCHS * -(-summary["n_shards"]
                                                    // WINDOW)
    out = subprocess.run(
        [sys.executable, "-m", "sq_learn_tpu_torch.obs", "fleet",
         str(artifact), "--json"], cwd=REPO, env=child_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["reconciliation"]["ok"]
