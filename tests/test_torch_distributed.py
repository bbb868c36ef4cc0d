"""The port's multi-process world (``sq_learn_tpu_torch.parallel.
distributed``): two real processes over gloo on localhost, each with 2
CPU shards (``tests/_torch_dist_worker.py``, in the shape of the JAX
package's ``tests/_dist_worker.py``). Every result the workers compute on
``global_mesh()`` equals, bit for bit, the same call on a 4-shard mesh in
this process: the collectives sum all shards in global shard order
wherever the shards live. Plus the re-initialization rules and the
environment fallback, in this process."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.parallel import distributed as dist
from sq_learn_tpu_torch.parallel import make_mesh, pad_and_shard

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_dist_worker.py"
sys.path.insert(0, str(REPO / "tests"))
import _torch_dist_worker as worker  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(pid), "2", str(port), str(REPO),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{text}"
        assert f"worker {pid} OK" in text
    return [dict(np.load(out / f"worker{pid}.npz")) for pid in (0, 1)]


@pytest.fixture(scope="module")
def in_process():
    """The same calls on a 4-shard mesh in this process."""
    with config_context(device="cpu"):
        mesh = make_mesh(["cpu"] * 4)
        X = worker.dataset()[0]
        Xs, ws, _ = pad_and_shard(mesh, X)
        return worker.run(mesh, Xs, ws, X)


@pytest.mark.parametrize("name", [
    "colsum", "weight", "mean", "U", "S", "Vt",
    "lloyd0_labels", "lloyd0_inertia", "lloyd0_centers", "lloyd0_n_iter",
    "lloyd_delta_labels", "lloyd_delta_inertia", "lloyd_delta_centers",
    "kpp", "fit_labels", "fit_centers", "fit_n_iter", "knn_idx", "knn_d2"])
def test_two_process_world_equals_the_in_process_mesh(worker_results,
                                                      in_process, name):
    for got in worker_results:
        np.testing.assert_array_equal(got[name], in_process[name],
                                      err_msg=name)


def test_in_process_results_are_right(in_process):
    X, _, Xt, Q = worker.dataset()
    np.testing.assert_allclose(in_process["S"], np.linalg.svd(
        X - X.mean(axis=0), compute_uv=False), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(in_process["mean"], X.mean(axis=0),
                               rtol=1e-5, atol=1e-5)
    d2 = ((Q[:, None, :] - Xt[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(in_process["knn_idx"],
                                  np.argsort(d2, axis=1)[:, :5])
    assert in_process["lloyd0_labels"].shape == (37,)
    assert int(in_process["lloyd_delta_n_iter"]) >= 1


def test_initialize_rules_without_a_world(monkeypatch):
    assert dist.generation() is None
    assert dist.process_info() == (0, 1, 1)
    assert dist.host_shard_bounds(37) == (0, 37, 37)
    # the elastic world needs every coordinate and the generation
    with pytest.raises(ValueError, match="elastic initialize"):
        dist.initialize("localhost:1", 2, 0, elastic=True)
    assert dist.world_client() is None
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        dist.initialize()
    with pytest.raises(RuntimeError, match="initialize"):
        dist.global_mesh()
    dist.shutdown()  # no world: a no-op


def test_elastic_initialize_defaults_to_the_card(monkeypatch):
    """An elastic member given no ``devices`` takes the configured device:
    under the default config ``cuda:<process_id % cards>``, never a CPU
    mesh; without CUDA it raises before it touches the store. The CPU only
    when the caller passes it or configures it."""
    store = dist.start_coordinator_service("127.0.0.1:0")
    address = f"127.0.0.1:{store.port}"
    with config_context(device="cuda"):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                dist.initialize(address, 2, 1, generation=0, elastic=True)
            assert dist.generation() is None
            assert not store.check(["elastic/generation"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert dist.elastic_device(3) == torch.device("cuda:1")
        assert dist.elastic_device(3, "cuda:0") == torch.device("cuda:0")
        assert dist.elastic_device(3, "cpu") == torch.device("cpu")
    # (configured device, devices=, the member's device)
    for config, devices, want in [("cuda", None, "cuda:1"),
                                  ("cuda", ["cpu"], "cpu"),
                                  ("cpu", None, "cpu")]:
        with config_context(device=config):
            dist.initialize(address, 2, 1, generation=0, elastic=True,
                            devices=devices)
        try:
            assert dist._WORLD["devices"] == [torch.device(want)]
            assert dist.process_info() == (1, 2, 1)
        finally:
            dist.shutdown(barrier=False)
        assert dist.generation() is None


def test_initialize_without_devices_follows_the_configured_device(
        monkeypatch):
    """``initialize`` given no ``devices`` takes the configured device, as
    every entry point does: under the default config the card, which
    raises without CUDA before any world forms (never a gloo world on the
    CPU in its place); under ``config_context(device="cpu")`` one CPU
    shard over gloo."""
    from sq_learn_tpu_torch._config import _global_config

    assert _global_config["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dist.initialize(f"localhost:{_free_port()}", 1, 0)
        assert dist.generation() is None
    with config_context(device="cpu"):
        dist.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        assert dist._WORLD["backend"] == "gloo"
        assert dist._WORLD["devices"] == [torch.device("cpu")]
        assert dist.process_info() == (0, 1, 1)
    finally:
        dist.shutdown()
    assert dist.generation() is None
    # with cards: every visible card for a bare "cuda", one for "cuda:<i>"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with config_context(device="cuda"):
        assert dist._default_devices() == ["cuda:0", "cuda:1"]
    with config_context(device="cuda:1"):
        assert dist._default_devices() == ["cuda:1"]


def test_a_one_process_world_from_the_environment(monkeypatch):
    """WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT stand in for the arguments;
    the one-process world's mesh gives the in-process 1-shard mesh's
    bits."""
    from sq_learn_tpu_torch.parallel import lloyd_single_sharded
    from sq_learn_tpu_torch.utils import as_generator

    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with config_context(device="cpu"):
        dist.initialize(devices=["cpu"], backend="gloo")
        try:
            assert dist.generation() == 0
            assert dist.process_info() == (0, 1, 1)
            X, C0, _, _ = worker.dataset()
            Xt = torch.from_numpy(X)
            w = torch.ones(len(X))
            xsq = torch.sum(Xt * Xt, dim=1)
            got = lloyd_single_sharded(dist.global_mesh(),
                                       as_generator(0, "cpu"), Xt, w,
                                       torch.from_numpy(C0), xsq,
                                       max_iter=6, tol=0.0)
            want = lloyd_single_sharded(make_mesh(["cpu"]),
                                        as_generator(0, "cpu"), Xt, w,
                                        torch.from_numpy(C0), xsq,
                                        max_iter=6, tol=0.0)
            assert torch.equal(got[0].to_tensor(), want[0].to_tensor())
            assert torch.equal(got[2], want[2])
        finally:
            dist.shutdown()
    assert dist.generation() is None
