"""Worker of ``tests/test_torch_elastic_world.py``'s generation tests, in
the shape of ``tests/_elastic_worker.py``::

    python tests/_torch_elastic_worker.py reinit <pid> <port_g0> <port_g1> <repo>
    python tests/_torch_elastic_worker.py mismatch <pid> <port> <repo>

``reinit``: join generation 0 of an elastic world whose stores the test
hosts, prove a same-generation re-initialize is a no-op and a DIFFERENT
generation while live raises, sum over the world's mesh (2 CPU shards per
process, gloo), ``shutdown()``, join generation 1 on a new store in the
SAME process and sum again. Worker 1 joins without a fleet run id and
must adopt worker 0's through the world's store; each join stamps the
generation, and the shard flushed before ``os._exit`` carries the
envelope on disk.

``mismatch``: two workers carry generations 0 and 1 to one store —
whichever publishes the generation first wins, the other gets
:class:`GenerationMismatchError`, never a hang.

Workers leave through ``os._exit``, as the elastic world's workers do.
"""

import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, sys.argv[-1])  # the repository root

import torch  # noqa: E402


def world_sum(nproc):
    """One real cross-process collective on the CURRENT world: the sum of
    each shard's two ones over the world's mesh."""
    from sq_learn_tpu_torch.parallel import distributed as dist

    mesh = dist.global_mesh()
    assert mesh.size == 2 * nproc, mesh
    return float(mesh.psum([torch.ones(2).sum() for _ in mesh.devices]))


def main():
    mode, pid = sys.argv[1], int(sys.argv[2])
    from sq_learn_tpu_torch import set_config
    from sq_learn_tpu_torch.parallel import distributed as dist

    set_config(device="cpu")
    if mode == "reinit":
        import tempfile

        from sq_learn_tpu_torch import obs
        from sq_learn_tpu_torch.obs import recorder as obs_recorder

        addr0 = f"127.0.0.1:{sys.argv[3]}"
        addr1 = f"127.0.0.1:{sys.argv[4]}"
        obs_path = os.path.join(
            tempfile.mkdtemp(prefix=f"sq_fleet_w{pid}_"),
            f"obs.w{pid}.jsonl")
        obs.enable(obs_path)
        obs_recorder.set_fleet("fleet-mp-test" if pid == 0 else None,
                               host=f"w{pid}")
        cpus = ["cpu"] * 2
        if pid != 0:
            # worker 0 publishes the fleet run id as it joins, and a member
            # that joins without one waits only 1 s to adopt it: join after
            # it is there, since a loaded machine can start worker 0
            # seconds after worker 1
            import datetime

            from torch.distributed import TCPStore

            TCPStore("127.0.0.1", int(sys.argv[3]), is_master=False,
                     timeout=datetime.timedelta(seconds=60)).wait(
                         ["fleet/run_id"])
        dist.initialize(addr0, 2, pid, generation=0, elastic=True,
                        devices=cpus, timeout_s=60)
        rec = obs_recorder.get_recorder()
        assert rec.fleet_run_id == "fleet-mp-test", rec.fleet_run_id
        assert rec.fleet_generation == 0, rec.fleet_generation
        # the same generation again: a no-op
        dist.initialize(addr0, 2, pid, generation=0, elastic=True,
                        devices=cpus)
        try:
            dist.initialize(addr1, 2, pid, generation=1, elastic=True,
                            devices=cpus)
        except RuntimeError as exc:
            assert "shutdown" in str(exc), exc
        else:
            print(f"worker {pid} FAIL: live-world re-init did not raise",
                  flush=True)
            os._exit(1)
        assert dist.generation() == 0 and dist.world_client() is not None
        assert world_sum(2) == 8.0
        dist.shutdown()
        assert dist.generation() is None and dist.world_client() is None
        # the SAME process forms the next generation
        dist.initialize(addr1, 2, pid, generation=1, elastic=True,
                        devices=cpus, timeout_s=60)
        assert dist.generation() == 1
        assert obs_recorder.get_recorder().fleet_generation == 1
        assert world_sum(2) == 8.0
        dist.shutdown()
        # the durable flush before os._exit, then the envelope on disk
        # (the meta record predates worker 1's adoption: stamped only)
        obs_recorder.record_span("fleet_mp_probe", 0.0)
        assert obs_recorder.flush(fsync=True) is True
        obs.disable()
        with open(obs_path) as f:
            envs = [json.loads(line).get("fleet") for line in f]
        stamped = [e for e in envs if e]
        assert stamped and all(e["run_id"] == "fleet-mp-test"
                               and e["host"] == f"w{pid}"
                               for e in stamped), envs
        print(f"worker {pid} REINIT OK", flush=True)
        os._exit(0)

    if mode == "mismatch":
        addr = f"127.0.0.1:{sys.argv[3]}"
        try:
            dist.initialize(addr, 2, pid, generation=pid, elastic=True,
                            timeout_s=60)
        except dist.GenerationMismatchError as exc:
            assert "refusing" in str(exc), exc
            assert dist.generation() is None
            print(f"worker {pid} MISMATCH", flush=True)
            os._exit(0)
        assert dist.generation() == pid
        dist.shutdown(barrier=False)  # the refused peer reaches no barrier
        print(f"worker {pid} JOINED", flush=True)
        os._exit(0)

    print(f"worker {pid} FAIL: unknown mode {mode!r}", flush=True)
    os._exit(2)


if __name__ == "__main__":
    main()
