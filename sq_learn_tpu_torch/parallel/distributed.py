"""The multi-process world (counterpart of the non-elastic half of
``sq_learn_tpu/parallel/distributed.py``).

One program on every process; the data axis is split over every shard of
every process; the collectives gather every process's partials
(``all_gather``) and sum all shards in global shard order
(:class:`~sq_learn_tpu_torch.parallel.mesh.Mesh`), so a fit's bits are
those of an in-process mesh with the same shard count. Typical launch
(the same script on every process)::

    from sq_learn_tpu_torch.parallel import distributed as dist

    dist.initialize("localhost:29500", num_processes=2, process_id=rank)
    mesh = dist.global_mesh()       # every shard of every process
    est = QKMeans(n_clusters=10, mesh=mesh).fit(X)

:func:`initialize` wraps ``torch.distributed.init_process_group`` over a
TCP rendezvous store: NCCL for a world on CUDA devices, gloo for one on
the CPU. Unset arguments come from the launcher's environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``, read through
:mod:`~sq_learn_tpu_torch._knobs`). The elastic world (``elastic=True``:
lease heartbeats, shrinking generations) is not ported yet: ROADMAP.md §1
item 6b.
"""

import datetime

import torch

from .. import _knobs
from .mesh import DATA_AXIS, Mesh

__all__ = [
    "generation",
    "global_mesh",
    "host_shard_bounds",
    "initialize",
    "process_info",
    "shutdown",
]

#: this process's live world, if any; ``generation`` is the world's epoch
#: (re-initialization rules below), ``devices`` its local shards
_WORLD = {"generation": None, "num_processes": None, "process_id": None,
          "address": None, "backend": None, "devices": None}


def _default_devices(backend):
    if backend == "nccl":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, generation=None, elastic=False, devices=None,
               backend=None, timeout_s=120):
    """Join (or form) a multi-process world.

    ``coordinator_address`` is ``host:port`` of the TCP rendezvous store
    (process 0 hosts it); ``num_processes`` and ``process_id`` the world
    size and this process's rank. ``devices`` are this process's shards
    (default: every visible CUDA device under NCCL, one CPU shard under
    gloo); ``backend`` defaults to NCCL when they are CUDA devices, gloo
    otherwise.

    Re-calling with the same ``generation``, or with none, while a world
    is live is a no-op; a different generation raises — call
    :func:`shutdown` first. ``elastic=True`` raises
    ``NotImplementedError``: the elastic world is ROADMAP.md §1 item 6b.
    """
    if elastic:
        raise NotImplementedError(
            "the elastic world (lease heartbeats, shrinking generations) "
            "is not ported yet: ROADMAP.md §1 item 6b")
    if _WORLD["generation"] is not None:
        if generation is None or generation == _WORLD["generation"]:
            return
        raise RuntimeError(
            f"a generation-{_WORLD['generation']} world is live in this "
            f"process; call shutdown() before re-initializing as "
            f"generation {generation}")
    import torch.distributed as dist

    if num_processes is None:
        num_processes = _knobs.get_int("WORLD_SIZE")
    if process_id is None:
        process_id = _knobs.get_int("RANK")
    if coordinator_address is None:
        host, port = _knobs.get_str("MASTER_ADDR"), _knobs.get_int(
            "MASTER_PORT")
        if host is not None and port is not None:
            coordinator_address = f"{host}:{port}"
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id, as arguments or from MASTER_ADDR/MASTER_PORT, "
            "WORLD_SIZE and RANK")
    if backend is None:
        on_cuda = (torch.cuda.is_available() if devices is None else
                   all(torch.device(d).type == "cuda" for d in devices))
        backend = "nccl" if on_cuda else "gloo"
    if devices is None:
        devices = _default_devices(backend)
    devices = [torch.device(d) for d in devices]
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _WORLD.update(generation=0 if generation is None else generation,
                  num_processes=int(num_processes),
                  process_id=int(process_id), address=coordinator_address,
                  backend=backend, devices=devices)


def shutdown():
    """Tear down this process's world so a new one can form."""
    if _WORLD["generation"] is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    for key in _WORLD:
        _WORLD[key] = None


def generation():
    """The live world's generation, or None when no world is up."""
    return _WORLD["generation"]


def _require_world():
    if _WORLD["generation"] is None:
        raise RuntimeError("no multi-process world is live; call "
                           "initialize() first")


def global_mesh(axis_name=DATA_AXIS):
    """A 1-D mesh over every shard of every process: this process's
    devices, joined to the others' through the world's process group."""
    import torch.distributed as dist

    _require_world()
    return Mesh(_WORLD["devices"], axis_name, group=dist.group.WORLD,
                process_index=_WORLD["process_id"],
                process_count=_WORLD["num_processes"])


def process_info():
    """(process_index, process_count, local shard count) of this process;
    (0, 1, 1) when no world is live."""
    if _WORLD["generation"] is None:
        return 0, 1, 1
    return (_WORLD["process_id"], _WORLD["num_processes"],
            len(_WORLD["devices"]))


def host_shard_bounds(n_rows):
    """(lo, hi, per): the rows [lo, hi) of a global dataset this process
    loads, and the uniform per-process share ``per`` it pads them to with
    zero-weight rows (every process must hold as many rows). ``per`` is
    a multiple of this process's shard count, so the global axis
    (processes · per) splits evenly over every shard."""
    p, n_proc, local = process_info()
    per = -(-n_rows // n_proc)
    per = -(-per // local) * local
    lo = min(p * per, n_rows)
    return lo, min(lo + per, n_rows), per
