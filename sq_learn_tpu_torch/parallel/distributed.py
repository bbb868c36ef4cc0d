"""The multi-process world (counterpart of
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
:mod:`~sq_learn_tpu_torch._knobs`).

The elastic world (``elastic=True``, :mod:`.elastic`): a coordinator
process outside the world owns a ``torch.distributed.TCPStore``
(:func:`start_coordinator_service`), so any worker, node 0 included, may
die without taking the store with it. Each worker joins it as a client,
agrees on the generation through the store (a worker of another
generation gets :class:`GenerationMismatchError`, never a hang at the
first collective), and forms the world's process group on a
``PrefixStore`` of it at its first :func:`global_mesh` (as the JAX
package's backend forms its collectives at first use, so a member whose
peer was refused does not wait in the group's rendezvous). The group is
always gloo: NCCL refuses two ranks of one communicator on one card, and
the fold moves its partials through the store, so the group carries only
the certification's ``all_gather`` (of CUDA tensors, which gloo takes).
:func:`world_client` is the store client; :func:`shutdown` tears the
world down so the next generation can form in the same process.

The JAX package's XLA plumbing has no object here: ``_xla_extension``
and the raw distributed-runtime client (a TCPStore client takes its
place), ``_retire_client`` (a TCPStore client whose peer was SIGKILLed
does not hang its destructor), ``_select_cpu_collectives`` (gloo is a
process-group backend, chosen per world) and the elastic coordinator's
``_xla_device_flags`` (a worker's device is ``cuda:<i>`` or the CPU).
"""

import datetime

import torch

from .. import _knobs
from .mesh import DATA_AXIS, Mesh

__all__ = [
    "GenerationMismatchError",
    "connect_client",
    "elastic_device",
    "generation",
    "global_mesh",
    "host_shard_bounds",
    "initialize",
    "process_info",
    "shutdown",
    "start_coordinator_service",
    "world_client",
]

#: this process's live world, if any; ``generation`` is the world's epoch
#: (re-initialization rules below), ``devices`` its local shards,
#: ``store`` the elastic world's TCPStore client (None otherwise)
_WORLD = {"generation": None, "num_processes": None, "process_id": None,
          "address": None, "backend": None, "devices": None,
          "elastic": False, "store": None, "timeout_s": None}

#: the store key every member of an elastic world agrees on
_GEN_KEY = "elastic/generation"


class GenerationMismatchError(RuntimeError):
    """A worker tried to join a world whose agreed generation differs
    from its own — the stale-worker shape that would otherwise present
    as a hang at the first collective."""


def _split(address):
    host, port = str(address).rsplit(":", 1)
    return host, int(port)


def start_coordinator_service(address):
    """Start the elastic world's key-value store in THIS process: a
    ``torch.distributed.TCPStore`` server listening at ``address``
    (``host:port``; port 0 binds a free one, read back from the
    returned store's ``port``). It waits for no worker (the JAX
    package's service takes the world's size; the store needs none);
    keep it referenced for the life of the world."""
    import torch.distributed as dist

    host, port = _split(address)
    return dist.TCPStore(host, port, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=300))


def _connect(address, timeout_s):
    import torch.distributed as dist

    host, port = _split(address)
    return dist.TCPStore(host, port, is_master=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def _default_devices():
    """A process's shards when ``initialize`` is given none: the configured
    device (:func:`~sq_learn_tpu_torch._config.resolve_device`): every
    visible card for a bare ``cuda``, the one card for ``cuda:<i>``, one
    CPU shard for ``cpu``. A CUDA device without CUDA raises."""
    from .._config import resolve_device

    dev = resolve_device()
    if dev.type == "cuda" and dev.index is None:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


def elastic_device(index, device=None):
    """An elastic member's device: ``device``, else the configured one
    (:func:`~sq_learn_tpu_torch._config.resolve_device`), where a bare
    ``cuda`` becomes ``cuda:<index % cards>`` so the members of a world
    spread over the visible cards. A CUDA device without CUDA raises."""
    from .._config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(
            f"cuda:{int(index) % torch.cuda.device_count()}")
    return dev


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, generation=None, elastic=False, devices=None,
               backend=None, timeout_s=120):
    """Join (or form) a multi-process world.

    ``coordinator_address`` is ``host:port`` of the TCP rendezvous store
    (process 0 hosts it); ``num_processes`` and ``process_id`` the world
    size and this process's rank. ``devices`` are this process's shards
    (default: the configured device, the card unless the caller set
    another: every visible card for ``cuda``, one CPU shard for ``cpu``;
    without CUDA the card raises, and no world forms on the CPU in its
    place); ``backend`` defaults to NCCL when they are CUDA devices, gloo
    otherwise.

    Re-calling with the same ``generation``, or with none, while a world
    is live is a no-op; a different generation raises — call
    :func:`shutdown` first.

    ``elastic=True`` joins one generation of an elastic world: it needs
    every coordinate and the generation explicitly; the store lives at
    ``coordinator_address`` in a process outside the world
    (:func:`start_coordinator_service`); the group is gloo, formed at the
    first :func:`global_mesh` (``devices`` default to
    :func:`elastic_device` of ``process_id``: the card unless the
    configured device is the CPU); ``timeout_s`` bounds the store's
    operations and the group's rendezvous and collectives.
    """
    if _WORLD["generation"] is not None:
        if generation is None or generation == _WORLD["generation"]:
            return
        raise RuntimeError(
            f"a generation-{_WORLD['generation']} world is live in this "
            f"process; call shutdown() before re-initializing as "
            f"generation {generation}")
    if elastic:
        if None in (coordinator_address, num_processes, process_id,
                    generation):
            raise ValueError(
                "elastic initialize needs explicit coordinator_address, "
                "num_processes, process_id and generation")
        _init_elastic(coordinator_address, int(num_processes),
                      int(process_id), int(generation),
                      devices or [elastic_device(process_id)], timeout_s)
        return
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
    if devices is None:
        devices = _default_devices()
    devices = [torch.device(d) for d in devices]
    if backend is None:
        backend = ("nccl" if all(d.type == "cuda" for d in devices)
                   else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _WORLD.update(generation=0 if generation is None else generation,
                  num_processes=int(num_processes),
                  process_id=int(process_id), address=coordinator_address,
                  backend=backend, devices=devices, elastic=False,
                  store=None)


def _init_elastic(address, num_processes, process_id, generation, devices,
                  timeout_s):
    """Join one generation: store client → generation handshake → fleet
    run id (the gloo group waits for :func:`global_mesh`). On a handshake
    mismatch the client is dropped before raising, so the process can go
    on to join the right world."""
    store = _connect(address, timeout_s)
    store.compare_set(_GEN_KEY, "", str(int(generation)))
    agreed = int(store.get(_GEN_KEY))
    if agreed != int(generation):
        del store
        raise GenerationMismatchError(
            f"this worker carries generation {generation} but the world "
            f"at {address} agreed on generation {agreed}; refusing to "
            f"join (a stale worker in a live world hangs the first "
            f"collective)")
    _WORLD.update(generation=int(generation),
                  num_processes=int(num_processes),
                  process_id=int(process_id), address=address,
                  backend="gloo", devices=[torch.device(d) for d in devices],
                  elastic=True, store=store, timeout_s=float(timeout_s))
    _adopt_fleet_run_id(store, int(generation))


def _form_elastic_group():
    """The elastic world's gloo group, on a ``PrefixStore`` of its store
    (formed once per generation, at the first :func:`global_mesh`)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.PrefixStore(
                f"elastic/g{_WORLD['generation']}/pg", _WORLD["store"]),
            world_size=_WORLD["num_processes"], rank=_WORLD["process_id"],
            timeout=datetime.timedelta(seconds=_WORLD["timeout_s"]))


def _adopt_fleet_run_id(store, generation, timeout_s=1.0):
    """Thread the fleet run id through the world's store: a member that
    carries one (spawned with ``SQ_OBS_FLEET_RUN_ID``) publishes it, one
    that joined without adopts the first publisher's
    (:func:`~sq_learn_tpu_torch.obs.recorder.set_fleet`), so every shard
    of the world correlates under ONE id. Telemetry never fails a join:
    with obs off, or no publisher within ``timeout_s``, it stays local."""
    from ..obs import recorder as _obs_recorder

    rec = _obs_recorder.get_recorder()
    if rec is None:
        return  # obs off: nothing to stamp, don't wait on the store
    key = "fleet/run_id"
    if rec.fleet_run_id:
        store.compare_set(key, "", str(rec.fleet_run_id))
    if not _kv_wait(store, key, timeout_s):
        return
    agreed = store.get(key).decode()
    if agreed:
        _obs_recorder.set_fleet(run_id=agreed)
        _obs_recorder.set_generation(int(generation))


def _kv_wait(store, key, timeout_s):
    """True once ``key`` exists in ``store``, False when ``timeout_s``
    passes first: one ``wait`` on the store's server, whose timeout is a
    decision here, not an error (the client stays usable after it)."""
    import torch.distributed as dist

    try:
        store.wait([key], datetime.timedelta(
            seconds=max(0.0, float(timeout_s))))
    except dist.DistStoreError:
        return False
    return True


def _store_barrier(store, name, n, timeout_s):
    """Every one of ``n`` members reaches ``name`` or ``timeout_s``
    passes. True when all arrived: the last to arrive sets
    ``<name>/all``, which the others wait for."""
    if int(store.add(name, 1)) >= int(n):
        store.set(f"{name}/all", "1")
    return _kv_wait(store, f"{name}/all", timeout_s)


def shutdown(*, barrier=True):
    """Tear down this process's world so a new one can form.

    In an elastic world ``barrier=True`` (the orderly path) first meets
    the other members at a store barrier (10 s at most), so no peer's
    in-flight store call sees the world half gone; the abort path
    (``barrier=False``, after a detected host failure: the dead peer
    never reaches a barrier) drops the group and the client at once."""
    if _WORLD["generation"] is None:
        return
    import torch.distributed as dist

    store = _WORLD["store"]
    if store is not None and barrier:
        _store_barrier(store, f"elastic/shutdown/g{_WORLD['generation']}",
                       _WORLD["num_processes"], 10.0)
    if dist.is_initialized():
        dist.destroy_process_group()
    for key in _WORLD:
        _WORLD[key] = None
    _WORLD["elastic"] = False


def generation():
    """The live world's generation, or None when no world is up."""
    return _WORLD["generation"]


def world_client():
    """The live elastic world's store client (its keys are the elastic
    control plane's transport), or None."""
    return _WORLD["store"]


def connect_client():
    """A second client of the live elastic world's store, with a
    connection of its own: a client serializes its operations, so a
    thread that must not wait behind another's (the lease heartbeats)
    takes one of these."""
    if _WORLD["store"] is None:
        raise RuntimeError("no elastic world is live; call "
                           "initialize(..., elastic=True) first")
    return _connect(_WORLD["address"], _WORLD["timeout_s"])


def _require_world():
    if _WORLD["generation"] is None:
        raise RuntimeError("no multi-process world is live; call "
                           "initialize() first")


def global_mesh(axis_name=DATA_AXIS):
    """A 1-D mesh over every shard of every process: this process's
    devices, joined to the others' through the world's process group."""
    import torch.distributed as dist

    _require_world()
    if _WORLD["elastic"]:
        _form_elastic_group()
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
