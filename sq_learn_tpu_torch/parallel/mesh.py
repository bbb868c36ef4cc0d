"""Device mesh, row sharding and the mesh's collectives (counterpart of
``sq_learn_tpu/parallel/mesh.py``).

A :class:`Mesh` is an ordered tuple of torch devices along one axis,
``DATA_AXIS``; a device may repeat, so ``make_mesh(["cuda:0"] * 4)`` is
four logical shards of one card and ``make_mesh(["cpu"] * 8)`` the
tests' mesh. Inside a multi-process world
(:func:`~sq_learn_tpu_torch.parallel.distributed.global_mesh`) the mesh
also holds the process group: ``devices`` are this process's shards, and
the mesh spans every process's, in process order.

A row-sharded array is a :class:`ShardedRows`: this process's shards in
shard order, each on its device, all of one row count, plus the true row
count of the whole (the rest is zero-weight padding at the end).

The collectives never leave the order to a library:

- :meth:`Mesh.psum` copies every shard's partial to the mesh's first
  device and sums them there in shard order;
- :meth:`Mesh.gather` concatenates them there in shard order.

In a multi-process world both first ``all_gather`` every process's
partials, so each process sums all shards in global shard order. No
float atomics and no ``all_reduce`` of the library's order: a result's
bits depend on the shard count alone, not on whether the shards sit on
one card, several cards or several processes. A partial is copied with
``Tensor.to``, which orders the copy after the work queued on the
source device's current stream, so the first device reads no partial
before its shard's work is done.

Randomness: a :class:`torch.Generator` belongs to one device, so each
shard draws from a generator of its own (:meth:`Mesh.generators`),
seeded from a draw of the caller's generator and the shard's global
index — the counterpart of ``fold_in(key, axis_index)``.
"""

import numpy as np
import torch

DATA_AXIS = "data"

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "ShardedRows",
    "check_mesh",
    "data_sharding",
    "make_mesh",
    "pad_and_shard",
    "pad_to_multiple",
    "replicated",
    "shard_rows",
]


class Mesh:
    """A 1-D data-parallel mesh: ``devices`` (this process's shards, in
    order) along ``axis_name``; with ``group`` (a ``torch.distributed``
    process group) the mesh spans ``process_count`` processes, each
    holding as many shards, and this process's come at ``offset``."""

    def __init__(self, devices, axis_name=DATA_AXIS, *, group=None,
                 process_index=0, process_count=1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name
        self.group = group
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def lead(self):
        """The device the collectives reduce on: the first shard's."""
        return self.devices[0]

    @property
    def local_size(self):
        return len(self.devices)

    @property
    def size(self):
        """The number of shards over every process."""
        return len(self.devices) * self.process_count

    @property
    def offset(self):
        """The global index of this process's first shard."""
        return self.process_index * len(self.devices)

    def __repr__(self):
        procs = (f", processes={self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_name!r}{procs})")

    # -- collectives --------------------------------------------------------

    def _all_shards(self, parts):
        """Every shard's partial, in global shard order: this process's
        copied to the first device; in a multi-process world stacked and
        ``all_gather``-ed (every partial must then have one shape)."""
        parts = [p.to(self.lead) for p in parts]
        if self.group is None:
            return parts
        import torch.distributed as dist

        local = torch.stack(parts)
        world = [torch.empty_like(local) for _ in range(self.process_count)]
        dist.all_gather(world, local, group=self.group)
        return [p for stacked in world for p in stacked]

    def psum(self, parts):
        """Σ of the shards' partials (one per local shard), on the first
        device, summed in global shard order."""
        parts = self._all_shards(parts)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def gather(self, parts, dim=0):
        """The shards' partials concatenated along ``dim`` in global shard
        order, on the first device."""
        return torch.cat(self._all_shards(parts), dim=dim)

    def broadcast(self, t):
        """One copy of ``t`` per local shard, on its device (the tensor
        itself where it already lies there)."""
        return [t.to(d) for d in self.devices]

    def generators(self, generator):
        """One generator per local shard, on its device, seeded from one
        draw of ``generator`` and the shard's global index."""
        base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
        gens = []
        for i, d in enumerate(self.devices):
            seed = np.random.SeedSequence([base, self.offset + i])
            g = torch.Generator(device=d)
            g.manual_seed(int(seed.generate_state(1, np.uint64)[0]
                              >> np.uint64(1)))
            gens.append(g)
        return gens


class ShardedRows:
    """Rows split over a mesh: this process's shards (each on its device,
    all of ``per`` rows along ``dim``) and the true row count ``n`` of the
    whole; rows past ``n`` are padding."""

    def __init__(self, shards, n, mesh, dim=0):
        self.shards = list(shards)
        self.n = int(n)
        self.mesh = mesh
        self.dim = dim

    @property
    def per(self):
        return self.shards[0].shape[self.dim]

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        s[self.dim] = self.n
        return tuple(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    def map(self, fn, *others, dim=None):
        """``fn`` applied shard by shard (with the matching shards of
        ``others``); the result keeps ``n`` and the mesh."""
        out = [fn(s, *(o.shards[i] for o in others))
               for i, s in enumerate(self.shards)]
        return ShardedRows(out, self.n, self.mesh,
                           self.dim if dim is None else dim)

    def to_tensor(self):
        """The first ``n`` rows of every shard, on the mesh's first
        device."""
        whole = self.mesh.gather(self.shards, dim=self.dim)
        return whole.narrow(self.dim, 0, self.n)

    def numpy(self):
        return self.to_tensor().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def check_mesh(mesh):
    """Return ``mesh`` when it is None or a :class:`Mesh`; raise
    TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a sq_learn_tpu_torch.parallel.Mesh (make_mesh), "
            f"got {type(mesh).__name__}")
    return mesh


def make_mesh(devices=None, axis_name=DATA_AXIS):
    """A 1-D data-parallel mesh over ``devices`` (default: every visible
    CUDA device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() defaults to every CUDA device and CUDA is not "
                "available; pass devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis_name)


def _as_tensor(X):
    return X if isinstance(X, torch.Tensor) else torch.as_tensor(
        np.asarray(X))


def pad_to_multiple(X, multiple, pad_value=0.0):
    """Pad axis 0 to a multiple of ``multiple`` (equal shards). Returns
    (padded tensor, original length); padding rows carry ``pad_value`` and
    must be masked out by the caller through zero sample weights."""
    X = _as_tensor(X)
    n = X.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return X, n
    fill = torch.full((pad,) + tuple(X.shape[1:]), pad_value, dtype=X.dtype,
                      device=X.device)
    return torch.cat([X, fill]), n


def shard_rows(mesh, *arrays, n=None):
    """Split each array's axis 0 (a multiple of the shard count) into
    ``mesh.size`` equal blocks and place this process's on their devices,
    each in an allocation of its own (a shard's products then do not
    depend on where its rows lay in the whole). ``n`` is the true row
    count (default: every row)."""
    out = []
    for a in arrays:
        a = _as_tensor(a)
        if a.shape[0] % mesh.size:
            raise ValueError(
                f"{a.shape[0]} rows do not split over {mesh.size} shards; "
                f"pad them first (pad_to_multiple)")
        per = a.shape[0] // mesh.size
        shards = [a[(mesh.offset + i) * per:(mesh.offset + i + 1) * per]
                  .to(d, copy=True) for i, d in enumerate(mesh.devices)]
        out.append(ShardedRows(shards, a.shape[0] if n is None else n, mesh))
    return tuple(out) if len(out) > 1 else out[0]


def shard_local(mesh, rows, n):
    """Place this process's ``rows`` (its uniform share of a global array
    of ``n`` true rows, padded) over its shards — the counterpart of
    ``jax.make_array_from_process_local_data``."""
    rows = _as_tensor(rows)
    if rows.shape[0] % mesh.local_size:
        raise ValueError(
            f"{rows.shape[0]} local rows do not split over "
            f"{mesh.local_size} local shards")
    per = rows.shape[0] // mesh.local_size
    return ShardedRows([rows[i * per:(i + 1) * per].to(d, copy=True)
                        for i, d in enumerate(mesh.devices)], n, mesh)


def data_sharding(mesh):
    """The placement "rows split over the mesh": a callable taking an
    array whose rows divide over the shards to its :class:`ShardedRows`."""
    return lambda X: shard_rows(mesh, X)


def replicated(mesh):
    """The placement "one copy per device": a callable taking a tensor to
    its per-shard copies."""
    return mesh.broadcast


def pad_and_shard(mesh, X):
    """Pad axis 0 to a multiple of the shard count and place (X, padding
    mask) row-sharded — the common preamble of every sharded row routine
    (SVD, tomography, k-NN). Returns (X sharded, mask sharded, n true
    rows); padding rows carry mask 0."""
    X = _as_tensor(X)
    n = X.shape[0]
    Xp, _ = pad_to_multiple(X, mesh.size)
    mask = torch.zeros(Xp.shape[0], dtype=Xp.dtype, device=Xp.device)
    mask[:n] = 1.0
    Xs, ms = shard_rows(mesh, Xp, mask, n=n)
    return Xs, ms, n
