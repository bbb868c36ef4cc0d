"""The elastic world: a fit that survives a host's death (counterpart of
``sq_learn_tpu/parallel/elastic.py``).

- An :class:`ElasticCoordinator` (the parent process, OUTSIDE the world)
  starts N worker processes and owns one ``torch.distributed.TCPStore``
  per **generation** (:func:`~sq_learn_tpu_torch.parallel.distributed.
  start_coordinator_service`): any worker, node 0 included, may die
  without taking the control plane with it.
- Each worker joins through ``distributed.initialize(..., elastic=True)``,
  certifies the world by running the sharded Lloyd loop across it (the
  ``lloyd_step`` kernel on each worker's card, one ``all_gather`` over
  gloo) and publishes **heartbeats** to the store from a
  :class:`LeaseSupervisor` thread.
- The fit is the **window-synchronous q-means fold** (below): a host's
  failure is detected when its window partial does not land within its
  lease, the survivors abort the generation, the coordinator re-forms an
  (N−1)-world on a new store with the generation bumped, and the fit
  resumes from the committed checkpoint, **bit-equal** to an
  uninterrupted (N−1)-host run of the same plan.
- Every transition writes an ``elastic`` obs record; every process's
  records carry the coordinator-minted ``fleet`` envelope; ``clock``
  samples ride the exchanges the world makes anyway (heartbeats,
  manifests, progress commits); each worker flushes its shard durably at
  every commit window and before ``os._exit``.
  :mod:`sq_learn_tpu_torch.obs.fleet` merges the shards into one
  clock-aligned timeline and reconciles the commit ledger.

Topology-invariant state (the parity argument)
----------------------------------------------
One epoch visits the shards in the order of
:meth:`~sq_learn_tpu_torch.oocore.epochs.EpochPlan.shard_order`; position
``p`` of that order is *owned* by host ``p % n_hosts``
(:meth:`~sq_learn_tpu_torch.oocore.epochs.EpochPlan.host_partition`).
Work advances in **windows** of ``SQ_ELASTIC_WINDOW`` positions: at a
window boundary every host holds the same state; each host computes, for
its own positions only, the shard's partial (cluster counts, sums and
inertia, all float64) **against the centers frozen at the window start**;
the partials cross the store; then every host folds ALL the window's
partials in position order. The state is therefore a pure function of
``(data, seed, k, epochs, window)``: ownership decides only *who
computes* a partial, never its value or its place in the fold. So a fit
that shrinks from N to N−1 hosts lands on the bytes of an uninterrupted
(N−1)-host (or 1-host) run. :func:`elastic_fit_local`, the in-process
simulator, shares this core and is the parity reference.

A partial runs on the worker's device (:func:`shard_partial`, float64)
with no float atomics: its cluster sums are a one-hot product summed in
a fixed order, so its bits depend only on the shard's rows, the frozen
centers and the device's kind, never on which process computed it.

Failure model
-------------
A worker's death (SIGKILL, an injected ``host_fail``) and stall
(``host_stall``) are handled for ANY worker; windows are atomic (a window
folds only when every partial landed, so a death voids the window in
flight and the next generation recomputes it from the frozen state: no
shard lost or folded twice, pinned by the per-shard ``folds`` counter in
the state). The coordinator's death (it holds the stores and the run's
manifests) is out of scope.

Generations and commits
-----------------------
The run directory's newest ``manifest.g<G>.json`` names the live
generation, its store's port and its members. Checkpoints commit under
:func:`commit_fingerprint` (the topology-free base fingerprint plus
``|gen=G``), and only node 0 of the live generation commits, after
re-reading the manifest: a stale worker gets
:class:`StaleGenerationError` (and a ``commit_refused`` record), never a
silent overwrite. Resume tries generations newest first, so a survivor
of generation G loads the last commit of G or of any ancestor.

Worker entry point: ``python -m sq_learn_tpu_torch.parallel.elastic
--worker <run_dir> <worker_index>`` (the coordinator starts it).
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import _knobs
from ..obs import recorder as _recorder
from ..oocore.epochs import EpochPlan
from ..resilience import faults as _faults
from .distributed import _kv_wait

__all__ = [
    "ElasticCoordinator",
    "ElasticError",
    "GenerationAbort",
    "HostFailure",
    "LeaseSupervisor",
    "StaleGenerationError",
    "base_fingerprint",
    "collect_elastic_records",
    "commit_fingerprint",
    "elastic_fit_local",
    "fold_partial",
    "init_centers",
    "load_state",
    "new_state",
    "shard_partial",
]

_FMT = "elastic-qkm-v1"

#: rows of one block of :func:`shard_partial` (the JAX package's 1024)
_BLOCK = 1024

#: worker exit codes: a stale worker (left out of the new generation)
#: exits STALE without committing anything; an injected ``host_fail``
#: exits INJECTED so logs tell the scripted death from a crash
EXIT_OK, EXIT_STALE, EXIT_INJECTED = 0, 3, 17


class ElasticError(RuntimeError):
    """Base of the elastic world's failures."""


class HostFailure(ElasticError):
    """A host died and the shrink budget (``SQ_ELASTIC_MAX_SHRINKS``)
    is spent: the run cannot continue."""


class GenerationAbort(ElasticError):
    """Control flow inside a worker: this generation's world is dead;
    tear down and join the next one."""


class StaleGenerationError(ElasticError):
    """A worker of a superseded generation tried to commit."""


def _heartbeat_s():
    return _knobs.get_float("SQ_ELASTIC_HEARTBEAT_S")


def _lease_s():
    return _knobs.get_float("SQ_ELASTIC_LEASE_S")


def _max_shrinks():
    return _knobs.get_int("SQ_ELASTIC_MAX_SHRINKS")


def _default_window():
    return max(1, _knobs.get_int("SQ_ELASTIC_WINDOW"))


def _emit(event, generation, n_hosts, rec=None, **fields):
    rec = rec if rec is not None else _recorder.get_recorder()
    if rec is None:
        return
    rec.record(dict({"type": "elastic", "event": str(event),
                     "generation": int(generation),
                     "n_hosts": int(n_hosts)}, **fields),
               kind="elastic_records")


def _emit_clock(peer, sent_ts, recv_ts, generation, via, rec=None):
    """One clock sample (a ``clock`` record): a value stamped
    ``time.time()`` by ``peer`` was observed here at ``recv_ts``, so
    ``recv_ts − sent_ts`` upper-bounds how far this process's clock runs
    ahead of the peer's. :func:`sq_learn_tpu_torch.obs.fleet.
    clock_offsets` takes the minimum over samples and pairs the two
    directions."""
    rec = rec if rec is not None else _recorder.get_recorder()
    if rec is None:
        return
    rec.record({"type": "clock", "peer": str(peer),
                "sent_ts": float(sent_ts), "recv_ts": float(recv_ts),
                "generation": int(generation), "via": str(via)})


# ---------------------------------------------------------------------------
# the pure fold-window core
# ---------------------------------------------------------------------------


def base_fingerprint(source, n_clusters, seed, epochs, window):
    """Topology-free identity of the fit: data content and plan. The
    host count is absent on purpose: a shrunk world resumes the SAME
    pass."""
    return (f"{_FMT}|data={source.fingerprint}|shards={source.n_shards}"
            f"|k={int(n_clusters)}|seed={int(seed)}|epochs={int(epochs)}"
            f"|window={int(window)}")


def commit_fingerprint(base, generation):
    """The checkpoint fingerprint a generation commits under: a stale
    generation fails the match instead of resuming the wrong world's
    pass."""
    return f"{base}|gen={int(generation)}"


def init_centers(source, n_clusters, seed):
    """k distinct rows of the source, chosen by numpy's
    ``default_rng((seed, 0xE1A5))`` (the JAX package's rows), sorted for
    read locality; float64."""
    rng = np.random.default_rng((int(seed), 0xE1A5))
    rows = np.sort(rng.choice(len(source), size=int(n_clusters),
                              replace=False))
    return np.asarray(source.take(rows), np.float64)


def new_state(n_clusters, n_features, n_shards, centers):
    """The fold state: centers, counts and inertia, plus the per-shard
    ``folds`` counter — the ledger that lets the end of the fit assert
    every shard folded exactly ``epochs`` times."""
    return {"centers": np.array(centers, np.float64).reshape(
                int(n_clusters), int(n_features)),
            "counts": np.zeros(int(n_clusters), np.float64),
            "folds": np.zeros(int(n_shards), np.int64),
            "inertia": np.zeros((), np.float64)}


def shard_partial(centers, X, *, device=None, return_labels=False):
    """One shard's partial against frozen ``centers``: ``(counts, sums,
    inertia)`` in float64 (numpy arrays and a float), plus the rows'
    labels with ``return_labels``.

    Runs on ``device`` (default: the configured one, ``"cuda"``), in
    1024-row blocks as the JAX package's numpy loop does: broadcast
    squared distances (no matrix product), the first nearest center, and
    the cluster sums as a one-hot float64 product summed over the block's
    rows, with no float atomics (no ``index_add_``), so the bits depend
    only on the rows, the centers and the device's kind.
    """
    from .._config import resolve_device

    dev = resolve_device(device)
    C = torch.as_tensor(np.asarray(centers, np.float64)).to(dev)
    X = torch.as_tensor(np.asarray(X)).to(dev, torch.float64)
    k = C.shape[0]
    ids = torch.arange(k, device=dev)
    counts = torch.zeros(k, dtype=torch.float64, device=dev)
    sums = torch.zeros_like(C)
    inertia = torch.zeros((), dtype=torch.float64, device=dev)
    labels = []
    for lo in range(0, X.shape[0], _BLOCK):
        blk = X[lo:lo + _BLOCK]
        d2 = ((blk[:, None, :] - C[None, :, :]) ** 2).sum(dim=2)
        lab = torch.argmin(d2, dim=1)
        onehot = (lab[:, None] == ids[None, :]).to(torch.float64)
        counts += onehot.sum(dim=0)
        sums += (onehot[:, :, None] * blk[:, None, :]).sum(dim=0)
        inertia += d2.gather(1, lab[:, None]).sum()
        labels.append(lab)
    out = (counts.cpu().numpy(), sums.cpu().numpy(), float(inertia))
    if return_labels:
        lab = (torch.cat(labels) if labels
               else torch.zeros(0, dtype=torch.int64, device=dev))
        out += (lab.cpu().numpy(),)
    return out


def fold_partial(state, shard, partial):
    """Fold one position's partial into the state (the mini-batch
    k-means center update, the reference's incremental mean, in float64
    on the host). MUST be called in position order: that is what makes
    the state topology-invariant."""
    counts_p, sums_p, inertia_p = partial[:3]
    counts_p = np.asarray(counts_p, np.float64)
    sums_p = np.asarray(sums_p, np.float64)
    C = state["centers"]
    newv = state["counts"] + counts_p
    nz = counts_p > 0
    C[nz] += (sums_p[nz] - counts_p[nz, None] * C[nz]) / newv[nz, None]
    state["counts"] = newv
    state["inertia"] = state["inertia"] + np.float64(inertia_p)
    state["folds"][int(shard)] += 1


def load_state(path, template, base, generation):
    """Resume from the newest usable commit: try ``generation`` down to 0
    (a survivor of generation G takes its own or any ancestor's commit;
    a FUTURE generation's commit never matches, so a stale worker cannot
    resume past its world). Returns ``(state, cursor)`` or None."""
    from ..utils.checkpoint import load_stream_state

    if path is None:
        return None
    for g in range(int(generation), -1, -1):
        out = load_stream_state(path, template, commit_fingerprint(base, g))
        if out is not None:
            state, cursor = out
            return ({k: np.array(v) for k, v in state.items()}, int(cursor))
    return None


def _window_index(epoch, w_lo, n_shards, window):
    return int(epoch) * (-(-int(n_shards) // int(window))) \
        + int(w_lo) // int(window)


# ---------------------------------------------------------------------------
# the in-process simulator (the parity reference and the test rig)
# ---------------------------------------------------------------------------


def elastic_fit_local(source, n_clusters, *, n_hosts=1, seed=0, epochs=1,
                      window=None, ckpt_path=None, generation=0,
                      max_shrinks=None, device=None):
    """Run the window-synchronous fold with ``n_hosts`` *logical* hosts in
    one process, on ``device``. It shares the real workers' core, and the
    state is topology-invariant, so its result for ANY ``n_hosts`` is the
    bit-parity reference of a real multi-process run (interrupted or
    not) of the same plan on the same kind of device.

    Armed ``host_fail``/``host_stall`` faults fire through
    :meth:`~sq_learn_tpu_torch.resilience.faults.FaultPlan.host_event` at
    each window boundary (hosts asked in id order): a fail removes the
    host, bumps the generation and recomputes the voided window with the
    survivors; a stall is recorded and the fit goes on — with no process
    or clock, so the test matrix is deterministic and fast."""
    W = int(window) if window else _default_window()
    budget = _max_shrinks() if max_shrinks is None else int(max_shrinks)
    plan = EpochPlan(seed=seed)
    k, m = int(n_clusters), int(source.shape[1])
    n_shards = int(source.n_shards)
    base = base_fingerprint(source, k, seed, epochs, W)
    template = new_state(k, m, n_shards, np.zeros((k, m)))
    gen = int(generation)
    loaded = load_state(ckpt_path, template, base, gen) if ckpt_path \
        else None
    if loaded is not None:
        state, cursor = loaded
    else:
        state, cursor = new_state(k, m, n_shards,
                                  init_centers(source, k, seed)), 0
    hosts = list(range(int(n_hosts)))
    _recorder.set_generation(gen)
    _emit("world_up", gen, len(hosts))
    _emit("resume", gen, len(hosts), cursor=int(cursor))
    total = int(epochs) * n_shards
    shrinks = 0
    while cursor < total:
        epoch, pos = divmod(cursor, n_shards)
        order = plan.shard_order(source, epoch)
        w_lo, w_hi = pos, min(pos + W, n_shards)
        w_idx = _window_index(epoch, w_lo, n_shards, W)
        fplan = _faults._active
        dead = None
        if fplan is not None:
            for h in hosts:
                ev = fplan.host_event(w_idx, h)
                if ev is not None and ev[0] == "fail":
                    dead = h
                    break
                if ev is not None and ev[0] == "stall":
                    _emit("host_stall", gen, len(hosts), failed_host=h,
                          window=w_idx, stall_s=float(ev[1]))
        if dead is not None:
            _emit("host_fail", gen, len(hosts), failed_host=dead,
                  window=w_idx, detect_s=0.0)
            if shrinks >= budget or len(hosts) <= 1:
                raise HostFailure(
                    f"host {dead} failed at window {w_idx} with the "
                    f"shrink budget exhausted ({shrinks}/{budget})")
            hosts.remove(dead)
            shrinks += 1
            gen += 1
            _recorder.set_generation(gen)
            _emit("shrink", gen, len(hosts), failed_host=dead,
                  shrink_s=0.0)
            _emit("world_up", gen, len(hosts))
            _emit("resume", gen, len(hosts), cursor=int(cursor))
            continue  # the voided window recomputes under the new world
        partials = {}
        for rank in range(len(hosts)):
            for p, s in plan.host_partition(source, epoch, len(hosts),
                                            rank, start_pos=w_lo):
                if p >= w_hi:
                    break
                partials[p] = shard_partial(state["centers"],
                                            source.read_shard(s),
                                            device=device)
        for p in range(w_lo, w_hi):
            fold_partial(state, int(order[p]), partials[p])
        cursor = epoch * n_shards + w_hi
        _emit("window", gen, len(hosts), window=w_idx, cursor=int(cursor))
        _emit("commit", gen, len(hosts), window=w_idx, cursor=int(cursor))
        if ckpt_path:
            from ..utils.checkpoint import save_stream_state

            save_stream_state(ckpt_path, state, cursor,
                              commit_fingerprint(base, gen))
    if not (state["folds"] == int(epochs)).all():
        raise ElasticError(f"fold ledger broken: {state['folds']}")
    _emit("done", gen, len(hosts), cursor=int(cursor))
    _recorder.set_generation(None)
    return {"centers": state["centers"], "counts": state["counts"],
            "inertia": float(state["inertia"]), "folds": state["folds"],
            "generation": gen, "n_hosts": len(hosts), "shrinks": shrinks}


# ---------------------------------------------------------------------------
# the transport: store exchange, leases, the worker runtime, coordinator
# ---------------------------------------------------------------------------


def _kv_put_bytes(client, key, payload):
    client.set(key, bytes(payload))


def _kv_get_bytes(client, key, timeout_ms):
    """The bytes at ``key``, waiting up to ``timeout_ms`` for them;
    raises TimeoutError when they do not appear."""
    if not _kv_wait(client, key, float(timeout_ms) / 1000.0):
        raise TimeoutError(f"{key} did not appear within {timeout_ms} ms")
    return client.get(key)


def _pack_partial(counts, sums, inertia):
    buf = io.BytesIO()
    np.savez(buf, c=np.asarray(counts, np.float64),
             s=np.asarray(sums, np.float64), i=np.float64(inertia))
    return buf.getvalue()


def _unpack_partial(raw):
    with np.load(io.BytesIO(raw), allow_pickle=False) as npz:
        return (np.array(npz["c"]), np.array(npz["s"]),
                float(npz["i"]))


def _write_json_atomic(path, payload):
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, str(path))


def _read_manifest(run_dir):
    """The newest ``manifest.g<G>.json`` of the run, or None."""
    best = None
    for name in os.listdir(run_dir):
        if name.startswith("manifest.g") and name.endswith(".json"):
            try:
                g = int(name[len("manifest.g"):-len(".json")])
            except ValueError:
                continue
            if best is None or g > best[0]:
                best = (g, name)
    if best is None:
        return None
    try:
        with open(os.path.join(run_dir, best[1])) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None  # racing the coordinator's atomic replace


def _await_manifest(run_dir, min_generation, timeout_s=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        man = _read_manifest(run_dir)
        if man is not None and int(man["generation"]) >= int(min_generation):
            return man
        time.sleep(0.05)
    raise ElasticError(
        f"no generation >= {min_generation} manifest appeared in "
        f"{run_dir} within {timeout_s}s")


def check_commit_generation(run_dir, generation):
    """The commit guard: re-read the run's manifest and refuse to commit
    from a superseded generation (a ``commit_refused`` record and
    :class:`StaleGenerationError`): a stale worker never overwrites the
    live world's checkpoint."""
    man = _read_manifest(run_dir)
    live = None if man is None else int(man["generation"])
    if live != int(generation):
        _emit("commit_refused", int(generation), 0,
              manifest_generation=live)
        raise StaleGenerationError(
            f"worker of generation {generation} refusing to commit: the "
            f"run manifest is at generation {live}")


class LeaseSupervisor:
    """Heartbeat publisher and peer-lease arbiter of one worker.

    A daemon thread publishes sequence-numbered heartbeat keys
    (``elastic/g<G>/hb/<worker>/<seq>``, valued with the publisher's
    ``time.time()``) every ``SQ_ELASTIC_HEARTBEAT_S`` seconds, through
    ``publisher`` (a store client of its own, so the fit thread's store
    calls never delay a heartbeat); :meth:`peer_alive` waits one
    ``SQ_ELASTIC_LEASE_S`` lease for a peer's NEXT sequence number — the
    lease expiring declares the peer dead. Liveness only checks that a
    key exists; the publisher thread also reads its ``peers``' fresh
    heartbeats and turns each into a ``clock`` record, the samples
    :func:`sq_learn_tpu_torch.obs.fleet.clock_offsets` aligns the
    timeline with, at no extra message."""

    #: lock discipline: the publisher thread and the fit thread share only
    #: these, written under the lock
    _GUARDED_BY = {"_lock": ("_stop", "_seq")}

    def __init__(self, client, generation, host_id, heartbeat_s=None,
                 peers=(), publisher=None):
        self._client = client
        self._publisher = publisher if publisher is not None else client
        self._gen = int(generation)
        self._host = int(host_id)
        self._hb_s = float(heartbeat_s if heartbeat_s is not None
                           else _heartbeat_s())
        self._lock = threading.Lock()
        self._stop = False
        self._seq = 0
        self._last_seen = {}  # fit thread only: peer -> last seen seq
        # publisher thread only: per-peer heartbeat read frontier and the
        # clock samples left (SQ_OBS_FLEET_CLOCK_SAMPLES per peer per
        # generation)
        self._clock_peers = [int(p) for p in peers
                             if int(p) != self._host]
        self._clock_next = {p: 1 for p in self._clock_peers}
        budget = max(0, _knobs.get_int("SQ_OBS_FLEET_CLOCK_SAMPLES"))
        self._clock_left = {p: budget for p in self._clock_peers}
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"sq-elastic-lease-w{self._host}")

    def _key(self, host, seq):
        return f"elastic/g{self._gen}/hb/{host}/{seq}"

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while True:
            with self._lock:
                if self._stop:
                    return
                self._seq += 1
                seq = self._seq
            try:
                self._publisher.set(self._key(self._host, seq),
                                    str(time.time()))
            except Exception:
                return  # the world is tearing down: never crash the fit
            try:
                self._sample_peer_clocks()
            except Exception:
                pass  # clock sampling is best-effort telemetry
            time.sleep(self._hb_s)

    def _sample_peer_clocks(self):
        """Read each peer's heartbeats published so far (never waiting:
        the publisher must not stall on a dead peer) and record one
        ``clock`` sample per fresh key, up to the per-peer budget."""
        for peer in self._clock_peers:
            nxt = self._clock_next[peer]
            while self._clock_left[peer] > 0:
                key = self._key(peer, nxt)
                if not self._publisher.check([key]):
                    break  # the peer has not published nxt yet
                val = self._publisher.get(key)
                recv = time.time()
                nxt += 1
                try:
                    sent = float(val)
                except (TypeError, ValueError):
                    continue  # unparsable: counted as seen, no sample
                self._clock_left[peer] -= 1
                _emit_clock(f"w{peer}", sent, recv, self._gen, "hb")
            self._clock_next[peer] = nxt

    def stop(self):
        with self._lock:
            self._stop = True

    def peer_alive(self, peer, lease_s=None):
        """Wait until ``peer`` publishes a FRESH heartbeat or the lease
        expires: True = alive (a late but publishing peer stalls, it is
        not dead); False = the lease expired.

        The heartbeats already published are skipped first: catching up
        on a dead peer's backlog is not liveness. Liveness is only the
        NEXT key, the one the peer must still be running to publish."""
        lz = float(lease_s if lease_s is not None else _lease_s())
        peer = int(peer)
        nxt = self._last_seen.get(peer, 0) + 1
        while self._client.check([self._key(peer, nxt)]):
            self._last_seen[peer] = nxt
            nxt += 1
        if not _kv_wait(self._client, self._key(peer, nxt), lz):
            return False
        self._last_seen[peer] = nxt
        return True


def _write_failure_file(run_dir, generation, failed, by, detect_s):
    path = os.path.join(run_dir, f"failed.g{int(generation)}.w{int(failed)}"
                                 ".json")
    try:
        with open(path, "x") as fh:
            json.dump({"generation": int(generation), "failed": int(failed),
                       "by": int(by), "detect_s": float(detect_s)}, fh)
    except FileExistsError:
        pass  # both survivors detected; the first writer wins


def _await_partial(client, lease, key, peer, lease_s, *, run_dir, gen,
                   n_hosts, worker, stall_budget=20):
    """Wait for a peer's window partial under the lease protocol: a
    timeout with the peer still heartbeating is a ``host_stall`` (keep
    waiting, bounded); a timeout with the lease expired is a
    ``host_fail`` — record it, feed the circuit breaker, leave the
    failure file for the coordinator, abort the generation."""
    from ..resilience.supervisor import breaker

    t0 = time.monotonic()
    stalls = 0
    while True:
        try:
            return _kv_get_bytes(client, key, float(lease_s) * 1000.0)
        except TimeoutError:
            pass
        if lease.peer_alive(peer, lease_s) and stalls < stall_budget:
            stalls += 1
            if stalls == 1:
                _emit("host_stall", gen, n_hosts, host=int(worker),
                      failed_host=int(peer))
                breaker.record_failure("elastic_host_stall",
                                       site=f"elastic.g{gen}.w{peer}")
            continue
        detect_s = time.monotonic() - t0
        _emit("host_fail", gen, n_hosts, host=int(worker),
              failed_host=int(peer), detect_s=round(detect_s, 6))
        breaker.record_failure("elastic_host_fail",
                               site=f"elastic.g{gen}.w{peer}")
        _write_failure_file(run_dir, gen, peer, worker, detect_s)
        raise GenerationAbort(
            f"host {peer} lease expired after {detect_s:.3f}s waiting "
            f"for {key}")


def _certify_world(mesh, seed, generation):
    """Run the sharded Lloyd loop across the new world (each worker's
    ``lloyd_step`` kernel on its card, one ``all_gather`` over the
    world's group): the world is certified by a real collective, not a
    handshake. A small deterministic problem keyed on (seed,
    generation), at the JAX package's shape: 4 rows per shard × 5,
    δ=0.4, two iterations. Returns the inertia."""
    from ..utils import as_generator
    from . import distributed as dist
    from .lloyd import lloyd_single_sharded
    from .mesh import shard_local

    rows, m = 4 * mesh.size, 5
    rng = np.random.default_rng((int(seed), int(generation), 0xCE27))
    X = rng.normal(size=(rows, m)).astype(np.float32)
    lo, hi, per = dist.host_shard_bounds(rows)
    shard = np.zeros((per, m), np.float32)
    shard[:hi - lo] = X[lo:hi]
    w = np.zeros((per,), np.float32)
    w[:hi - lo] = 1.0
    _, inertia, _, _, _ = lloyd_single_sharded(
        mesh, as_generator(0, mesh.lead), shard_local(mesh, shard, rows),
        shard_local(mesh, w, rows), torch.from_numpy(X[:3]),
        shard_local(mesh, (shard * shard).sum(axis=1), rows),
        delta=0.4, mode="delta", max_iter=2, tol=0.0)
    inertia = float(inertia)
    if not np.isfinite(inertia):
        raise ElasticError(
            f"world certification produced non-finite inertia at "
            f"generation {generation}")
    return inertia


def _flush_obs():
    rec = _recorder.get_recorder()
    if rec is not None:
        rec.flush()


def _run_generation(run_dir, source, plan, state, cursor, *, gen, members,
                    node_id, worker_index, client, lease, cfg, base, ckpt,
                    device):
    """One generation's share of the fit: the window loop from ``cursor``
    until done or :class:`GenerationAbort`. Returns the final cursor."""
    from ..oocore.prefetch import iter_shards
    from ..utils.checkpoint import save_stream_state

    n = len(members)
    n_shards = int(source.n_shards)
    W = int(cfg["window"])
    epochs = int(cfg["epochs"])
    lz_s = float(cfg["lease_s"])
    total = epochs * n_shards
    while cursor < total:
        epoch, pos = divmod(cursor, n_shards)
        order = plan.shard_order(source, epoch)
        w_lo, w_hi = pos, min(pos + W, n_shards)
        w_idx = _window_index(epoch, w_lo, n_shards, W)
        fplan = _faults._active
        if fplan is not None:
            ev = fplan.host_event(w_idx, worker_index)
            if ev is not None and ev[0] == "fail":
                _flush_obs()
                sys.stdout.flush()
                os._exit(EXIT_INJECTED)
            if ev is not None and ev[0] == "stall":
                time.sleep(float(ev[1]))
        mine = [(p, s)
                for p, s in plan.host_partition(source, epoch, n, node_id,
                                                start_pos=w_lo)
                if p < w_hi]
        partials = {}
        shards_iter = iter_shards(source, [s for _, s in mine])
        try:
            for (p, s), raw in zip(mine, shards_iter):
                prt = shard_partial(state["centers"], raw, device=device)
                partials[p] = prt
                _kv_put_bytes(client,
                              f"elastic/g{gen}/x/{epoch * n_shards + p}",
                              _pack_partial(*prt))
        finally:
            shards_iter.close()
        for p in range(w_lo, w_hi):
            if p in partials:
                continue
            peer = members[p % n]
            raw = _await_partial(
                client, lease, f"elastic/g{gen}/x/{epoch * n_shards + p}",
                peer, lz_s, run_dir=run_dir, gen=gen, n_hosts=n,
                worker=worker_index)
            partials[p] = _unpack_partial(raw)
        for p in range(w_lo, w_hi):
            fold_partial(state, int(order[p]), partials[p])
        cursor = epoch * n_shards + w_hi
        _emit("window", gen, n, host=int(worker_index), window=w_idx,
              cursor=int(cursor))
        if node_id == 0:
            check_commit_generation(run_dir, gen)
            save_stream_state(ckpt, state, cursor,
                              commit_fingerprint(base, gen))
            # the ts doubles as a coordinator-side clock sample
            # (via="progress"): the parent reads it at its next poll
            _write_json_atomic(
                os.path.join(run_dir, "progress.json"),
                {"cursor": int(cursor), "generation": int(gen),
                 "epoch": int(epoch), "ts": time.time()})
            _emit("commit", gen, n, host=int(worker_index),
                  window=w_idx, cursor=int(cursor))
        # crash-safe telemetry: flush this worker's shard durably at every
        # commit window, so a SIGKILL loses at most the window in flight —
        # the victim's last flushed ``window`` record is its progress
        _flush_obs()
    return cursor


def _worker_device(cfg, worker_index):
    """``cfg["device"]`` (``"cpu"``, ``"cuda:<i>"``), else
    ``cuda:<worker_index % cards>``. A CUDA device without CUDA
    raises."""
    from .distributed import elastic_device

    return elastic_device(worker_index, cfg.get("device") or "cuda")


def _write_launches(run_dir, worker_index):
    """This worker's kernel launches so far (launch counters are per
    process), where the coordinator adds them up."""
    from ..ops.kernels import argkmin, lloyd_step

    _write_json_atomic(
        os.path.join(run_dir, f"launches.w{int(worker_index)}.json"),
        {"lloyd_step": int(lloyd_step.launches),
         "argkmin": int(argkmin.launches)})


def _worker_main(run_dir, worker_index):
    """The ``--worker`` entry point: join generations until the fit is
    done (or this worker is superseded), re-forming the world after
    every :class:`GenerationAbort`."""
    from .._config import set_config
    from ..oocore.store import open_store
    from . import distributed as dist

    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    device = _worker_device(cfg, worker_index)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_config(device=str(device))
    source = open_store(cfg["store"])
    k, m = int(cfg["n_clusters"]), int(source.shape[1])
    seed, epochs, W = int(cfg["seed"]), int(cfg["epochs"]), \
        int(cfg["window"])
    n_shards = int(source.n_shards)
    total = epochs * n_shards
    plan = EpochPlan(seed=seed)
    base = base_fingerprint(source, k, seed, epochs, W)
    ckpt = os.path.join(run_dir, "ckpt.npz")
    template = new_state(k, m, n_shards, np.zeros((k, m)))
    # the group's rendezvous and collective bound: members of a new
    # generation detect the failure up to a lease apart
    timeout_s = max(30.0, 10.0 * float(cfg["lease_s"]))
    last_gen, abort_t = -1, None
    while True:
        ready = _read_manifest(run_dir)
        waited = ready is None or int(ready["generation"]) <= last_gen
        man = _await_manifest(run_dir, last_gen + 1)
        gen = int(man["generation"])
        _recorder.set_generation(gen)
        if waited and isinstance(man.get("ts"), (int, float)):
            # the coordinator stamped the manifest when it wrote it: read
            # by a worker that was polling for it, it is a worker-to-
            # coordinator clock sample. One written before this worker
            # looked (before the process started, or while it was still
            # detecting the failure) would bound the offset by that delay
            # and bias the fleet's midpoint by half of it: not a sample.
            _emit_clock("coord", man["ts"], time.time(), gen, "manifest")
        members = [int(x) for x in man["members"]]
        if worker_index not in members:
            _emit("stale_exit", gen, len(members), host=worker_index)
            return EXIT_STALE
        node_id = members.index(worker_index)
        n = len(members)
        dist.initialize(f"127.0.0.1:{man['port']}", n, node_id,
                        generation=gen, elastic=True, devices=[device],
                        timeout_s=timeout_s)
        client = dist.world_client()
        lease = LeaseSupervisor(client, gen, worker_index,
                                cfg["heartbeat_s"], peers=members,
                                publisher=dist.connect_client()).start()
        _certify_world(dist.global_mesh(), seed, gen)
        _write_launches(run_dir, worker_index)
        shrink_s = (time.monotonic() - abort_t) if abort_t is not None \
            else 0.0
        _emit("world_up", gen, n, host=worker_index,
              shrink_s=round(shrink_s, 6))
        loaded = load_state(ckpt, template, base, gen)
        if loaded is not None:
            state, cursor = loaded
        else:
            state, cursor = new_state(k, m, n_shards,
                                      init_centers(source, k, seed)), 0
        _emit("resume", gen, n, host=worker_index, cursor=int(cursor))
        try:
            cursor = _run_generation(
                run_dir, source, plan, state, cursor, gen=gen,
                members=members, node_id=node_id,
                worker_index=worker_index, client=client, lease=lease,
                cfg=cfg, base=base, ckpt=ckpt, device=device)
        except (GenerationAbort, StaleGenerationError):
            # a refused stale commit re-forms like an abort: the next
            # manifest decides whether this worker is still a member
            abort_t = time.monotonic()
            lease.stop()
            dist.shutdown(barrier=False)
            last_gen = gen
            continue
        if cursor != total or not (state["folds"] == epochs).all():
            raise ElasticError(f"fit ended at cursor {cursor} of {total} "
                               f"with folds {state['folds']}")
        if node_id == 0:
            check_commit_generation(run_dir, gen)
            np.savez(os.path.join(run_dir, "result.npz"),
                     centers=state["centers"], counts=state["counts"],
                     inertia=state["inertia"], folds=state["folds"])
            _write_json_atomic(
                os.path.join(run_dir, "result.json"),
                {"generation": int(gen), "n_hosts": n,
                 "cursor": int(cursor),
                 "inertia": float(state["inertia"])})
        _emit("done", gen, n, host=worker_index, cursor=int(cursor))
        lease.stop()
        # peers may already be gone; the fit is committed either way
        dist._store_barrier(client, f"elastic/done/g{gen}", n, 10.0)
        return EXIT_OK


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------


#: the default of the coordinator's ``devices_per_host``, which the port
#: rejects when given
_NO_VIRTUAL_DEVICES = object()


def _pick_port(generation):
    """Generation G's store port: ``SQ_ELASTIC_PORT + G`` when the knob
    is set (the previous generation's store still holds its own port),
    else 0, a free port the store binds itself."""
    port = int(_knobs.get_int("SQ_ELASTIC_PORT") or 0)
    return port + int(generation) if port else 0


def collect_elastic_records(run_dir):
    """Every ``elastic`` obs record of a run's workers, in worker order
    (each with ``_worker``) — what the smoke mines for the detection
    latency and the shrink wall clock. A view over :func:`sq_learn_tpu_
    torch.obs.fleet.load_shards`; the coordinator's shard is left out, so
    the latencies stay those the workers observed."""
    from ..obs import fleet as _fleet

    out = []
    for host, records in _fleet.load_shards(run_dir):
        if not (host.startswith("w") and host[1:].isdigit()):
            continue
        for rec in records:
            if rec.get("type") == "elastic":
                rec = dict(rec)
                rec["_worker"] = host[1:]
                out.append(rec)
    return out


class ElasticCoordinator:
    """The parent process's control plane of one elastic fit.

    Owns the run directory (config, per-generation manifests), one
    TCPStore per generation (outside the world, so no worker's death
    takes it down), the N worker processes, and the reaction to deaths:
    a member process exiting before the result lands — or a survivor's
    failure file — triggers a shrink (a new store on a new port,
    ``manifest.g<G+1>.json`` with the survivors), bounded by
    ``SQ_ELASTIC_MAX_SHRINKS``. ``kill=(worker, cursor)`` SIGKILLs that
    worker once the committed cursor reaches ``cursor`` — the scripted
    mid-epoch host death.

    ``device=None`` puts worker i on ``cuda:<i % cards>``; ``"cpu"`` (the
    tests) on the CPU. ``heartbeat_s``, ``lease_s`` and ``max_shrinks``
    win over their ``SQ_ELASTIC_*`` knobs, which give the values left
    None; the coordinator writes heartbeat and lease into the run's
    config, and every worker reads them there, never from its own knobs.
    Workers are new interpreters (never a fork of this process, which may
    hold a CUDA context) and inherit its environment, with ``worker_env``
    applied over it. ``obs=False`` starts no recorder, here or in a
    worker, and writes no obs shard. The JAX package's
    ``devices_per_host`` raises: it sets the JAX workers' count of XLA
    virtual CPU devices, and a port worker holds one device. A
    single-threaded poll loop; the stores stay referenced until the
    object dies."""

    def __init__(self, run_dir, store_path, *, n_workers=3, n_clusters=8,
                 seed=0, epochs=2, window=None,
                 devices_per_host=_NO_VIRTUAL_DEVICES, max_shrinks=None,
                 kill=None, worker_env=None, heartbeat_s=None, lease_s=None,
                 obs=True, device=None):
        if devices_per_host is not _NO_VIRTUAL_DEVICES:
            raise TypeError(
                "ElasticCoordinator's devices_per_host has no object in "
                "eager torch: it sets the JAX workers' count of XLA virtual "
                "CPU devices, and a port worker holds one device (device=; "
                "ROADMAP.md, 'Not ported, and why')")
        self.run_dir = str(run_dir)
        self.store_path = str(store_path)
        self.n_workers = int(n_workers)
        self.n_clusters = int(n_clusters)
        self.seed = int(seed)
        self.epochs = int(epochs)
        self.window = int(window) if window else _default_window()
        self.device = None if device is None else str(device)
        self.max_shrinks = (_max_shrinks() if max_shrinks is None
                            else int(max_shrinks))
        self.kill = kill  # (worker_index, min_committed_cursor) or None
        self.worker_env = dict(worker_env or {})
        self.heartbeat_s = float(heartbeat_s if heartbeat_s is not None
                                 else _heartbeat_s())
        self.lease_s = float(lease_s if lease_s is not None else _lease_s())
        self.obs = bool(obs)
        # the fleet run id: minted here and handed to every worker; an
        # outer SQ_OBS_FLEET_RUN_ID wins, so nested runs stay correlated
        self.run_id = (_knobs.get_str("SQ_OBS_FLEET_RUN_ID", "")
                       or f"elastic-{os.urandom(4).hex()}")
        self._obs_rec = None
        self._services = []
        self.procs = {}
        self.timeline = []

    def _mark(self, event, **fields):
        self.timeline.append(dict({"t": time.monotonic(),
                                   "event": event}, **fields))

    def _spawn(self, worker_index):
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        if self.obs:
            # the worker's obs shard, enveloped with the run id and its
            # host
            obs_env = dict(
                SQ_OBS="1", SQ_OBS_PATH=os.path.join(
                    self.run_dir, f"obs.w{worker_index}.jsonl"),
                SQ_OBS_FLEET_RUN_ID=self.run_id,
                SQ_OBS_FLEET_HOST=f"w{worker_index}")
        else:
            obs_env = dict(SQ_OBS=None, SQ_OBS_PATH=None)
        env = _knobs.environ(PYTHONSTARTUP=None, PYTHONPATH=repo,
                             SQ_OBS_TRACE=None, **obs_env)
        env.update(self.worker_env)
        log = open(os.path.join(self.run_dir,
                                f"worker{worker_index}.log"), "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "sq_learn_tpu_torch.parallel.elastic",
                 "--worker", self.run_dir, str(worker_index)],
                env=env, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()
        return proc

    def _open_generation(self, gen, members):
        from . import distributed as dist

        service = dist.start_coordinator_service(
            f"127.0.0.1:{_pick_port(gen)}")
        self._services.append(service)
        _write_json_atomic(
            os.path.join(self.run_dir, f"manifest.g{gen}.json"),
            {"generation": gen, "port": int(service.port),
             "members": members, "ts": time.time()})

    def _shrink(self, generation, members, dead):
        gen = generation + 1
        members = [i for i in members if i not in dead]
        self._open_generation(gen, members)
        _emit("shrink", gen, len(members), rec=self._obs_rec,
              failed_host=int(dead[0]))
        self._mark("shrink", generation=gen, members=members, dead=dead)
        return gen, members

    def _launches(self):
        """Kernel launches the workers reported, summed:
        ``{"lloyd_step": n, "argkmin": n}``."""
        total = {"lloyd_step": 0, "argkmin": 0}
        for i in range(self.n_workers):
            try:
                with open(os.path.join(self.run_dir,
                                       f"launches.w{i}.json")) as fh:
                    got = json.load(fh)
            except (OSError, ValueError):
                continue
            for name in total:
                total[name] += int(got.get(name, 0))
        return total

    def run(self, timeout_s=300.0):
        """Run the fit to its end; returns its state (centers, counts,
        inertia, folds), the final generation and host count, shrinks,
        the killed workers, the timeline, exit codes and the workers'
        kernel launches. Raises :class:`HostFailure` when the shrink
        budget runs out, :class:`ElasticError` after ``timeout_s``."""
        os.makedirs(self.run_dir, exist_ok=True)
        if self.obs and self._obs_rec is None:
            # a PRIVATE recorder, never the global enable(): the caller
            # may own the process's sink, and the coordinator's shard
            # belongs in the run directory beside the workers'
            self._obs_rec = _recorder.Recorder(
                os.path.join(self.run_dir, "obs.coord.jsonl"),
                run_id=self.run_id, host="coord")
        _write_json_atomic(
            os.path.join(self.run_dir, "config.json"),
            {"store": self.store_path, "n_clusters": self.n_clusters,
             "seed": self.seed, "epochs": self.epochs,
             "window": self.window, "heartbeat_s": self.heartbeat_s,
             "lease_s": self.lease_s, "device": self.device})
        members = list(range(self.n_workers))
        gen = 0
        self._open_generation(gen, members)
        for i in members:
            self.procs[i] = self._spawn(i)
        self._mark("launched", members=list(members))
        result_json = os.path.join(self.run_dir, "result.json")
        shrinks, killed, kill_done = 0, [], self.kill is None
        last_prog_ts = 0.0
        t0 = time.monotonic()
        try:
            while True:
                if time.monotonic() - t0 > timeout_s:
                    raise ElasticError(
                        f"elastic run did not finish in {timeout_s}s "
                        f"(gen {gen}, members {members})")
                prog = None
                try:
                    with open(os.path.join(self.run_dir,
                                           "progress.json")) as fh:
                        prog = json.load(fh)
                except (OSError, ValueError):
                    pass
                if prog and isinstance(prog.get("ts"), (int, float)) \
                        and prog["ts"] > last_prog_ts:
                    # node 0's commit stamp, first read here: a
                    # coordinator-to-node-0 clock sample
                    last_prog_ts = float(prog["ts"])
                    _emit_clock(f"w{members[0]}", prog["ts"], time.time(),
                                prog.get("generation", gen), "progress",
                                rec=self._obs_rec)
                if not kill_done:
                    if prog and prog["cursor"] >= int(self.kill[1]):
                        victim = int(self.kill[0])
                        os.kill(self.procs[victim].pid, signal.SIGKILL)
                        killed.append(victim)
                        kill_done = True
                        self._mark("sigkill", worker=victim,
                                   cursor=prog["cursor"])
                done = os.path.exists(result_json)
                dead = [i for i in members
                        if self.procs[i].poll() is not None]
                for name in os.listdir(self.run_dir):
                    if name.startswith(f"failed.g{gen}.w"):
                        w = int(name[len(f"failed.g{gen}.w"):-len(".json")])
                        if w in members and w not in dead:
                            dead.append(w)
                if dead and not done:
                    shrinks += len(dead)
                    if shrinks > self.max_shrinks or len(members) - \
                            len(dead) < 1:
                        raise HostFailure(
                            f"worker(s) {dead} died with the shrink "
                            f"budget exhausted "
                            f"({shrinks}/{self.max_shrinks})")
                    gen, members = self._shrink(gen, members, dead)
                if done and all(p.poll() is not None
                                for p in self.procs.values()):
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs.values():
                if p.poll() is None:
                    p.kill()
            for p in self.procs.values():
                p.wait(timeout=30)
            if self._obs_rec is not None:
                self._obs_rec.flush()
                self._obs_rec.close()
                self._obs_rec = None
        with open(result_json) as fh:
            summary = json.load(fh)
        with np.load(os.path.join(self.run_dir, "result.npz")) as npz:
            result = {k: np.array(npz[k]) for k in npz.files}
        self._mark("done", generation=summary["generation"])
        return {"centers": result["centers"], "counts": result["counts"],
                "inertia": float(result["inertia"]),
                "folds": result["folds"],
                "generation": int(summary["generation"]),
                "n_hosts": int(summary["n_hosts"]), "shrinks": shrinks,
                "killed": killed, "timeline": list(self.timeline),
                "exit_codes": {i: p.returncode
                               for i, p in self.procs.items()},
                "launches": self._launches()}


def _main(argv):
    if len(argv) >= 4 and argv[1] == "--worker":
        run_dir, widx = argv[2], int(argv[3])
        try:
            rc = _worker_main(run_dir, widx)
        except Exception:
            import traceback

            traceback.print_exc()
            try:
                with open(os.path.join(run_dir, f"error.w{widx}.json"),
                          "w") as fh:
                    json.dump({"worker": widx,
                               "error": traceback.format_exc()}, fh)
            except OSError:
                pass
            rc = 1
        # never return through the interpreter's teardown with live
        # store clients and the lease thread: flush obs, then leave
        _flush_obs()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(rc))
    print("usage: python -m sq_learn_tpu_torch.parallel.elastic "
          "--worker <run_dir> <worker_index>", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(_main(sys.argv))
