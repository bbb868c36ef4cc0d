"""Checkpoint / resume (counterpart of ``sq_learn_tpu/utils/checkpoint.py``).

The file formats are the JAX package's, so a checkpoint written by either
package reads in the other:

- :func:`save_estimator` / :func:`load_estimator` — a fitted estimator as a
  directory of ``meta.json`` (format ``sq-learn-tpu-estimator-v1``,
  ``format_version`` 2: class path, hyperparameters, the CRC32
  ``state_digest`` of ``state.npz``) plus ``state.npz`` (every public
  fitted attribute; tensors are written as numpy arrays). Private ``_*``
  attributes are transient, as in the JAX package, so a device cache a
  fit keeps in one (the k-NN training norms) is rebuilt on first use
  after a load. A checkpoint the JAX package wrote names a class of
  ``sq_learn_tpu``; the port never imports it, and maps the name to its
  own estimator through the :mod:`~sq_learn_tpu_torch.convert` functions.
- :func:`save_pytree` / :func:`load_pytree` — nested tuples, lists and
  dicts of tensors or arrays flattened to ``.npz`` as positional leaves
  (dict keys in sorted order, as ``jax.tree_util`` flattens them).
- :func:`save_stream_state` / :func:`load_stream_state` — a streamed
  pass's accumulator leaves (``leaf_i``), tile cursor (``__cursor__``)
  and pass fingerprint (``__fingerprint__``), written with fsync and the
  previous file kept as ``<path>.prev``; :class:`AsyncStreamCheckpointer`
  writes them from a worker thread.
"""

import importlib
import json
import os
import threading
import zlib

import numpy as np
import torch

_SCALARS = (int, float, bool, str, type(None))

#: estimator-checkpoint format version (the JAX package's): 1 = meta.json +
#: state.npz; 2 adds ``state_digest`` and ``format_version``. v1 loads
#: unchecked; a future version is refused.
FORMAT_VERSION = 2
FORMAT = "sq-learn-tpu-estimator-v1"

#: the JAX package's estimator classes, by the ``class`` its checkpoints
#: record, and the converter that builds the port's counterpart
_JAX_CLASSES = {
    "sq_learn_tpu.models.qkmeans.QKMeans": "qkmeans_from_numpy",
    "sq_learn_tpu.models.qkmeans.KMeans": "qkmeans_from_numpy",
    "sq_learn_tpu.models.neighbors.KNeighborsClassifier":
        "kneighbors_from_numpy",
    "sq_learn_tpu.models.qpca.QPCA": "qpca_from_numpy",
    "sq_learn_tpu.models.qlssvc.QLSSVC": "qlssvc_from_numpy",
    "sq_learn_tpu.models.minibatch.MiniBatchQKMeans": "minibatch_from_numpy",
    "sq_learn_tpu.models.minibatch.MiniBatchKMeans": "minibatch_from_numpy",
    "sq_learn_tpu.models.truncated_svd.TruncatedSVD":
        "truncated_svd_from_numpy",
    "sq_learn_tpu.preprocessing.StandardScaler": "scaler_from_numpy",
    "sq_learn_tpu.preprocessing.MinMaxScaler": "scaler_from_numpy",
    "sq_learn_tpu.preprocessing.Normalizer": "scaler_from_numpy",
}

_PORT = "sq_learn_tpu_torch."


def _is_array(v):
    return isinstance(v, (np.ndarray, torch.Tensor))


def _to_numpy(v):
    """A tensor fetched to the host as numpy, or ``np.asarray(v)``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _file_crc32(path):
    crc = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc:08x}"


def _class_path(obj):
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _import_port_class(path):
    """The port's class named by ``path`` (``sq_learn_tpu_torch.…``)."""
    module, _, name = path.rpartition(".")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def save_estimator(estimator, path):
    """Serialize a fitted estimator to directory ``path``.

    Hyperparameters come from ``get_params(deep=False)``; fitted state is
    every other public instance attribute. Attributes that are neither
    arrays (tensors or ndarrays) nor JSON scalars are recorded in
    ``skipped_state``. Returns ``path``.
    """
    os.makedirs(path, exist_ok=True)
    hyper = estimator.get_params(deep=False)
    params = {}
    skipped_params = []
    for k, v in hyper.items():
        if isinstance(v, _SCALARS):
            params[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, _SCALARS) for x in v):
            params[k] = list(v)
        elif _is_array(v):
            params[k] = {"__array__": f"param_{k}"}
        else:
            skipped_params.append(k)

    arrays = {}
    state_scalars = {}
    state_arrays = []
    skipped_state = []
    for k, v in vars(estimator).items():
        if k.startswith("_") or k in hyper:
            continue
        if _is_array(v):
            arrays[f"state_{k}"] = _to_numpy(v)
            state_arrays.append(k)
        elif isinstance(v, _SCALARS):
            state_scalars[k] = v
        elif isinstance(v, (np.floating, np.integer, np.bool_)):
            state_scalars[k] = v.item()
        else:
            skipped_state.append(k)

    for k, v in hyper.items():
        if _is_array(v):
            arrays[f"param_{k}"] = _to_numpy(v)

    # the npz first, so its digest can ride in the meta
    np.savez(os.path.join(path, "state.npz"), **arrays)
    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "state_digest": _file_crc32(os.path.join(path, "state.npz")),
        "class": _class_path(estimator),
        "params": params,
        "skipped_params": skipped_params,
        "state_scalars": state_scalars,
        "state_arrays": state_arrays,
        "skipped_state": skipped_state,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return path


def load_estimator(path, device=None):
    """Reconstruct an estimator saved by :func:`save_estimator` (either
    package's), its inference on ``device`` (None = the configured one).

    v2 checkpoints are digest-verified: a ``state.npz`` whose CRC32 does not
    match ``meta.state_digest`` raises :class:`ValueError`. A checkpoint of
    a future format version, or of a class the port has no counterpart
    for, raises.
    """
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not an estimator checkpoint: {path}")
    version = meta.get("format_version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"estimator checkpoint {path} has format_version {version}; "
            f"this build reads <= {FORMAT_VERSION} — refusing to guess "
            "at an unknown layout")
    digest = meta.get("state_digest")
    if digest is not None:
        actual = _file_crc32(os.path.join(path, "state.npz"))
        if actual != digest:
            raise ValueError(
                f"estimator checkpoint {path} is stale or corrupt: "
                f"state.npz digest {actual} != recorded {digest} "
                "(refusing to load a fitted model whose state does not "
                "match its manifest)")
    with np.load(os.path.join(path, "state.npz")) as npz:
        params = {k: (npz[v["__array__"]]
                      if isinstance(v, dict) and "__array__" in v else v)
                  for k, v in meta["params"].items()}
        state = dict(meta["state_scalars"])
        for k in meta["state_arrays"]:
            state[k] = npz[f"state_{k}"]
    cls_path = meta["class"]
    if cls_path.startswith(_PORT):
        cls = _import_port_class(cls_path)
        if device is not None and "device" in cls._get_param_names():
            params["device"] = device
        est = cls(**params)
        for k, v in state.items():
            setattr(est, k, v)
        return est
    if cls_path not in _JAX_CLASSES:
        raise ValueError(
            f"estimator checkpoint {path} holds a {cls_path!r}, which the "
            f"port has no counterpart for")
    from .. import convert

    build = getattr(convert, _JAX_CLASSES[cls_path])
    if build is convert.scaler_from_numpy:
        return build(state, scaler=cls_path.rpartition(".")[2],
                     device=device, params=params)
    return build(state, device=device, params=params)


# ---------------------------------------------------------------------------
# pytree checkpointing (mid-run state)
# ---------------------------------------------------------------------------


def tree_leaves(tree):
    """Leaves of nested tuples/lists/dicts, depth first (dict keys sorted,
    the order ``jax.tree_util`` gives)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def _unflatten(like, leaves):
    """``leaves`` (an iterator) in the structure of ``like``."""
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    if isinstance(like, dict):
        out = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    return next(leaves)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``, in its structure."""
    return _unflatten(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def save_pytree(path, tree, step=None):
    """Save a tree of tensors or arrays to ``path`` (an ``.npz`` file);
    ``step`` is an optional integer recorded alongside."""
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.asarray(f"leaves={len(leaves)}")
    if step is not None:
        arrays["__step__"] = np.asarray(int(step))
    np.savez(path, **arrays)
    return path


def load_pytree(path, like):
    """Load a tree saved by :func:`save_pytree` (either package's) into the
    structure of ``like`` (its leaf values are ignored); leaves come back
    as numpy arrays. Returns ``(tree, step)``."""
    with np.load(path if str(path).endswith(".npz")
                 else str(path) + ".npz", allow_pickle=False) as npz:
        n = sum(1 for k in npz.files if k.startswith("leaf_"))
        leaves = [npz[f"leaf_{i}"] for i in range(n)]
        step = int(npz["__step__"]) if "__step__" in npz.files else None
    expected = len(tree_leaves(like))
    if expected != n:
        raise ValueError(
            f"checkpoint has {n} leaves; template has {expected}")
    return _unflatten(like, iter(leaves)), step


# ---------------------------------------------------------------------------
# streaming-pass checkpoints (resumable tiled passes)
# ---------------------------------------------------------------------------


def save_stream_state(path, acc, cursor, fingerprint):
    """Checkpoint a streamed pass: the accumulator's leaves, the tile
    ``cursor`` (the next tile to process) and the pass ``fingerprint``
    that :func:`load_stream_state` matches.

    The temp file is fsynced before it is renamed, the previous checkpoint
    is kept as ``<path>.prev``, and only then does the new file take the
    primary name: a kill at any instant leaves one complete snapshot.
    """
    arrays = {f"leaf_{i}": _to_numpy(x)
              for i, x in enumerate(tree_leaves(acc))}
    arrays["__cursor__"] = np.asarray(int(cursor))
    arrays["__fingerprint__"] = np.asarray(str(fingerprint))
    tmp = str(path) + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    if os.path.exists(path):
        os.replace(path, str(path) + ".prev")
    os.replace(tmp, path)
    return path


class AsyncStreamCheckpointer:
    """Background writer for :func:`save_stream_state` snapshots.

    :meth:`submit` takes the accumulator as it stands: a tensor on the card
    is cloned there (queued on the caller's stream, so the next tile's
    in-place update cannot reach the snapshot) and an event is recorded;
    the worker thread waits on that event, fetches the clone to the host
    and writes it. The tile loop pays the clone's launch, never a host
    sync or the I/O. Host arrays are copied on the caller's thread.

    - **latest-wins**: a snapshot submitted while the previous one is
      writing replaces any pending one (``dropped``); a resume then
      replays a few more tiles, with the same bits.
    - :meth:`close` drains the pending write; a writer-side error is
      re-raised on the next :meth:`submit`/:meth:`close`.
    """

    #: lock-discipline contract (sqcheck, ``sq_learn_tpu/utils/
    #: checkpoint.py``'s map): writer/caller shared state is only written
    #: under ``self._cond``.
    _GUARDED_BY = {"_cond": ("_pending", "_writing", "_error", "_stop",
                             "writes", "dropped")}

    def __init__(self, path):
        self.path = str(path)
        self.writes = 0
        self.dropped = 0
        self._cond = threading.Condition()
        self._pending = None
        self._writing = False
        self._error = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sq-stream-ckpt-writer")
        self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None:
                    return
                snap, event, cursor, fingerprint = self._pending
                self._pending = None
                self._writing = True
            try:
                if event is not None:
                    event.synchronize()
                save_stream_state(self.path, snap, cursor, fingerprint)
            except Exception as exc:  # surfaced on next submit/close
                with self._cond:
                    self._error = exc
            finally:
                with self._cond:
                    self._writing = False
                    self.writes += 1
                    self._cond.notify_all()

    def submit(self, acc, cursor, fingerprint):
        """Queue one snapshot (latest-wins). Raises a previous write's
        error here rather than losing it."""
        event = None

        def snap(a):
            nonlocal event
            if isinstance(a, torch.Tensor):
                c = a.detach().clone()
                if c.is_cuda and event is None:
                    event = torch.cuda.Event()
                return c
            return np.array(a, copy=True)

        host = tree_map(snap, acc)
        if event is not None:
            event.record()
        with self._cond:
            if self._error is not None:
                raise self._error
            if self._pending is not None:
                self.dropped += 1
            self._pending = (host, event, int(cursor), str(fingerprint))
            self._cond.notify_all()

    def close(self):
        """Drain the pending write, stop the worker, re-raise any writer
        error. Idempotent."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()
        if self._error is not None:
            raise self._error


def _read_stream_state(path, like, fingerprint):
    """One checkpoint-file read attempt: ``("ok", payload)``,
    ``("absent", None)``, ``("corrupt", None)`` or ``("mismatch", None)``
    (a complete checkpoint of a different pass)."""
    if not os.path.exists(path):
        return "absent", None
    try:
        npz = np.load(path, allow_pickle=False)
    except Exception:
        return "corrupt", None
    try:
        with npz:
            if ("__fingerprint__" not in npz.files
                    or "__cursor__" not in npz.files):
                return "corrupt", None
            if str(npz["__fingerprint__"]) != str(fingerprint):
                return "mismatch", None
            n = sum(1 for k in npz.files if k.startswith("leaf_"))
            if len(tree_leaves(like)) != n:
                return "mismatch", None
            leaves = [npz[f"leaf_{i}"] for i in range(n)]
            cursor = int(npz["__cursor__"])
    except Exception:
        # a zip directory can parse while a member is truncated: the torn
        # tail surfaces on the member read
        return "corrupt", None
    return "ok", (_unflatten(like, iter(leaves)), cursor)


def load_stream_state(path, like, fingerprint):
    """Load a streamed-pass checkpoint saved by :func:`save_stream_state`.

    Returns ``(acc_tree, cursor)`` with numpy leaves in the structure of
    ``like``, or None when no usable checkpoint exists. A newest file that
    is corrupt, or absent while ``<path>.prev`` exists, falls back to the
    previous snapshot; a checkpoint with another ``fingerprint`` is another
    pass: ignored, without fallback.
    """
    status, out = _read_stream_state(path, like, fingerprint)
    if status == "ok":
        return out
    if status == "mismatch":
        return None
    status, out = _read_stream_state(str(path) + ".prev", like, fingerprint)
    return out if status == "ok" else None
