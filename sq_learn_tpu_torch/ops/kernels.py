"""Hand-written kernels of the port (counterpart of
``sq_learn_tpu/ops/pallas_kernels.py``).

:func:`lloyd_step` is the fused Lloyd step, the twin of the TPU kernel
``lloyd_step_pallas``: one call scores every sample against every restart's
centers and returns labels, distances and the weighted per-cluster
partials. :func:`argkmin` is the fused k-nearest search, the twin of
``argkmin_pallas``. On a CUDA tensor each launches its hand-written Hopper
kernel (``csrc/lloyd.cu``, ``csrc/argkmin.cu``, built at first use, see
:mod:`._build`) or raises; on a CPU tensor it runs its plain torch version
(:func:`lloyd_step_reference`, :func:`argkmin_reference`).
``lloyd_step.launches`` and ``argkmin.launches`` count kernel launches;
``argkmin.by_shape`` counts the search's launches by (width m, k).
"""

import collections
import ctypes
import math
import numbers

import torch

from . import _build

_BIG = 1e30  # masking logit outside the δ-window (the TPU kernel's _BIG)
#: most bytes a kernel's partial results may take on the card
_PARTIAL_BYTES = 1 << 29


def lloyd_step_reference(X, weights, x_sq_norms, centers, *, gumbel=None,
                         window=0.0):
    """The fused Lloyd step in plain torch ops — the function
    ``lloyd_step_pallas`` computes, batched over R restarts.

    d2 = (‖x‖² + ‖c‖²) − 2·x·c with no 0-clamp; the label is the argmin of
    d2 or, with ``window`` > 0, the argmax of ``gumbel`` over
    {c : d2 ≤ min + window} (both take the lowest index on ties). The
    centers are rounded to X's dtype for the product, their norms stay
    float32; the weighted rows w·x are rounded once to X's dtype before
    they are summed. Everything accumulates in float32.

    Returns labels (R, n) int32, min_d2 (R, n), sums (R, k, m), counts
    (R, k) and inertia (R,), all float32 but the labels.
    """
    k = centers.shape[1]
    Xf = X.float()
    C = centers.to(X.dtype).float()
    csq = torch.sum(centers * centers, dim=-1)
    d2 = ((x_sq_norms[:, None] + csq[:, None, :])
          - 2.0 * torch.matmul(Xf, C.transpose(1, 2)))
    min_d2 = d2.min(dim=-1).values
    if window > 0:
        mask = d2 <= (min_d2 + window)[..., None]
        logits = torch.where(mask, gumbel, torch.full_like(gumbel, -_BIG))
        labels = torch.argmax(logits, dim=-1)
    else:
        labels = torch.argmin(d2, dim=-1)
    xw = (Xf * weights[:, None]).to(X.dtype).float()
    onehot = (labels[..., None] == torch.arange(k, device=X.device)).float()
    sums = torch.matmul(onehot.transpose(1, 2), xw)
    counts = torch.sum(onehot * weights[None, :, None], dim=1)
    inertia = torch.sum(min_d2 * weights, dim=-1)
    return labels.to(torch.int32), min_d2, sums, counts, inertia


def _check_lloyd_args(X, weights, x_sq_norms, centers, gumbel, window,
                      active):
    if X.ndim != 2 or X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"X must be a 2-D float32 or bfloat16 tensor, got "
            f"{tuple(X.shape)} {X.dtype}")
    n, m = X.shape
    if centers.ndim != 3 or centers.shape[2] != m \
            or centers.dtype != torch.float32:
        raise ValueError(
            f"centers must be a (R, k, {m}) float32 tensor, got "
            f"{tuple(centers.shape)} {centers.dtype}")
    R, k, _ = centers.shape
    for name, t in (("weights", weights), ("x_sq_norms", x_sq_norms)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be a ({n},) float32 tensor, got "
                f"{tuple(t.shape)} {t.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (window > 0) != (gumbel is not None):
        raise ValueError("the Gumbel operand is required exactly when "
                         "window > 0")
    if gumbel is not None and (gumbel.shape != (R, n, k)
                               or gumbel.dtype != torch.float32):
        raise ValueError(
            f"gumbel must be a ({R}, {n}, {k}) float32 tensor, got "
            f"{tuple(gumbel.shape)} {gumbel.dtype}")
    if active is not None and active.shape != (R,):
        raise ValueError(f"active must have shape ({R},), got "
                         f"{tuple(active.shape)}")
    tensors = [t for t in (X, weights, x_sq_norms, centers, gumbel, active)
               if t is not None]
    if any(t.device != X.device for t in tensors):
        raise ValueError("all lloyd_step operands must be on one device")
    return n, m, k, R


def launch_plan(n, m, k, R, n_sms, tiles):
    """(row splits, rows per split) of the CUDA fold kernel, for its
    ``tiles`` = (rows a fold block stages at once, columns a fold block
    owns) as :func:`lloyd_tiles` reads them from the library. Splits ×
    column chunks is about eight blocks per SM, every split a whole number
    of fold tiles, and the splits' partial sums stay under
    ``_PARTIAL_BYTES``."""
    fold_rows, fold_cols = tiles
    target = max(1, math.ceil(8 * n_sms / math.ceil(m / fold_cols)))
    cap = max(1, _PARTIAL_BYTES // (4 * R * (k * m + k + 1)))
    splits = max(1, min(target, math.ceil(n / fold_rows), cap))
    rows = math.ceil(math.ceil(n / splits) / fold_rows) * fold_rows
    return math.ceil(n / rows), rows


_state = {}


def _lib():
    """The Lloyd library, built and loaded at first use, its C signatures
    declared once and its tiles read."""
    lib = _state.get("lib")
    if lib is None:
        lib = _build.load("lloyd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sq_lloyd_step.argtypes = [i, p, p, p, p, p, p, p, ctypes.c_float,
                                      i, i, i, i, i, i, p, p, p, p, p, p, p]
        lib.sq_lloyd_step.restype = i
        lib.sq_lloyd_workspace_bytes.argtypes = [i] * 5
        lib.sq_lloyd_workspace_bytes.restype = ctypes.c_longlong
        lib.sq_cuda_error_string.argtypes = [i]
        lib.sq_cuda_error_string.restype = ctypes.c_char_p
        lib.sq_lloyd_tiles.argtypes = [ctypes.POINTER(i)] * 2
        lib.sq_lloyd_tiles.restype = None
        fold_rows, fold_cols = i(), i()
        lib.sq_lloyd_tiles(ctypes.byref(fold_rows), ctypes.byref(fold_cols))
        _state["lloyd_tiles"] = (fold_rows.value, fold_cols.value)
        _state["lib"] = lib
    return lib


def lloyd_tiles():
    """(rows a fold block stages at once, columns a fold block owns) of
    the CUDA kernel, as its library states them: the launch plan is cut
    to these."""
    _lib()
    return _state["lloyd_tiles"]


def _n_sms(device):
    key = ("sms", device.index)
    if key not in _state:
        _state[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _state[key]


def lloyd_step(X, weights, x_sq_norms, centers, *, gumbel=None, window=0.0,
               active=None):
    """Fused Lloyd step over R restarts (see :func:`lloyd_step_reference`
    for what it computes).

    Parameters
    ----------
    X : (n, m) float32 or bfloat16 — samples; bfloat16 serves
        ``compute_dtype='bfloat16'``.
    weights, x_sq_norms : (n,) float32 — sample weights (0 masks a row)
        and squared row norms.
    centers : (R, k, m) float32.
    gumbel : (R, n, k) float32 Gumbel noise, required iff ``window`` > 0.
    window : δ-means window on squared distances; 0 is the classic argmin.
    active : optional (R,) mask; on the card the kernel compacts the
        active restarts, an inactive one costs no products and its outputs
        are zeros.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (and counts it in ``lloyd_step.launches``) or raises.
    """
    window = float(window)
    n, m, k, R = _check_lloyd_args(X, weights, x_sq_norms, centers, gumbel,
                                   window, active)
    if X.device.type == "cpu":
        return lloyd_step_reference(X, weights, x_sq_norms, centers,
                                    gumbel=gumbel, window=window)
    if X.device.type != "cuda":
        raise ValueError(f"lloyd_step runs on cpu or cuda, not {X.device}")
    X, weights, x_sq_norms = (X.contiguous(), weights.contiguous(),
                              x_sq_norms.contiguous())
    C = centers.to(X.dtype).float().contiguous()
    csq = torch.sum(centers * centers, dim=-1).contiguous()
    if gumbel is not None:
        gumbel = gumbel.contiguous()
    act = None if active is None else active.to(torch.int32).contiguous()
    lib = _lib()
    dev = X.device
    splits, rows = launch_plan(n, m, k, R, _n_sms(dev), lloyd_tiles())
    # the kernel writes every output, zeros for an inactive restart
    labels = torch.empty((R, n), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((R, n), dtype=torch.float32, device=dev)
    sums = torch.empty((R, k, m), dtype=torch.float32, device=dev)
    counts = torch.empty((R, k), dtype=torch.float32, device=dev)
    inertia = torch.empty((R,), dtype=torch.float32, device=dev)
    work = torch.empty(lib.sq_lloyd_workspace_bytes(n, m, k, R, splits),
                       dtype=torch.uint8, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sq_lloyd_step(
            0 if X.dtype == torch.float32 else 1, ptr(X), ptr(weights),
            ptr(x_sq_norms), ptr(C), ptr(csq), ptr(gumbel), ptr(act),
            window, n, m, k, R, splits, rows, ptr(labels), ptr(min_d2),
            ptr(work), ptr(sums), ptr(counts), ptr(inertia), stream)
    if err != 0:
        raise RuntimeError(
            f"lloyd kernel launch failed: "
            f"{lib.sq_cuda_error_string(err).decode()} (cudaError {err})")
    lloyd_step.launches += 1
    return labels, min_d2, sums, counts, inertia


lloyd_step.launches = 0


def lloyd_step_work(n, m, k, R, x_dtype, window):
    """(bytes, operations) the fused step must move and do: every input
    read once and every output written once; 2·n·m·k·R distance-product
    operations, then for the weighted sums n·m multiplies w·x (the same for
    every restart) and n·m·R adds."""
    x_bytes = n * m * (2 if x_dtype == torch.bfloat16 else 4)
    inputs = x_bytes + 8 * n + 4 * R * k * m + (4 * R * n * k
                                                if window > 0 else 0)
    outputs = 8 * R * n + 4 * R * k * m + 4 * R * k + 4 * R
    return inputs + outputs, 2 * n * m * k * R + n * m * R + n * m


# ---------------------------------------------------------------------------
# Fused k-nearest search (the twin of ``argkmin_pallas``)
# ---------------------------------------------------------------------------

#: score rows the plain version holds at once, times the train count
_REFERENCE_BLOCK = 1 << 24


def argkmin_reference(X_train, x_sq_train, X_query, k):
    """The fused k-nearest search in plain torch ops — the function
    ``argkmin_pallas`` computes.

    Each query ranks the training rows by the score ‖t‖² − 2·q·t (float32,
    no query norm, no clamp) and keeps the k smallest, ascending, ties to
    the lowest training index (a stable sort, as ``lax.top_k`` orders
    them). Then ‖q‖² = sum(q*q) is added and the result clamped at 0. The
    queries are taken in blocks, so the whole (nq, nt) score matrix never
    exists at once.

    Returns idx (nq, k) int32 and d2 (nq, k) float32.
    """
    nq, nt = X_query.shape[0], X_train.shape[0]
    block = max(1, _REFERENCE_BLOCK // nt)
    idx = torch.empty((nq, k), dtype=torch.int32, device=X_query.device)
    best = torch.empty((nq, k), dtype=torch.float32, device=X_query.device)
    for q0 in range(0, nq, block):
        q = X_query[q0:q0 + block]
        score = x_sq_train[None, :] - 2.0 * torch.matmul(q, X_train.T)
        vals, order = torch.sort(score, dim=1, stable=True)
        idx[q0:q0 + block] = order[:, :k].to(torch.int32)
        best[q0:q0 + block] = vals[:, :k]
    qsq = torch.sum(X_query * X_query, dim=1)
    return idx, torch.clamp(best + qsq[:, None], min=0.0)


def _check_argkmin_args(X_train, x_sq_train, X_query, k):
    tensors = (("X_train", X_train), ("x_sq_train", x_sq_train),
               ("X_query", X_query))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if X_train.ndim != 2 or X_query.ndim != 2 \
            or X_query.shape[1] != X_train.shape[1]:
        raise ValueError(
            f"X_train (nt, m) and X_query (nq, m) must be 2-D of one width, "
            f"got {tuple(X_train.shape)} and {tuple(X_query.shape)}")
    nt, m = X_train.shape
    if x_sq_train.shape != (nt,):
        raise ValueError(f"x_sq_train must have shape ({nt},), got "
                         f"{tuple(x_sq_train.shape)}")
    if any(t.device != X_train.device for _, t in tensors):
        raise ValueError("all argkmin operands must be on one device")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (isinstance(k, bool) or not isinstance(k, numbers.Integral)
            or not 0 < k <= nt):
        raise ValueError(f"k={k} outside 1..{nt}")
    return nt, X_query.shape[0], m, int(k)


def argkmin_plan(nq, nt, k, n_sms, tiles):
    """(splits, rows per split) of the CUDA kernel, for its ``tiles`` =
    (queries a block owns, train rows per tile, blocks resident on an SM)
    as :func:`argkmin_tiles` reads them from the library for k's route.

    The train rows are cut into splits of a whole number of tiles, and a
    block scores one query tile against one split. There are enough splits
    to give every resident block of the card a block to run, where the
    train rows allow it, and at most four times that many; among those the
    plan takes the one that finishes first when blocks run in waves of
    the card's resident blocks (waves × tiles a block walks), and the
    fewest splits on a tie. The partial lists stay under
    ``_PARTIAL_BYTES``. Every split but the last holds at least k rows.
    The last may hold fewer, down to one: its list is then padded with
    (inf, no index), which the merge ranks after every real row."""
    tile_q, tile_t, resident = tiles
    qtiles = math.ceil(nq / tile_q)
    slots = n_sms * resident
    ntiles = math.ceil(nt / tile_t)
    cap = max(1, _PARTIAL_BYTES // (8 * nq * k))
    per_split = {}  # splits -> the fewest tiles per split that give them
    for per in range(math.ceil(k / tile_t), ntiles + 1):
        splits = math.ceil(ntiles / per)
        if splits <= cap:
            per_split.setdefault(splits, per)
    fill = min(math.ceil(slots / qtiles), max(per_split))
    # the achievable counts ceil(ntiles / per) are dense enough that one
    # lies in [fill, 4 fill]
    splits = min((s for s in per_split if fill <= s <= 4 * fill),
                 key=lambda s: (math.ceil(qtiles * s / slots) * per_split[s],
                                s))
    return splits, per_split[splits] * tile_t


#: sq_argkmin_route's codes: the short-list kernel, or the long-list
#: kernel with its lists in shared or in global memory
_ROUTES = ("short", "shared", "global")


def _argkmin_lib():
    """The argkmin library, built and loaded at first use, its C
    signatures declared once."""
    lib = _state.get("argkmin")
    if lib is None:
        lib = _build.load("argkmin")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sq_argkmin.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p,
                                   p, p]
        lib.sq_argkmin.restype = i
        lib.sq_argkmin_route.argtypes = [i]
        lib.sq_argkmin_route.restype = i
        lib.sq_argkmin_error_string.argtypes = [i]
        lib.sq_argkmin_error_string.restype = ctypes.c_char_p
        lib.sq_argkmin_tiles.argtypes = [i] + [ctypes.POINTER(i)] * 3
        lib.sq_argkmin_tiles.restype = i
        _state["argkmin"] = lib
    return lib


def _argkmin_error(lib, what, code):
    return RuntimeError(f"argkmin {what}: "
                        f"{lib.sq_argkmin_error_string(code).decode()} "
                        f"(cudaError {code})")


def argkmin_route(k, device):
    """The kernel the CUDA search takes for k on ``device``: ``"short"``
    (the register-tiled kernel of short lists), or the long-list kernel
    with its k-best lists in ``"shared"`` or in ``"global"`` memory. The
    library decides by k alone, for the device's shared memory."""
    lib = _argkmin_lib()
    with torch.cuda.device(device):
        code = lib.sq_argkmin_route(int(k))
    if code < 0:
        raise _argkmin_error(lib, "route", -code)
    return _ROUTES[code]


def argkmin_tiles(k, device):
    """(queries a block owns, train rows per tile, blocks resident on an
    SM) of the kernel k's route takes on ``device``, as its library states
    them: the launch plan is cut to these."""
    device = torch.device(device)
    key = ("argkmin_tiles", argkmin_route(k, device), device.index)
    if key not in _state:
        lib = _argkmin_lib()
        tile_q, tile_t, resident = (ctypes.c_int() for _ in range(3))
        with torch.cuda.device(device):
            err = lib.sq_argkmin_tiles(int(k), ctypes.byref(tile_q),
                                       ctypes.byref(tile_t),
                                       ctypes.byref(resident))
        if err != 0:
            raise _argkmin_error(lib, "tiles", err)
        _state[key] = (tile_q.value, tile_t.value, resident.value)
    return _state[key]


def argkmin(X_train, x_sq_train, X_query, k):
    """Indices and squared distances of the k nearest training rows of
    every query, ascending (see :func:`argkmin_reference` for what it
    computes).

    Parameters
    ----------
    X_train : (nt, m) float32, contiguous.
    x_sq_train : (nt,) float32 — squared row norms of X_train.
    X_query : (nq, m) float32, contiguous.
    k : int with 1 ≤ k ≤ nt.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of ``csrc/argkmin.cu`` (and counts it in ``argkmin.launches`` and in
    ``argkmin.by_shape[(m, k)]``) or raises. Returns idx (nq, k) int32
    and d2 (nq, k) float32.
    """
    nt, nq, m, k = _check_argkmin_args(X_train, x_sq_train, X_query, k)
    dev = X_train.device
    if dev.type == "cpu":
        return argkmin_reference(X_train, x_sq_train, X_query, k)
    if dev.type != "cuda":
        raise ValueError(f"argkmin runs on cpu or cuda, not {dev}")
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    lib = _argkmin_lib()
    splits, rows = argkmin_plan(nq, nt, k, _n_sms(dev), argkmin_tiles(k, dev))
    part_d = torch.empty(splits * nq * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(splits * nq * k, dtype=torch.int32, device=dev)
    buf_d = buf_i = None
    if splits > 1:
        buf_d = torch.empty(2 * nq * k, dtype=torch.float32, device=dev)
        buf_i = torch.empty(2 * nq * k, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sq_argkmin(
            ptr(X_train), ptr(x_sq_train), ptr(X_query), nt, nq, m, k,
            splits, rows, ptr(part_d), ptr(part_i), ptr(buf_d), ptr(buf_i),
            ptr(idx), ptr(d2), stream)
    if err != 0:
        raise _argkmin_error(lib, "kernel launch failed", err)
    argkmin.launches += 1
    argkmin.by_shape[(m, k)] += 1
    return idx, d2


argkmin.launches = 0
argkmin.by_shape = collections.Counter()


def argkmin_work(nq, nt, m, k):
    """(bytes, operations) the search must move and do: the train rows,
    their norms and the queries read once, the (nq, k) indices and
    distances written once; 2·nq·nt·m operations for the score products."""
    return 4 * (nt * m + nt + nq * m) + 8 * nq * k, 2 * nq * nt * m
