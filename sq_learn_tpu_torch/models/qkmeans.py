"""q-means clustering (counterpart of ``sq_learn_tpu/models/qkmeans.py``).

The fit follows the JAX package's accelerator route (``_fit_fused``):
:func:`fused_init` computes the pre-fit statistics and every restart's
start centers, :func:`fused_fit` runs every restart's Lloyd loop and picks
the best, and the host fetches the result once at the end.

The Lloyd loop has no ``lax.while_loop`` here: :func:`lloyd_single` is a
host loop over a batch of R restarts whose state lives on the device.
Each iteration is one :func:`~sq_learn_tpu_torch.ops.kernels.lloyd_step`
(the fused kernel on a CUDA tensor) — or, in the IPE mode
(``true_distance_estimate=True``, the reference's q-means), the IPE
E-step and the one-hot partial sums in plain torch, as the JAX package
leaves that mode to XLA — then the empty-cluster relocation, the center
update and, with ``intermediate_error``, tomography of the updated
centers at δ/2. A restart whose stop rule fired is frozen by
``torch.where`` — what ``vmap`` over ``while_loop`` does — and its kernel
blocks exit at once; the host reads the stop rule before each of the
first ``CHECK_EVERY`` iterations and every ``CHECK_EVERY`` after them.
Best-tracking, the NaN-padded traces, the final re-evaluation of the last
centers against the best ones and ``n_iter`` are those of the reference.
Every draw (Gumbel picks, IPE, tomography) comes from the fit's one
generator, in shapes that do not depend on which restarts are frozen, so
a fit is reproducible from ``random_state``.

With δ > 0 the fit computes the runtime model's statistics: exactly, or
with ``sketch`` engaged from a uniform row sample drawn by a numpy
generator seeded apart from the fit's (:mod:`~sq_learn_tpu_torch.sketch`).
They are computed on every fit and never read from the digest cache.

Under an obs run (:mod:`sq_learn_tpu_torch.obs`) a fit records the JAX
accelerator route's spans (``qkmeans.fit``, ``qkmeans.fused_init``,
``qkmeans.fused_fit``; ``qkmeans.quantum_stats`` around the runtime
statistics' fetch and fold, which the JAX package times on its host
route), one ``qkmeans``/``fit`` ledger entry priced by
:meth:`QKMeans.quantum_runtime_model`, and one audit replay of the fit's
error model on ≤ 256 rows (:meth:`QKMeans._audit_fit_entry`), drawn from
generators of its own. The fit loop itself records no guarantee draws,
as the JAX package's traced loop records none, and a fit's results and
kernel launches are the same with obs on or off, and under a
``torch.profiler``. The port's own spans, which the JAX package's jitted
loop cannot have, mark each layer inside: ``qkmeans.stats`` and
``qkmeans.seed`` in the init; ``qkmeans.lloyd`` around the loop, one
``qkmeans.lloyd_iter`` a step (``qkmeans.gumbel``, the kernel's
``kernels.lloyd_step`` or ``qkmeans.e_step``, ``qkmeans.relocate``,
``qkmeans.update``) and ``qkmeans.finish``; and a ``sync.<site>`` span
around every read of the device by the host and every upload that waits
for it (``sync.qkmeans.sketch_rows``, ``.stop_rule``, ``.stats``,
``.best``, ``.fetch``, ``.quantum_stats``, and ``sync.validation``).
While a profiler records each is a range of its name, obs on or off
(:func:`sq_learn_tpu_torch.obs.span`).

Ingest, as in the JAX package's staged route: host data larger than the
streaming engine's tile cap (``SQ_TRANSFER_CHUNK_BYTES``, 128 MiB) is
assembled on the device tile by tile (``streamed_prestats``, the upload
staged through pinned memory and its values checked there), and
``ingest_`` records the route; ``predict`` of such data walks it in tiles
too. float16 and data that is not float32 run the Lloyd step as plain
torch ops, as the JAX package runs them off its kernel, and
``algorithm='elkan'`` warns and runs the Lloyd route.

``mesh`` (a :class:`~sq_learn_tpu_torch.parallel.mesh.Mesh`) runs the fit
data-parallel, as the JAX package's mesh route does: the pre-fit
statistics on the mesh's first device (exact, no sketch), every
restart's k-means++ init from
:func:`~sq_learn_tpu_torch.parallel.init.kmeans_plusplus_sharded` (the
uniforms the single-device init draws; no init subsample), then the
restarts one by one through
:func:`~sq_learn_tpu_torch.parallel.lloyd.lloyd_single_sharded`, the best
by inertia kept. Host data is not streamed under a mesh.
"""

import functools
import numbers
import warnings

import numpy as np
import torch

from .. import obs as _obs
from .._config import resolve_device
from ..base import (BaseEstimator, ClusterMixin, TransformerMixin,
                    check_is_fitted, check_n_features)
from ..ops.kernels import lloyd_step
from ..ops.linalg import (check_compute_dtype, inner_product, is_reduced,
                          pairwise_sq_distances, row_norms,
                          smallest_singular_value)
from ..ops.quantum.estimation import inner_product_estimates, ipe_matrix
from ..ops.quantum.noise import gaussian_estimate
from ..ops.quantum.norms import _mu_grid
from ..ops.quantum.tomography import real_tomography
from ..parallel.init import (kmeans_plusplus_batched,
                             kmeans_plusplus_sharded, resolve_init_subsample)
from ..parallel.lloyd import lloyd_single_sharded
from ..parallel.mesh import (ShardedRows, check_mesh, pad_to_multiple,
                             shard_rows)
from ..sketch.engine import (AUDIT_ELEMS, SKETCH_SEED, audit_sketch,
                             exact_bundle, fetch_components,
                             finalize_components, record_sketch_obs,
                             resolve_sketch_rows, sample_indices,
                             sketch_components, sketch_delta_stat)
from ..streaming import stream_map_rows, streamed_prestats
from ..utils.plotting import plot_runtime_surfaces
from ..utils.random import as_generator, gumbel
from ..utils.validation import (check_sample_weight, host_ingest,
                                validation_scope)

LloydMode = ("classic", "delta", "ipe")

# μ_p(A) search grid (reference ``best_mu``'s 0.1-step default)
MU_GRID = tuple(round(0.1 * i, 1) for i in range(11))

#: iterations between two host reads of the restarts' stop rule, once the
#: first CHECK_EVERY iterations (each followed by a read) have run
CHECK_EVERY = 8


def _stop_rule_read_due(step):
    """Whether the host reads the stop rule before iteration ``step``:
    before each of the first ``CHECK_EVERY`` iterations, where short fits
    stop, then every ``CHECK_EVERY``. Between two reads a stopped restart
    only rides along, frozen."""
    return step < CHECK_EVERY or step % CHECK_EVERY == 0

#: half-width of the IPE sampler's window in the E-step (the sampler's
#: default is 64): the per-pair grids are far wider than 2W+1 for most
#: pairs at any practical window, truncation only tightens the within-ε
#: guarantee, and the JAX package measured equal estimate errors at
#: W ∈ {16, 32, 64} with the E-step 4× cheaper at 16
IPE_WINDOW = 16

def _on_device(X, device):
    """``X`` as a tensor on ``device``: host data of a streamed fit is
    uploaded for the sketch audit, which reads nothing above
    ``AUDIT_ELEMS`` elements."""
    if isinstance(X, torch.Tensor) or X.size > AUDIT_ELEMS:
        return X
    return torch.from_numpy(X).to(device)


def tolerance(X, tol):
    """Scale ``tol`` by the mean per-feature variance (reference
    ``_tolerance``, ``_dmeans.py:253``)."""
    if tol == 0:
        return 0.0
    return float(tol * torch.mean(torch.var(X, dim=0, correction=0)))


def fit_prestats(X, *, quantum=False, mu_grid=(), sketch_idx=None):
    """Every pre-fit statistic: the mean, the centered data and its row
    norms, the mean variance that scales ``tol`` and, with ``quantum``,
    the runtime-model statistics η = max‖xᵢ‖², the μ_p(A) grid, ‖A‖_F
    and σ_min (reference ``Utility.py:215-231``, ``_dmeans.py:1242-1245``).

    ``sketch_idx`` (an (s,) row-index tensor) replaces the exact σ_min
    Gram and μ sweep by the sketched components of
    :func:`~sq_learn_tpu_torch.sketch.engine.sketch_components`, under a
    ``"sketch"`` sub-dict; the host folds the certified bounds in after
    the fetch. None keeps the exact statistics."""
    mean = torch.mean(X, dim=0)
    Xc = X - mean
    out = {
        "mean": mean,
        "Xc": Xc,
        "xsq": row_norms(Xc, squared=True),
        "var_mean": torch.mean(torch.var(X, dim=0, correction=0)),
    }
    # the Gram's eigh reads its solver's status back from the device
    if quantum and sketch_idx is not None:
        with _obs.span("sync.qkmeans.stats"):
            out["sketch"] = sketch_components(X, sketch_idx, mu_grid)
    elif quantum:
        out["eta"] = torch.max(row_norms(X, squared=True))
        out["mu_vals"] = _mu_grid(X, mu_grid)
        out["frob"] = torch.linalg.norm(X)
        with _obs.span("sync.qkmeans.stats"):
            out["sigma_min"] = smallest_singular_value(X)
    return out


# ---------------------------------------------------------------------------
# Functional core (restarts are a leading batch dimension throughout)
# ---------------------------------------------------------------------------


def _take_rows(C, idx):
    """C[..., idx, :] for (k, m) or batched (R, k, m) centers."""
    if C.ndim == 2:
        return C[idx]
    return torch.gather(C, 1, idx[..., None].expand(*idx.shape, C.shape[-1]))


def e_step(generator, X, weights, centers, x_sq_norms, *, delta, mode,
           ipe_q=5, compute_dtype=None):
    """Assignment step with the quantum error model.

    ``centers`` is (k, m) or a batch (R, k, m). Returns (labels, inertia,
    min_d2) shaped (n,), () and (n,) or with a leading R. In ``delta``
    mode each label is a uniform pick among the centers within ``delta``
    of the nearest one, drawn as the argmax of Gumbel noise from
    ``generator`` (the reference draws ``jax.random.categorical`` over the
    same mask: the same distribution). In ``ipe`` mode the distances are
    ‖x‖² + ‖c‖² − 2·est, with est the IPE estimates of the inner products
    at ε = δ/2 (``ipe_q`` repetitions, window :data:`IPE_WINDOW`), and
    the pick is uniform among exact ties of those distances. With a
    reduced ``compute_dtype`` the selection runs on the reduced-precision
    distances and, outside ``ipe`` mode, the selected distance is
    recomputed exactly.
    """
    reduced = is_reduced(compute_dtype, X.dtype)
    if mode == "ipe":
        c_sq = row_norms(centers, squared=True)
        est = ipe_matrix(generator, inner_product(X, centers, compute_dtype),
                         x_sq_norms, c_sq, epsilon=delta / 2, Q=ipe_q,
                         window=IPE_WINDOW)
        d2 = x_sq_norms[:, None] + c_sq[..., None, :] - 2.0 * est
        window = 0.0
    else:
        d2 = pairwise_sq_distances(X, centers, x_sq_norms,
                                   compute_dtype=compute_dtype)
        window = delta if mode == "delta" else 0.0
    # the window/tie mask uses the precision d2 was computed in
    noisy_min = torch.min(d2, dim=-1).values
    if reduced and mode != "ipe":
        c_min = _take_rows(centers, torch.argmin(d2, dim=-1))
        min_d2 = torch.clamp(
            x_sq_norms + row_norms(c_min, squared=True)
            - 2.0 * torch.sum(X * c_min, dim=-1), min=0.0)
    else:
        min_d2 = noisy_min
    if mode == "classic":
        labels = torch.argmin(d2, dim=-1).to(torch.int32)
    else:
        labels = pick_labels(generator, d2, window, noisy_min)
    inertia = torch.sum(min_d2 * weights, dim=-1)
    return labels, inertia, min_d2


def pick_labels(generator, d2, window, d2_min=None):
    """A uniform pick among the centers within ``window`` of each row's
    nearest one in ``d2`` (..., k) — among exact ties at window 0 — drawn
    as the argmax of Gumbel noise from ``generator`` (the reference draws
    ``jax.random.categorical`` over the same mask: the same
    distribution). Returns int32 labels."""
    if d2_min is None:
        d2_min = torch.min(d2, dim=-1).values
    mask = d2 <= (d2_min + window)[..., None]
    noise = gumbel(d2.shape, generator, d2.device).to(d2.dtype)
    return torch.argmax(
        torch.where(mask, noise, torch.full_like(noise, -torch.inf)),
        dim=-1).to(torch.int32)


def _row_shards(parts, X):
    """Per-shard row results (rows along the last dimension) as
    :class:`~sq_learn_tpu_torch.parallel.mesh.ShardedRows` over ``X``'s
    mesh and true row count."""
    return ShardedRows(parts, X.n, X.mesh, dim=-1)


def _cluster_partials(X, weights, labels, k):
    """Weighted per-cluster sums and counts via a one-hot product."""
    onehot = (labels[..., None] == torch.arange(k, device=X.device)).to(
        X.dtype) * weights[:, None]
    return onehot.transpose(-1, -2) @ X, torch.sum(onehot, dim=-2)


def relocate_empty_clusters(X, weights, labels, min_d2, sums, counts,
                            mesh=None):
    """Reassign empty clusters to the samples farthest from their assigned
    centers (reference ``_relocate_empty_clusters_dense``): the i-th empty
    cluster's partials become the i-th farthest sample, and the donor
    cluster's partial sums lose that sample. An exact no-op when nothing
    is empty. ``sums`` (R, k, m) / ``counts`` (R, k) may also come without
    the restart dimension.

    The farthest samples are ranked by a stable descending sort, whose
    ties go to the lowest index as ``lax.top_k``'s do (``torch.topk``
    documents no order on ties). The donor update is a one-hot product,
    so it is deterministic on the card. Zero-weight rows (padding) are
    never chosen.

    With ``mesh``, X and weights are sharded rows and labels and min_d2
    their per-shard results (:func:`e_step`'s); ``sums``/``counts`` are
    already summed. Each shard ranks its own rows, at most min(k, its row
    count) of them, the candidates are gathered in shard order and ranked
    again, stably: ties still go to the lowest global row, so the sharded
    relocation picks what the single-device one picks.
    """
    if sums.ndim == 2:
        out = relocate_empty_clusters(
            X, weights, _batched(labels), _batched(min_d2), sums[None],
            counts[None], mesh=mesh)
        return out[0][0], out[1][0]
    R, k, m = sums.shape
    if mesh is None:
        cand = _relocation_candidates(X, weights, labels, min_d2, k)
    else:
        parts = [_relocation_candidates(x, w, lab, md2, k) for x, w, lab, md2
                 in zip(X.shards, weights.shards, labels.shards,
                        min_d2.shards)]
        score, cand_X, cand_w, cand_l = (
            mesh.gather([p[j] for p in parts], dim=1) for j in range(4))
        kk = min(k, score.shape[1])
        order = torch.sort(score, dim=-1, descending=True,
                           stable=True).indices[:, :kk]
        cand = (None, torch.gather(cand_X, 1, order[..., None].expand(
            R, kk, m)), torch.gather(cand_w, 1, order),
            torch.gather(cand_l, 1, order))
    _, cand_X, cand_w, cand_l = cand
    kk = cand_w.shape[1]
    empty = counts <= 0
    rank = torch.cumsum(empty.to(torch.int64), dim=-1) - 1
    # an empty cluster beyond the candidate pool keeps its old center
    served = empty & (rank < kk)
    rank = torch.clamp(torch.where(served, rank, torch.zeros_like(rank)),
                       0, kk - 1)
    pt_X = torch.gather(cand_X, 1, rank[..., None].expand(R, k, m))
    pt_w = torch.where(served, torch.gather(cand_w, 1, rank),
                       torch.zeros_like(counts))
    pt_l = torch.gather(cand_l, 1, rank)
    donor = (pt_l[..., None] == torch.arange(k, device=sums.device)).to(
        sums.dtype)                                          # (R, src, dst)
    moved = pt_w[..., None] * pt_X
    sums = sums - donor.transpose(1, 2) @ moved
    counts = counts - torch.sum(donor * pt_w[..., None], dim=1)
    sums = torch.where(served[..., None], moved, sums)
    counts = torch.where(served, pt_w, counts)
    return sums, counts


def _batched(rows):
    """Per-row results with a leading restart dimension of 1 (sharded
    ones shard by shard)."""
    if isinstance(rows, torch.Tensor):
        return rows[None]
    return rows.map(lambda r: r[None])


def _relocation_candidates(X, weights, labels, min_d2, k):
    """(scores, rows, weights, labels) of the min(k, n) samples of X
    farthest from their centers, per restart: (R, kk) each, the rows
    (R, kk, m); zero-weight rows score −inf."""
    score = torch.where(weights > 0, min_d2,
                        torch.full_like(min_d2, -torch.inf))
    kk = min(k, score.shape[-1])
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    idx = idx[:, :kk]                                        # (R, kk)
    return (vals[:, :kk], X[idx], weights[idx],
            torch.gather(labels.to(torch.int64), 1, idx))


def m_step(generator, X, weights, labels, old_centers, *, delta=0.0,
           intermediate_error=False, true_tomography=True, min_d2=None):
    """Update step: weighted per-cluster means (reference
    ``_centers_update``, ``_dmeans.py:780-830``). With ``min_d2``, empty
    clusters are relocated to the farthest samples; a cluster still empty
    keeps its old center. With ``intermediate_error`` and δ > 0 the new
    centers go through tomography at δ/2 (:func:`center_tomography`)."""
    sums, counts = _cluster_partials(X, weights, labels, old_centers.shape[-2])
    if min_d2 is not None:
        sums, counts = relocate_empty_clusters(X, weights, labels, min_d2,
                                               sums, counts)
    centers = _update_centers(sums, counts, old_centers)
    if intermediate_error and delta > 0:
        centers = center_tomography(generator, centers, delta / 2,
                                    true_tomography=true_tomography)
    return centers


def center_tomography(generator, centers, noise, *, true_tomography=True):
    """Tomography of (k, m) centers or of a batch (R, k, m) at ``noise``
    (reference ``_dmeans.py:825-828``). True tomography (Algorithm 4.1)
    runs on all R·k rows in one batched call, each row estimated with
    36·m·ln m/noise² measurements and rescaled by its norm; the Gaussian
    route adds truncated noise of bound noise/√(k·m) per component, so
    each restart's centers move by at most ``noise`` in Frobenius norm,
    as the JAX package's per-restart call does."""
    if true_tomography:
        flat = centers.reshape(-1, centers.shape[-1])
        return real_tomography(generator, flat, delta=noise).reshape(
            centers.shape)
    flat = centers.reshape(*centers.shape[:-2], -1)
    return gaussian_estimate(generator, flat, noise).reshape(centers.shape)


def _update_centers(sums, counts, centers):
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))
    return torch.where((counts > 0)[..., None], sums / safe[..., None],
                       centers)


def _kernel_dtype(X, compute_dtype):
    """The dtype the fused Lloyd kernel reads X in, or None when the step
    runs as plain torch ops. The JAX package sends only float32 data with
    no reduced dtype, or with bfloat16, to its Pallas kernel; float16 and
    every other data dtype (float64 under ``default_dtype='float64'``)
    take its XLA path (``sq_learn_tpu/models/qkmeans.py:343-353``), which
    the port runs as plain torch ops — the JAX package's own routing, not
    a fallback."""
    if X.dtype != torch.float32:
        return None
    if not is_reduced(compute_dtype, X.dtype):
        return torch.float32
    if check_compute_dtype(compute_dtype) != "bfloat16":
        return None
    return torch.bfloat16


def lloyd_single(generator, X, weights, centers_init, x_sq_norms, *,
                 delta=0.0, mode="classic", max_iter=300, tol=1e-4,
                 patience=None, intermediate_error=False,
                 true_tomography=True, ipe_q=5, compute_dtype=None,
                 mesh=None):
    """Full q-means runs of a batch of restarts (reference
    ``_kmeans_single_lloyd``, ``_dmeans.py:534-671``).

    ``centers_init`` is (R, k, m). A restart runs while ``it < max_iter``
    and its last center shift exceeds ``tol`` (and, with ``patience``,
    while its best inertia improved within the last ``patience``
    iterations). The best (inertia, centers) pair is tracked — each
    inertia with the centers it was measured on — and at the end both the
    last and the best centers are re-evaluated by :func:`e_step`, the
    better one returned with consistent labels.

    The classic and δ modes run the fused kernel on float32 data (with no
    reduced ``compute_dtype``, or bfloat16); the ``ipe`` mode, float16
    and other data dtypes run :func:`e_step` and the one-hot partial sums
    in plain torch, launching no kernel, as the JAX package routes them
    off its Pallas kernel (:func:`_kernel_dtype`). With
    ``intermediate_error`` and δ > 0 every iteration's new centers go
    through :func:`center_tomography` at δ/2; a frozen restart's centers
    stay bit-equal.

    With ``mesh``, X, weights and x_sq_norms are :class:`~sq_learn_tpu_torch.
    parallel.mesh.ShardedRows` (padding rows of weight 0): each shard runs
    the step on its rows — the kernel per shard, on its device's stream —
    with Gumbel and IPE draws from a generator of its own
    (:meth:`Mesh.generators`, derived from ``generator``), the partial
    sums, counts and inertia are summed in shard order on the mesh's first
    device, where the centers, the stop rule and the tomography of the
    centers (from ``generator``) live, and the relocation ranks the
    shards' candidates together (:func:`relocate_empty_clusters`).

    Returns (labels (R, n), inertia (R,), centers (R, k, m), n_iter (R,),
    history) with history ``{"inertia", "center_shift"}`` (R, max_iter)
    traces, NaN beyond each restart's ``n_iter``; with ``mesh`` the labels
    are sharded (rows along their last dimension).
    """
    if mode not in LloydMode:
        raise ValueError(f"mode must be one of {LloydMode}, got {mode!r}")
    kernel_dtype = None if mode == "ipe" else _kernel_dtype(X, compute_dtype)
    estep = functools.partial(e_step, delta=delta, mode=mode, ipe_q=ipe_q,
                              compute_dtype=compute_dtype)
    window = float(delta) if mode == "delta" else 0.0
    if mesh is None:
        shards = [(X, weights, x_sq_norms)]
        gens = [generator]
        dev = X.device

        def reduce(parts):
            return parts[0]

        def spread(t):
            return [t]

        def rows_out(parts):
            return parts[0]
    else:
        shards = list(zip(X.shards, weights.shards, x_sq_norms.shards))
        gens = mesh.generators(generator)
        dev = mesh.lead
        reduce, spread = mesh.psum, mesh.broadcast

        def rows_out(parts):
            return _row_shards(parts, X)
    Xk = [None if kernel_dtype is None else x.to(kernel_dtype)
          for x, _, _ in shards]
    R, k, _ = centers_init.shape
    centers = centers_init.to(X.dtype)
    it = torch.zeros(R, dtype=torch.int64, device=dev)
    shift = torch.full((R,), torch.inf, dtype=X.dtype, device=dev)
    best_inertia = torch.full((R,), torch.inf, dtype=X.dtype, device=dev)
    best_centers = centers
    best_it = torch.zeros(R, dtype=torch.int64, device=dev)
    inertia_tr = torch.full((R, max_iter), torch.nan, dtype=X.dtype,
                            device=dev)
    shift_tr = inertia_tr.clone()
    tol = torch.as_tensor(tol, dtype=X.dtype, device=dev)
    slots = torch.arange(max_iter, device=dev)

    def running():
        keep = (it < max_iter) & (shift > tol)
        if patience is not None:
            keep = keep & (it - best_it <= patience)
        return keep

    def evaluate(c):
        """(labels per shard, inertia) of every shard's E-step at c."""
        outs = [estep(g, x, w, cs, xs) for (x, w, xs), g, cs
                in zip(shards, gens, spread(c))]
        return [o[0] for o in outs], reduce([o[1] for o in outs])

    def stopped():
        """The host's read of the stop rule: no restart runs."""
        with _obs.span("sync.qkmeans.stop_rule"):
            return not bool(active.any())

    active = running()
    # the read due before step s is made at the end of step s - 1, in that
    # step's span: each qkmeans.lloyd_iter span holds one Lloyd step
    step = 0
    with _obs.span("qkmeans.lloyd"):
        stop = max_iter == 0 or stopped()
        while not stop:
            with _obs.span("qkmeans.lloyd_iter"):
                outs = []
                for (x, w, xs), xk, g, cs, act in zip(shards, Xk, gens,
                                                       spread(centers),
                                                       spread(active)):
                    if xk is None:
                        with _obs.span("qkmeans.e_step"):
                            labels, inertia, min_d2 = estep(g, x, w, cs, xs)
                            sums, counts = _cluster_partials(x, w, labels,
                                                             k)
                    else:
                        noise = None
                        if window > 0:
                            with _obs.span("qkmeans.gumbel"):
                                noise = gumbel((R, x.shape[0], k), g,
                                               x.device)
                        labels, min_d2, sums, counts, inertia = lloyd_step(
                            xk, w, xs, cs, gumbel=noise, window=window,
                            active=act)
                    outs.append((labels, min_d2, sums, counts, inertia))
                sums, counts, inertia = (reduce([o[j] for o in outs])
                                         for j in (2, 3, 4))
                with _obs.span("qkmeans.relocate"):
                    sums, counts = relocate_empty_clusters(
                        X, weights, rows_out([o[0] for o in outs]),
                        rows_out([o[1] for o in outs]), sums, counts,
                        mesh=mesh)
                with _obs.span("qkmeans.update"):
                    new_centers = _update_centers(sums, counts, centers)
                    if intermediate_error and delta > 0:
                        new_centers = center_tomography(
                            generator, new_centers, delta / 2,
                            true_tomography=true_tomography)
                    better = active & (inertia < best_inertia)
                    best_it = torch.where(better, it, best_it)
                    best_inertia = torch.where(better, inertia, best_inertia)
                    best_centers = torch.where(better[:, None, None],
                                               centers, best_centers)
                    new_shift = torch.sum((new_centers - centers) ** 2,
                                          dim=(1, 2))
                    slot = active[:, None] & (slots == it[:, None])
                    inertia_tr = torch.where(slot, inertia[:, None],
                                             inertia_tr)
                    shift_tr = torch.where(slot, new_shift[:, None],
                                           shift_tr)
                    centers = torch.where(active[:, None, None], new_centers,
                                          centers)
                    shift = torch.where(active, new_shift, shift)
                    it = it + active.to(torch.int64)
                    active = running()
                step += 1
                stop = step == max_iter or (_stop_rule_read_due(step)
                                            and stopped())
    # the final post-update centers may beat every evaluated iterate
    # (classical convergence); re-evaluate both, return a consistent triple
    with _obs.span("qkmeans.finish"):
        labels_l, inertia_l = evaluate(centers)
        labels_b, inertia_b = evaluate(best_centers)
        last_wins = inertia_l < inertia_b
        labels = rows_out([torch.where(lw[:, None], a, b) for lw, a, b in
                           zip(spread(last_wins), labels_l, labels_b)])
        inertia = torch.where(last_wins, inertia_l, inertia_b)
        out_centers = torch.where(last_wins[:, None, None], centers,
                                  best_centers)
    history = {"inertia": inertia_tr, "center_shift": shift_tr}
    return labels, inertia, out_centers, it, history


def kmeans_plusplus(generator, X, x_sq_norms, n_clusters,
                    n_local_trials=None, weights=None):
    """k-means++ D²-sampling init of one restart (the JAX package's
    ``kmeans_plusplus``, reference ``_kmeans_plusplus``,
    ``_dmeans.py:153-245``): greedy best-of-trials candidate selection per
    new center, drawn from the torch ``generator``. Potentials are
    sample-weighted, so zero-weight (e.g. padding) rows are never
    selected. It is :func:`~sq_learn_tpu_torch.parallel.init.
    kmeans_plusplus_batched` at one restart; ``x_sq_norms`` None computes
    the row norms.

    Returns (centers (n_clusters, m), indices (n_clusters,) int64).
    """
    centers, indices = kmeans_plusplus_batched(
        generator, X, x_sq_norms, n_clusters, n_restarts=1,
        weights=weights, n_local_trials=n_local_trials)
    return centers[0], indices[0]


def _restart_inits(generator, X, weights, x_sq_norms, *, n_init, init,
                   n_clusters, init_subsample=0):
    """(n_init, k, m) initial-center stack: batched k-means++ (with the
    optional uniform row subsample), weight-proportional 'random' rows
    without replacement, or a callable's ``init(X, n_clusters,
    generator)`` per restart."""
    if isinstance(init, str) and init == "k-means++":
        centers0, _ = kmeans_plusplus_batched(
            generator, X, x_sq_norms, n_clusters, n_restarts=n_init,
            weights=weights, subsample=init_subsample)
        return centers0
    if isinstance(init, str) and init == "random":
        p = (weights / torch.sum(weights)).expand(n_init, -1)
        idx = torch.multinomial(p, n_clusters, replacement=False,
                                generator=generator)
        return X[idx]
    return torch.stack([_as_tensor_like(init(X, n_clusters, generator), X)
                        for _ in range(n_init)])


def _as_tensor_like(a, X):
    if isinstance(a, torch.Tensor):
        return a.to(X)
    return torch.as_tensor(np.asarray(a), dtype=X.dtype, device=X.device)


def lloyd_restarts_from(generator, X, weights, x_sq_norms, centers0, **kw):
    """All restarts of the Lloyd loop from an (R, k, m) center stack in
    one batch; the best restart is selected on the device by inertia.
    Keywords are those of :func:`lloyd_single`."""
    labels, inertia, centers, n_iter, history = lloyd_single(
        generator, X, weights, centers0, x_sq_norms, **kw)
    best = torch.argmin(inertia)
    # an index by a 0-d device tensor is read to the host, once per result
    with _obs.span("sync.qkmeans.best"):
        return (labels[best], inertia[best], centers[best], n_iter[best],
                {name: trace[best] for name, trace in history.items()})


def fused_init(generator, X, weights, *, n_init, init, n_clusters, quantum,
               mu_grid=(), init_subsample=0, sketch_idx=None, stats=None):
    """Step 1 of the fit: pre-fit statistics (:func:`fit_prestats`,
    sketched when ``sketch_idx`` holds sampled rows; ``stats`` passes
    those a streamed ingest already made, and then ``X`` is not read) and
    every restart's initial centers (:func:`_restart_inits`), in the
    centered space. An array ``init`` (a (k, m) tensor in the data's
    space) is centered and runs as the one restart."""
    if stats is None:
        with _obs.span("qkmeans.stats"):
            stats = fit_prestats(X, quantum=quantum, mu_grid=mu_grid,
                                 sketch_idx=sketch_idx)
    if isinstance(init, torch.Tensor):
        return stats, (init.to(stats["mean"]) - stats["mean"])[None]
    with _obs.span("qkmeans.seed"):
        centers0 = _restart_inits(generator, stats["Xc"], weights,
                                  stats["xsq"], n_init=n_init, init=init,
                                  n_clusters=n_clusters,
                                  init_subsample=init_subsample)
    return stats, centers0


def fused_fit(generator, stats, weights, centers0, tol_factor, *,
              delta=0.0, mode="classic", max_iter=300, patience=None,
              intermediate_error=False, true_tomography=True, ipe_q=5,
              compute_dtype=None):
    """Step 2 of the fit: the tolerance scale (reference ``_tolerance``),
    all restarts' Lloyd loops (:func:`lloyd_restarts_from`) and the
    winner moved back to the data's space. Returns a dict of device
    tensors (the sketched components under ``"sketch"``); the caller
    fetches it once."""
    tol = (tol_factor * stats["var_mean"] if tol_factor > 0
           else torch.zeros_like(stats["var_mean"]))
    labels, inertia, centers, n_iter, history = lloyd_restarts_from(
        generator, stats["Xc"], weights, stats["xsq"], centers0,
        delta=delta, mode=mode, max_iter=max_iter, tol=tol,
        patience=patience, intermediate_error=intermediate_error,
        true_tomography=true_tomography, ipe_q=ipe_q,
        compute_dtype=compute_dtype)
    out = {"labels": labels, "inertia": inertia,
           "centers": centers + stats["mean"], "n_iter": n_iter,
           "inertia_trace": history["inertia"],
           "shift_trace": history["center_shift"]}
    for name in ("eta", "frob", "sigma_min", "mu_vals", "sketch"):
        if name in stats:
            out[name] = stats[name]
    return out


# ---------------------------------------------------------------------------
# Estimator facade
# ---------------------------------------------------------------------------


class QKMeans(TransformerMixin, ClusterMixin, BaseEstimator):
    """q-means clustering estimator (reference ``qMeans_``,
    ``_dmeans.py:833-1410``).

    Parameters mirror the JAX ``QKMeans``; ``delta`` is the quantum error
    budget (δ=0 runs classical Lloyd). δ>0 runs q-means with the IPE
    E-step (``true_distance_estimate=True``, the default) or δ-means
    (False); ``intermediate_error`` adds tomography of the centers at δ/2
    each iteration (``true_tomography`` picks Algorithm 4.1 over its
    Gaussian stand-in). ``use_pallas`` is
    gone: the device of the data decides, and ``device`` (None = the
    configured one, ``'cuda'`` by default) says where a fit computes.
    ``multiprocess``, ``stop_when_reached_accuracy`` and ``copy_x`` are
    accepted for API compatibility and ignored, as in the reference port.

    ``patience`` ('auto' | None | int) stops a run once the best inertia
    has not improved for that many iterations ('auto' = 10 on noisy fits,
    disabled on classical ones). After ``fit``, ``fit_history_`` holds the
    winning restart's per-iteration traces, and with δ>0 the runtime-model
    statistics land in ``eta_``, ``mu_``, ``norm_mu_``,
    ``condition_number_`` and ``sketch_info_`` (``sketch`` as in the JAX
    package: 'auto' samples 4096 rows from 16 384 tall rows up).
    """

    def __init__(self, n_clusters=8, *, init="k-means++", n_init=10,
                 max_iter=300, tol=1e-4, patience="auto", verbose=0,
                 random_state=None, copy_x=True, algorithm="auto", delta=None,
                 intermediate_error=False, true_tomography=True,
                 stop_when_reached_accuracy=True, multiprocess=False,
                 true_distance_estimate=True, ipe_q=5, mesh=None,
                 compute_dtype=None, init_subsample="auto", sketch="auto",
                 device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.patience = patience
        self.verbose = verbose
        self.random_state = random_state
        self.copy_x = copy_x
        self.algorithm = algorithm
        self.delta = delta
        self.intermediate_error = intermediate_error
        self.true_tomography = true_tomography
        self.stop_when_reached_accuracy = stop_when_reached_accuracy
        self.multiprocess = multiprocess
        self.true_distance_estimate = true_distance_estimate
        self.ipe_q = ipe_q
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.init_subsample = init_subsample
        self.sketch = sketch
        self.device = device

    # -- validation ---------------------------------------------------------

    def _check_params(self, X):
        if not (self.n_init == "auto"
                or (isinstance(self.n_init, numbers.Integral)
                    and self.n_init > 0)):
            raise ValueError(
                f"n_init should be 'auto' or > 0, got {self.n_init} instead.")
        if self.max_iter <= 0:
            raise ValueError(
                f"max_iter should be > 0, got {self.max_iter} instead.")
        if X.shape[0] < self.n_clusters:
            raise ValueError(
                f"n_samples={X.shape[0]} should be >= n_clusters="
                f"{self.n_clusters}.")
        if self.algorithm not in ("auto", "full", "lloyd", "elkan"):
            raise ValueError(
                f"Algorithm must be 'auto', 'full', 'lloyd' or 'elkan', got "
                f"{self.algorithm} instead.")
        if not (isinstance(self.init, str)
                and self.init in ("k-means++", "random")
                or hasattr(self.init, "__array__") or callable(self.init)):
            raise ValueError(
                f"init should be either 'k-means++', 'random', an array or a "
                f"callable, got '{self.init}' instead.")

    def _mode(self, delta):
        if delta == 0:
            return "classic"
        return "ipe" if self.true_distance_estimate else "delta"

    def _check_ported(self, dtype, mode):
        """Check ``mesh``, and warn where a setting does not engage."""
        check_mesh(self.mesh)
        if self.algorithm == "elkan":
            if mode == "classic" and self.mesh is not None:
                warnings.warn(
                    "algorithm='elkan' runs on the single-host native path; "
                    "with a mesh the Lloyd kernel is used.", RuntimeWarning)
            elif mode == "classic":
                # the JAX package's accelerator resolution; its pruned
                # Elkan engine is a native host engine, not ported
                warnings.warn(
                    "algorithm='elkan' prunes with data-dependent "
                    "branching, so the port runs the fused Lloyd kernel "
                    "(sklearn's elkan ≡ lloyd contract: the same labels).",
                    RuntimeWarning)
            else:
                warnings.warn(
                    "algorithm='elkan' applies to the classical (delta=0) "
                    "path only: the δ-window error model needs the full "
                    "distance row per sample. Using the Lloyd kernel.",
                    RuntimeWarning)
        cd = self._checked_compute_dtype()
        if mode == "ipe" and is_reduced(cd, dtype):
            warnings.warn(
                "compute_dtype with true_distance_estimate (IPE mode) feeds "
                "reduced-precision inner products into the quantum noise "
                "model — an unmodeled O(eps·‖x‖‖c‖) error on top of δ/2.",
                RuntimeWarning)

    def _resolved_n_init(self, init):
        """Array inits run once (sklearn's contract); 'auto' is 1 for
        k-means++ and 10 for 'random' (sklearn 1.4)."""
        if hasattr(init, "__array__") and not callable(init):
            return 1
        if self.n_init != "auto":
            return int(self.n_init)
        return 1 if (isinstance(init, str) and init == "k-means++") else 10

    def _resolved_patience(self, mode):
        """'auto' enables the best-inertia plateau rule only where the
        classical shift≤tol rule cannot fire (noisy fits), with sklearn's
        ``max_no_improvement=10`` convention."""
        if self.patience == "auto":
            noisy = mode != "classic" or self.intermediate_error
            return 10 if noisy else None
        if self.patience is None:
            return None
        return int(self.patience)

    def _checked_compute_dtype(self):
        return check_compute_dtype(self.compute_dtype)

    def _centers_tensor(self, X):
        return torch.as_tensor(np.asarray(self.cluster_centers_),
                               dtype=X.dtype, device=X.device)

    # -- fitting ------------------------------------------------------------

    def fit(self, X, y=None, sample_weight=None):
        """Compute q-means clustering (reference ``qMeans_.fit``,
        ``_dmeans.py:1211-1325``) on the estimator's device."""
        device = self._fit_device()
        # host input above the tile cap streams (the JAX package's staged
        # route, streamed_prestats): it is checked on the host, assembled
        # on the card tile by tile and its values checked there
        Xh, over_cap = host_ingest(X)
        streamed = over_cap and self.mesh is None
        self.ingest_ = "streamed" if streamed else "monolithic"
        X = Xh if streamed else self._validated_X(X, device)
        self.n_features_in_ = X.shape[1]
        self._check_params(X)
        with _obs.span("qkmeans.fit") as sp:
            seed, centers = self._fit_impl(X, sample_weight, device)
            if _obs.enabled():
                sp.set(n_samples=X.shape[0], n_features=X.shape[1],
                       n_clusters=self.n_clusters, backend=device.type,
                       ingest=self.ingest_, n_iter=self.n_iter_)
        self._ledger_fit_entry(X)
        self._audit_fit_entry(X, seed, centers)
        return self

    def _fit_device(self):
        """Where a fit computes: the mesh's first device under a mesh,
        else the estimator's device."""
        if self.mesh is not None:
            check_mesh(self.mesh)
            return resolve_device(self.mesh.lead)
        return resolve_device(self.device)

    def _fit_impl(self, X, sample_weight, device):
        """The fit body proper; returns the seed of the fit's generator and
        the fitted centers as the device tensor they were fetched from.
        ``X`` is a tensor on ``device``, or host data on the streamed
        route."""
        delta = 0.0 if self.delta is None else float(self.delta)
        if delta == 0:
            warnings.warn("Attention! You are running the classic version of "
                          "k-means (delta=0).")
            if self.intermediate_error:
                raise ValueError(
                    "intermediate_error cannot be True if delta is zero.")
        mode = self._mode(delta)
        dtype = (X.dtype if isinstance(X, torch.Tensor)
                 else torch.from_numpy(X[:0]).dtype)
        self._check_ported(dtype, mode)
        init = self.init
        if hasattr(init, "__array__") and not callable(init):
            if self.n_init != "auto" and int(self.n_init) > 1:
                warnings.warn(
                    "Explicit initial center position passed: performing "
                    "only one init of the restart loop.", RuntimeWarning)
            init = torch.as_tensor(np.asarray(init), dtype=dtype,
                                   device=device)
            if init.shape != (self.n_clusters, X.shape[1]):
                raise ValueError(
                    f"The shape of the initial centers {tuple(init.shape)} "
                    f"does not match (n_clusters={self.n_clusters}, "
                    f"n_features={X.shape[1]}).")
        quantum = delta > 0
        sub = 0
        if isinstance(init, str) and init == "k-means++":
            sub = resolve_init_subsample(X.shape[0], self.n_clusters,
                                         self.init_subsample)
        generator = as_generator(self.random_state, device)
        seed = generator.initial_seed()
        delta_stat = sketch_delta_stat()
        # the mesh route keeps the exact statistics, as the JAX package's
        rows = (resolve_sketch_rows(*X.shape, self.sketch)
                if quantum and delta_stat > 0 and self.mesh is None else 0)
        sk_idx = None
        if rows:
            # the row sample's own generator, seeded apart from the fit's
            # (the JAX package folds the same constant into its key)
            rng_sk = np.random.default_rng([seed, SKETCH_SEED])
            idx = sample_indices(rng_sk, X.shape[0], rows)
            # an upload from pageable memory waits for the device
            with _obs.span("sync.qkmeans.sketch_rows"):
                sk_idx = torch.as_tensor(idx, device=device)
        n_init = self._resolved_n_init(self.init)
        mu_grid = MU_GRID if quantum else ()
        stats = None
        if self.ingest_ == "streamed":
            # a tripped breaker gets its half-open probe first, and raises
            # if it stays open; the sketch rides the resident buffer
            from ..resilience import breaker

            breaker.preflight("qkmeans.fit", device)
            stats = streamed_prestats(X, quantum=quantum, mu_grid=mu_grid,
                                      sketch_idx=sk_idx, device=device,
                                      validate=True)
        w = check_sample_weight(sample_weight,
                                X if stats is None else stats["Xc"])
        # the JAX package runs both steps under jit: nothing inside them
        # records a guarantee draw
        with _obs.guarantees.no_audit():
            if self.mesh is not None:
                out = self._fit_sharded(generator, X, w, init, n_init=n_init,
                                        quantum=quantum, mu_grid=mu_grid,
                                        delta=delta, mode=mode)
                sketch = None
                host = {name: t.cpu().numpy() for name, t in out.items()}
            else:
                with _obs.span("qkmeans.fused_init") as sp:
                    if _obs.enabled():
                        sp.set(n_init=n_init, subsample=sub or None)
                    stats, centers0 = fused_init(
                        generator, X, w, n_init=n_init, init=init,
                        n_clusters=self.n_clusters, quantum=quantum,
                        mu_grid=mu_grid, init_subsample=sub,
                        sketch_idx=sk_idx, stats=stats)
                with _obs.span("qkmeans.fused_fit") as sp:
                    if _obs.enabled():
                        sp.set(mode=mode)
                    out = fused_fit(
                        generator, stats, w, centers0, float(self.tol),
                        delta=delta, mode=mode, max_iter=self.max_iter,
                        patience=self._resolved_patience(mode),
                        intermediate_error=self.intermediate_error,
                        true_tomography=self.true_tomography, ipe_q=self.ipe_q,
                        compute_dtype=self._checked_compute_dtype())
                    # the fit's fetch, after every step was queued
                    sketch = out.pop("sketch", None)
                    with _obs.span("sync.qkmeans.fetch"):
                        host = {name: t.cpu().numpy()
                                for name, t in out.items()}
        n_iter = int(host["n_iter"])
        self._set_fit_results(host["labels"].astype(np.int32),
                              host["centers"].astype(np.float32),
                              float(host["inertia"]), n_iter,
                              host["inertia_trace"], host["shift_trace"])
        if quantum:
            with _obs.span("qkmeans.quantum_stats") as sp:
                if _obs.enabled():
                    sp.set(sketched=bool(rows), rows=rows or None)
                if sketch is not None:
                    with _obs.span("sync.qkmeans.quantum_stats"):
                        comp = fetch_components(sketch)
                    sstats = finalize_components(
                        comp, n=X.shape[0],
                        m=X.shape[1], s=rows, mu_grid=MU_GRID,
                        delta_stat=delta_stat)
                    record_sketch_obs(sstats)
                    audit_sketch(sstats, _on_device(X, device))
                else:
                    sstats = exact_bundle(
                        MU_GRID, host["eta"], host["frob"],
                        host["sigma_min"], host["mu_vals"],
                        shape=tuple(X.shape))
                    if _obs.guarantees.enabled():
                        # exact statistics: the zero-budget short-circuit
                        _obs.guarantees.record_guarantee(
                            "sketch.stats", 0.0, 0.0, fail_prob=0.0,
                            short_circuit=True, estimator="qkmeans")
                self._apply_spectral_stats(sstats)
        if self.verbose:
            for i, v in enumerate(self.inertia_history_):
                print(f"Iteration {i}, inertia {v:.3f}.")
            print(f"init done, inertia {self.inertia_:.3f}")
        return seed, out["centers"]

    def _fit_sharded(self, generator, X, w, init, *, n_init, quantum,
                     mu_grid, delta, mode):
        """The mesh route (the JAX package's restart loop over
        ``lloyd_single_sharded``): the statistics on the mesh's first
        device, every restart's start centers (k-means++ from the sharded
        init), the centered rows sharded once, then each restart's Lloyd
        run over the mesh, the lowest inertia kept (the first on a tie).
        Returns the device results :meth:`_fit_impl` fetches."""
        mesh = self.mesh
        stats = fit_prestats(X, quantum=quantum, mu_grid=mu_grid)
        Xc, xsq = stats["Xc"], stats["xsq"]
        with _obs.span("qkmeans.init", sharded=True, n_init=n_init) as sp:
            if isinstance(init, torch.Tensor):
                centers0 = (init.to(stats["mean"]) - stats["mean"])[None]
            elif isinstance(init, str) and init == "k-means++":
                centers0, _ = kmeans_plusplus_sharded(
                    mesh, generator, Xc, xsq, self.n_clusters,
                    n_restarts=n_init, weights=w)
            else:
                centers0 = _restart_inits(
                    generator, Xc, w, xsq, n_init=n_init, init=init,
                    n_clusters=self.n_clusters)
            sp.sync(centers0)
        tol = (float(self.tol) * stats["var_mean"] if self.tol > 0
               else torch.zeros_like(stats["var_mean"]))
        sharded = shard_rows(mesh, *(pad_to_multiple(a, mesh.size)[0]
                                     for a in (Xc, w, xsq)), n=X.shape[0])
        best = None
        for centers in centers0:
            run = lloyd_single_sharded(
                mesh, generator, sharded[0], sharded[1], centers,
                sharded[2], delta=delta, mode=mode, max_iter=self.max_iter,
                tol=tol, patience=self._resolved_patience(mode),
                intermediate_error=self.intermediate_error,
                true_tomography=self.true_tomography, ipe_q=self.ipe_q,
                compute_dtype=self._checked_compute_dtype())
            if best is None or float(run[1]) < float(best[1]):
                best = run
        labels, inertia, centers, n_iter, history = best
        out = {"labels": labels.to_tensor(), "inertia": inertia,
               "centers": centers + stats["mean"], "n_iter": n_iter,
               "inertia_trace": history["inertia"],
               "shift_trace": history["center_shift"]}
        for name in ("eta", "frob", "sigma_min", "mu_vals"):
            if name in stats:
                out[name] = stats[name]
        return out

    def _ledger_fit_entry(self, X):
        """Feed the quantum-runtime ledger after a fit: the theoretical
        q-means cost model (reference ``_dmeans.py:1440-1449``) at this
        fit's shape. δ=0 is the classical short-circuit — zero quantum
        queries by contract."""
        if not _obs.enabled():
            return
        delta = 0.0 if self.delta is None else float(self.delta)
        if delta == 0.0:
            _obs.ledger.record("qkmeans", "fit", queries={},
                               budget={"delta": delta}, short_circuit=True)
            return
        quantum, classical = self.quantum_runtime_model(*X.shape)
        _obs.ledger.record(
            "qkmeans", "fit",
            queries={"theoretical_quantum_cost": float(quantum.ravel()[0]),
                     "classical_cost": float(classical)},
            budget={"delta": delta},
            mode=self._mode(delta), ipe_q=self.ipe_q, n_iter=self.n_iter_)

    def _audit_fit_entry(self, X, seed, centers):
        """Feed the guarantee auditor after a fit: replay the fit's error
        model on ≤ 256 evenly strided rows against the fitted ``centers``
        (the device tensor ``cluster_centers_`` was fetched from), with a
        generator of its own seeded with ``seed`` (the fit's), so the
        fit's own draws never move:

        - ``delta`` mode: a fresh δ-window pick per row; realized error =
          d²(x, chosen) − d²(x, nearest), within δ by construction
          (``fail_prob`` 0 — a violation means the window rule broke).
        - ``ipe`` mode: :func:`inner_product_estimates` at the fit's
          ε = δ/2 and Q, which records its draws at the ``ipe`` site.
        - δ = 0: the classical short-circuit, one zero-violation record.

        Everything runs on the fit's device; only the sampled draws reach
        the host."""
        if not _obs.guarantees.enabled():
            return
        delta = 0.0 if self.delta is None else float(self.delta)
        if delta == 0.0:
            _obs.guarantees.record_guarantee(
                "qkmeans.delta_window", 0.0, 0.0, fail_prob=0.0,
                short_circuit=True, estimator="qkmeans")
            return
        stride = max(1, X.shape[0] // 256)
        C = centers
        Xs = X[::stride][:256]
        if not isinstance(Xs, torch.Tensor):
            Xs = torch.from_numpy(np.ascontiguousarray(Xs)).to(C.device)
        gen = as_generator(seed, C.device)
        if self._mode(delta) == "ipe":
            inner_product_estimates(gen, Xs.to(torch.float32),
                                    C.to(torch.float32), epsilon=delta / 2,
                                    Q=self.ipe_q)
            return
        Xs, C = Xs.to(torch.float64), C.to(torch.float64)
        d2 = (torch.sum(Xs**2, dim=1)[:, None] + torch.sum(C**2, dim=1)
              - 2.0 * Xs @ C.T)
        d2min = torch.min(d2, dim=1).values
        picks = pick_labels(gen, d2, delta, d2min).to(torch.int64)
        realized = torch.gather(d2, 1, picks[:, None])[:, 0] - d2min
        _obs.guarantees.observe(
            "qkmeans.delta_window", torch.clamp(realized, min=0.0), delta,
            fail_prob=0.0, estimator="qkmeans", n_clusters=C.shape[0])

    def _set_fit_results(self, labels, centers, inertia, n_iter, inertia_tr,
                         shift_tr):
        """Set the fitted attributes from host arrays (traces trimmed to
        the iterations that ran)."""
        distinct = len(np.unique(labels))
        if distinct < self.n_clusters:
            warnings.warn(
                f"Number of distinct clusters ({distinct}) found smaller than "
                f"n_clusters ({self.n_clusters}). Possibly due to duplicate "
                f"points in X.")
        self.cluster_centers_ = centers
        self.labels_ = labels
        self.inertia_ = inertia
        self.n_iter_ = n_iter
        self.inertia_history_ = np.asarray(inertia_tr)[:n_iter]
        self.center_shift_history_ = np.asarray(shift_tr)[:n_iter]
        return self

    def _apply_spectral_stats(self, stats):
        """Fold a :class:`~sq_learn_tpu_torch.sketch.engine.SpectralStats`
        bundle into the runtime-model attributes (conservative μ and κ)."""
        self.eta_ = float(stats.eta)
        self.norm_mu_, self.mu_ = stats.conservative_mu()
        self.condition_number_ = float(stats.condition_number())
        self.sketch_info_ = stats.info()

    @property
    def fit_history_(self):
        """Dict view of the per-iteration traces of the winning restart."""
        check_is_fitted(self, "inertia_history_")
        return {"inertia": self.inertia_history_,
                "center_shift": self.center_shift_history_}

    # -- inference ----------------------------------------------------------

    def _inference_input(self, X):
        check_is_fitted(self, "cluster_centers_")
        return check_n_features(
            self, self._validated_X(X, resolve_device(self.device)))

    def predict(self, X, sample_weight=None, delta=None):
        """Closest-center assignment, with optional quantum error δ: the
        δ-means pick or, with ``true_distance_estimate``, the IPE E-step
        (reference intent, JAX ``_predict_impl``)."""
        check_is_fitted(self, "cluster_centers_")
        device = resolve_device(self.device)
        Xh, over_cap = host_ingest(X)
        delta = 0.0 if delta is None else float(delta)
        kw = dict(delta=delta, mode=self._mode(delta), ipe_q=self.ipe_q,
                  compute_dtype=self._checked_compute_dtype())
        if over_cap:
            return self._predict_streamed(check_n_features(self, Xh),
                                          device, kw)
        X = self._inference_input(X)
        # the JAX package's E-step runs under jit: no guarantee draws
        with _obs.span("qkmeans.predict", n_queries=X.shape[0],
                       delta=delta), _obs.guarantees.no_audit():
            labels, _, _ = e_step(
                as_generator(self.random_state, X.device), X,
                torch.ones(X.shape[0], dtype=X.dtype, device=X.device),
                self._centers_tensor(X), row_norms(X, squared=True), **kw)
            return labels.cpu().numpy()

    def _predict_streamed(self, Xh, device, kw):
        """The streamed predict (JAX ``predict_tile``): the query rows walk
        in bounded tiles, the next upload under the current tile's norms
        and E-step; only the labels stay, and come back once. A noisy mode
        draws each tile's noise from a generator seeded from the fit's
        ``random_state`` and the tile's first row, as the JAX package folds
        the offset into its key; the classic argmin draws nothing."""
        base = as_generator(self.random_state, device).initial_seed()
        centers = torch.as_tensor(np.asarray(self.cluster_centers_),
                                  dtype=torch.from_numpy(Xh[:0]).dtype,
                                  device=device)

        def tile_fn(tile, start):
            seed = np.random.SeedSequence([base, start]).generate_state(
                2, np.uint32)
            gen = as_generator(int(seed[0]) << 31 | int(seed[1]) >> 1,
                               device)
            labels, _, _ = e_step(
                gen, tile, torch.ones(tile.shape[0], dtype=tile.dtype,
                                      device=device),
                centers, row_norms(tile, squared=True), **kw)
            return labels

        with _obs.span("qkmeans.predict", n_queries=Xh.shape[0],
                       delta=kw["delta"], ingest="streamed"), \
                _obs.guarantees.no_audit():
            return stream_map_rows(Xh, tile_fn, device=device,
                                   with_offsets=True,
                                   validate=True).cpu().numpy()

    def transform(self, X):
        """Distances to the cluster centers (purely classical, as the
        reference warns at ``_dmeans.py:1341-1347``)."""
        from ..metrics import euclidean_distances

        X = self._inference_input(X)
        return euclidean_distances(X, self._centers_tensor(X)).cpu().numpy()

    def fit_transform(self, X, y=None, sample_weight=None):
        with validation_scope(self):
            return self.fit(X, sample_weight=sample_weight).transform(X)

    def score(self, X, y=None, sample_weight=None):
        """Negative inertia of X under the fitted centers."""
        X = self._inference_input(X)
        w = check_sample_weight(sample_weight, X)
        d2 = pairwise_sq_distances(X, self._centers_tensor(X))
        return -float(torch.sum(torch.min(d2, dim=1).values * w))

    # -- theoretical runtime (reference runtime_comparison,
    #    _dmeans.py:1412-1469) ----------------------------------------------

    def quantum_runtime_model(self, n_samples, n_features,
                              well_clusterable=False):
        """Closed-form theoretical q-means cost (reference
        ``_dmeans.py:1440-1449``): O(k·m·η·κ·(μ+kη/δ)/δ² +
        k²·η^1.5·κ·μ/δ²), or the well-clusterable variant without the κ·μ
        coupling; returns (quantum, classical) cost arrays broadcast over
        ``n_samples`` (FLOP-equivalents, not wall clock). Host numpy on
        the fitted statistics."""
        check_is_fitted(self, "cluster_centers_")
        delta = 0.0 if self.delta is None else float(self.delta)
        if delta == 0:
            raise ValueError("quantum runtime model requires delta > 0")
        k = self.n_clusters
        eta, kappa, mu = self.eta_, self.condition_number_, self.mu_
        n_samples = np.asarray(n_samples, dtype=float)
        n_features = np.asarray(n_features, dtype=float)
        if well_clusterable:
            quantum = (k**2 * n_features * eta**2.5 / delta**3
                       + k**2.5 * eta**2 / delta**3)
        else:
            quantum = (k * n_features * eta * kappa * (mu + k * eta / delta)
                       / delta**2
                       + k**2 * eta**1.5 * kappa * mu / delta**2)
        classical = (n_samples * n_features * k
                     * self._resolved_n_init(self.init))
        return np.broadcast_to(quantum, n_samples.shape), classical

    def runtime_comparison(self, n_samples, n_features, saveas=None,
                           well_clusterable=False, plot=False):
        """Quantum-vs-classical cost surfaces over the reference's 100×100
        int64 mesh up to (``n_samples``, ``n_features``)
        (``_dmeans.py:1437-1438``); returns (quantum, classical). A
        non-None ``saveas`` renders the 3-D comparison with matplotlib,
        imported only then."""
        nn, mm = np.meshgrid(
            np.linspace(0, n_samples, dtype=np.int64, num=100),
            np.linspace(0, n_features, dtype=np.int64, num=100))
        quantum, classical = self.quantum_runtime_model(
            nn, mm, well_clusterable=well_clusterable)
        if saveas:
            plot_runtime_surfaces(nn, mm, quantum, classical, saveas,
                                  title="k_means VS q_means")
        return quantum, classical



def k_means(X, n_clusters, *, sample_weight=None, init="k-means++",
            n_init=10, max_iter=300, tol=1e-4, random_state=None,
            delta=None, true_distance_estimate=True, ipe_q=5,
            verbose=0, return_n_iter=False, device=None):
    """Functional q-means (reference module-level ``k_means``): fit once,
    return (centers, labels, inertia) — plus n_iter with
    ``return_n_iter``."""
    est = QKMeans(
        n_clusters=n_clusters, init=init, n_init=n_init, max_iter=max_iter,
        tol=tol, verbose=verbose, random_state=random_state, delta=delta,
        true_distance_estimate=true_distance_estimate, ipe_q=ipe_q,
        device=device)
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="Attention! You are running the classic")
        est.fit(X, sample_weight=sample_weight)
    if return_n_iter:
        return est.cluster_centers_, est.labels_, est.inertia_, est.n_iter_
    return est.cluster_centers_, est.labels_, est.inertia_


class KMeans(QKMeans):
    """Classical k-means: the δ=0 path of :class:`QKMeans`."""

    def __init__(self, n_clusters=8, *, init="k-means++", n_init=10,
                 max_iter=300, tol=1e-4, verbose=0, random_state=None,
                 copy_x=True, algorithm="auto", mesh=None, device=None):
        super().__init__(
            n_clusters=n_clusters, init=init, n_init=n_init,
            max_iter=max_iter, tol=tol, verbose=verbose,
            random_state=random_state, copy_x=copy_x, algorithm=algorithm,
            delta=None, mesh=mesh, device=device)

    def fit(self, X, y=None, sample_weight=None):
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Attention! You are running the classic")
            return super().fit(X, sample_weight=sample_weight)
