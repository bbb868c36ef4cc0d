"""Data-parallel tall-skinny SVD for qPCA over a mesh (counterpart of
``sq_learn_tpu/parallel/pca.py``).

The sample axis is split over the mesh, each shard forms its partial
column sums and its partial m×m Gram with ``torch.matmul`` (the JAX
package computes them outside any Pallas kernel), the partials are summed
in shard order on the mesh's first device, and the Gram is decomposed
there by ``eigh`` in float64, as the single-device route does
(:func:`~sq_learn_tpu_torch.ops.linalg.gram_spectrum`). Signs come from V
(:func:`~sq_learn_tpu_torch.ops.linalg.svd_flip_v`). The left factor
U = Xc·V/σ stays row-sharded; callers gather only the columns they keep.
"""

import math

import torch

from .. import obs as _obs
from ..ops.linalg import gram_spectrum, svd_flip_v
from ..ops.quantum.norms import (_combine, _grid_exponents, _power_sweep,
                                 _search_grid, select_mu)
from .mesh import ShardedRows, _as_tensor, pad_and_shard

__all__ = [
    "best_mu_sharded",
    "centered_sharded",
    "centered_svd_sharded",
    "tomography_sharded",
    "uncentered_svd_sharded",
]


def _masked_gram_svd(mesh, X, w, n, center):
    """Gram-route thin SVD of the rows of the sharded ``X`` that carry
    weight ``w`` 1 (padding carries 0), optionally centered; ``n`` is the
    true row count. ``center=False`` is the TruncatedSVD contract: the raw
    matrix, no mean subtraction. Returns (mean, U sharded, S, Vt)."""
    m = X.shards[0].shape[1]
    if center:
        mean = mesh.psum([torch.sum(x * wt[:, None], dim=0)
                          for x, wt in zip(X.shards, w.shards)]) / n
    else:
        mean = torch.zeros(m, dtype=X.dtype, device=mesh.lead)
    Xc = ShardedRows([(x - mu) * wt[:, None] for x, wt, mu
                      in zip(X.shards, w.shards, mesh.broadcast(mean))],
                     n, mesh)
    G = mesh.psum([x.T @ x for x in Xc.shards])              # (m, m)
    S, V, safe = gram_spectrum(G)
    # the thin spectrum: only min(n, m) eigenvalues can be nonzero
    r = min(n, m)
    S, V, safe = S[:r], V[:, :r], safe[:r]
    _, Vt = svd_flip_v(None, V.T)
    U = ShardedRows([(x @ vt.T) / sf[None, :] for x, vt, sf
                     in zip(Xc.shards, mesh.broadcast(Vt),
                            mesh.broadcast(safe))], n, mesh)
    return mean, U, S, Vt


def centered_svd_sharded(mesh, X):
    """Column-center X and return (mean, U, S, Vt) with V-based signs,
    computed data-parallel over ``mesh``. Matches
    :func:`~sq_learn_tpu_torch.ops.linalg.centered_svd` (method 'gram')
    on the same input; U is row-sharded, its true rows the first n."""
    with _obs.span("parallel.pca.centered_svd_sharded",
                   n_devices=mesh.size) as sp:
        Xs, mask, n = pad_and_shard(mesh, X)
        mean, U, S, Vt = _masked_gram_svd(mesh, Xs, mask, n, center=True)
        sp.sync(S)
    return mean, U, S, Vt


def uncentered_svd_sharded(mesh, X):
    """Thin SVD of X without centering, data-parallel over ``mesh`` — the
    sharded engine of ``TruncatedSVD(mesh=...)``. Matches the
    single-device exact route (``thin_svd`` + ``svd_flip_v``) up to the
    Gram route's conditioning; U is row-sharded."""
    with _obs.span("parallel.pca.uncentered_svd_sharded",
                   n_devices=mesh.size) as sp:
        Xs, mask, n = pad_and_shard(mesh, X)
        _, U, S, Vt = _masked_gram_svd(mesh, Xs, mask, n, center=False)
        sp.sync(S)
    return U, S, Vt


def tomography_sharded(mesh, generator, A, noise, true_tomography=True,
                       norm="L2"):
    """Row-sharded tomography of a matrix — the quantum-transform side of
    qPCA (reference ``compute_quantum_representation``,
    ``_qPCA.py:773-880``): each shard draws the estimates of its own rows
    from a generator of its own (:meth:`Mesh.generators`, derived from
    ``generator``), so the projected matrix is never gathered to draw
    them. True tomography estimates each row (a padding row is given a
    unit basis vector and its estimate masked back to zero); the Gaussian
    route adds truncated noise of bound noise/√(n·d) per component of
    the true rows, so ‖Â − A‖_F ≤ noise as on one device. Statistically the
    single-device :func:`~sq_learn_tpu_torch.ops.quantum.tomography`.
    Returns the estimates as sharded rows (the input itself, sharded, at
    noise 0)."""
    from ..ops.quantum.noise import truncated_noise
    from ..ops.quantum.tomography import (real_tomography,
                                          tomography_n_measurements)

    As, mask, n = pad_and_shard(mesh, A)
    if float(noise) == 0.0:
        return As
    d = As.shards[0].shape[1]
    gens = mesh.generators(generator)
    if true_tomography:
        N = tomography_n_measurements(d, noise, norm)
        e0 = torch.zeros(d, dtype=As.dtype)
        e0[0] = 1.0

        def draw(a, m, g):
            safe = a + (1.0 - m)[:, None] * e0.to(a.device)
            return real_tomography(g, safe, N=N, norm=norm) * m[:, None]
    else:
        bound = float(noise) / math.sqrt(n * d)

        def draw(a, m, g):
            return (a + truncated_noise(g, bound, a.shape, a.dtype)
                    * m[:, None])
    return ShardedRows([draw(a, m, g) for a, m, g in
                        zip(As.shards, mask.shards, gens)], n, mesh)


def centered_sharded(mesh, X, mean):
    """Row-sharded centered copy of X with padding rows exactly zero — for
    reductions that must see the centered matrix (the μ(A) grid): zero
    rows add nothing to its power sums or its Frobenius norm."""
    Xs, mask, _ = pad_and_shard(mesh, X)
    mean = _as_tensor(mean)
    return Xs.map(lambda x, m: (x - mean.to(x.device)) * m[:, None], mask)


def best_mu_sharded(A, start=0.0, end=1.0, step=0.05):
    """:func:`~sq_learn_tpu_torch.ops.quantum.norms.best_mu` of a sharded
    matrix: each shard's row maxima and column power sums, the column sums
    and the Frobenius norm summed in shard order, the row maxima's max.
    Returns (description, value)."""
    mesh = A.mesh
    grid = _search_grid(start, end, step)
    qs, qpos, uniform = _grid_exponents(grid)
    sweeps = [_power_sweep(a, qs, qpos, uniform) for a in A.shards]
    row_max = torch.max(mesh.gather([s[0][None] for s in sweeps]), dim=0)
    cols = mesh.psum([s[1] for s in sweeps])
    vals = _combine(grid, qs, row_max.values,
                    torch.max(cols, dim=1).values)
    frob = torch.sqrt(mesh.psum([torch.sum(a * a) for a in A.shards]))
    return select_mu(grid, vals.cpu().numpy(), float(frob))
