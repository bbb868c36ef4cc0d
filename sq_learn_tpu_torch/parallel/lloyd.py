"""Data-parallel Lloyd iteration over a mesh (counterpart of
``sq_learn_tpu/parallel/lloyd.py``).

The rows are split over the mesh, each shard runs the fused Lloyd step
(:func:`~sq_learn_tpu_torch.ops.kernels.lloyd_step`, the kernel on a
CUDA shard) on its rows, and the partial centroid sums, counts and
inertia are summed in shard order on the mesh's first device, where the
centers and the stop rule live (:func:`~sq_learn_tpu_torch.models.
qkmeans.lloyd_single` with ``mesh``).
"""

from .. import obs as _obs
from .mesh import ShardedRows, pad_to_multiple, shard_rows


def lloyd_single_sharded(mesh, generator, X, weights, centers_init,
                         x_sq_norms, **static):
    """One q-means run of :func:`~sq_learn_tpu_torch.models.qkmeans.
    lloyd_single` with X, weights and x_sq_norms split over ``mesh``.

    The tensors are padded to a multiple of the shard count (padding rows
    get weight 0, so they add nothing to sums, counts or inertia) and
    sharded; already sharded ones (:class:`ShardedRows`) are used as
    they are. ``centers_init`` is (k, m). ``static`` holds
    :func:`lloyd_single`'s keywords.

    Returns (labels (n,) as :class:`ShardedRows`, inertia, centers (k, m),
    n_iter, history), the floats on the mesh's first device.
    """
    from ..models.qkmeans import lloyd_single

    if isinstance(X, ShardedRows):
        n = X.n
        Xs, ws, xs = X, weights, x_sq_norms
    else:
        n = X.shape[0]
        Xs, ws, xs = shard_rows(
            mesh, *(pad_to_multiple(a, mesh.size)[0]
                    for a in (X, weights, x_sq_norms)), n=n)
    with _obs.span("parallel.lloyd.single_sharded", n_devices=mesh.size,
                   n_samples=int(n), mode=static.get("mode")) as sp:
        labels, inertia, centers, n_iter, history = lloyd_single(
            generator, Xs, ws, centers_init.to(mesh.lead)[None], xs,
            mesh=mesh, **static)
        sp.sync(centers)
    return (labels.map(lambda lab: lab[0], dim=0), inertia[0], centers[0],
            n_iter[0], {name: t[0] for name, t in history.items()})
