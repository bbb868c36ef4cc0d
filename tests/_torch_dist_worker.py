"""Worker of ``tests/test_torch_distributed.py``: one process of a
two-process gloo world on localhost, each process with 2 CPU shards, in
the shape of ``tests/_dist_worker.py``::

    python tests/_torch_dist_worker.py <process_id> <num_processes> \
        <port> <repo root> <output dir>

It initializes the world (twice: the second call is a no-op; a call with
another generation raises), checks ``process_info`` and
``host_shard_bounds``, loads only its rows of a 37-row dataset, and runs
on ``global_mesh()``: the weighted column sum, the total weight, the
sharded Gram SVD, the δ=0 and δ=0.4 Lloyd loops, the sharded k-means++
init, the δ=0 QKMeans fit and the train-sharded 5-NN search. It writes
the results to ``<output dir>/worker<id>.npz`` for the test to hold bit
for bit against the same calls on a 4-shard mesh in one process.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, sys.argv[4])  # the repository root

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sq_learn_tpu_torch import set_config  # noqa: E402
from sq_learn_tpu_torch.parallel import distributed as dist  # noqa: E402
from sq_learn_tpu_torch.parallel.mesh import shard_local  # noqa: E402

N, M = 37, 5


def dataset():
    """The global 37 × 5 dataset, the 3 start centers, the 40-row corpus
    and the 8 queries of the search; every process makes the same."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, M)).astype(np.float32)
    Xt = rng.normal(size=(40, M)).astype(np.float32)
    return X, X[:3].copy(), Xt, Xt[:8].copy()


def run(mesh, X_rows, w_rows, X):
    """Every sharded routine of the test on ``mesh``; ``X_rows``/``w_rows``
    are the sharded dataset and its weights. Returns {name: array}."""
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.parallel import (kmeans_plusplus_sharded,
                                             knn_indices_sharded,
                                             lloyd_single_sharded)
    from sq_learn_tpu_torch.parallel.pca import _masked_gram_svd
    from sq_learn_tpu_torch.utils import as_generator

    _, C0, Xt, Q = dataset()
    out = {}
    out["colsum"] = mesh.psum([torch.sum(x * w[:, None], dim=0) for x, w
                               in zip(X_rows.shards, w_rows.shards)])
    out["weight"] = mesh.psum([torch.sum(w) for w in w_rows.shards])
    mean, U, S, Vt = _masked_gram_svd(mesh, X_rows, w_rows, N, center=True)
    out.update(mean=mean, U=U.to_tensor(), S=S, Vt=Vt)
    xsq = X_rows.map(lambda x: torch.sum(x * x, dim=1))
    for name, kw in (("lloyd0", dict(max_iter=6, tol=0.0)),
                     ("lloyd_delta", dict(delta=0.4, mode="delta",
                                          max_iter=5, tol=0.0))):
        labels, inertia, centers, n_iter, _ = lloyd_single_sharded(
            mesh, as_generator(0, "cpu"), X_rows, w_rows,
            torch.from_numpy(C0), xsq, **kw)
        out.update({f"{name}_labels": labels.to_tensor(),
                    f"{name}_inertia": inertia, f"{name}_centers": centers,
                    f"{name}_n_iter": n_iter})
    Xfull = torch.from_numpy(X)
    _, out["kpp"] = kmeans_plusplus_sharded(
        mesh, as_generator(11, "cpu"), Xfull, None, 3, n_restarts=2)
    km = QKMeans(n_clusters=3, n_init=2, delta=0.0, random_state=5,
                 mesh=mesh).fit(X)
    out.update(fit_labels=torch.from_numpy(km.labels_),
               fit_centers=torch.from_numpy(km.cluster_centers_),
               fit_n_iter=torch.tensor(km.n_iter_))
    out["knn_idx"], out["knn_d2"] = knn_indices_sharded(
        mesh, torch.from_numpy(Xt), torch.from_numpy(Q), 5)
    return {k: v.cpu().numpy() for k, v in out.items()}


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    outdir = sys.argv[5]
    set_config(device="cpu")
    dist.initialize(f"localhost:{port}", nproc, pid, devices=["cpu"] * 2)
    # a second call with no (or the same) generation is a no-op
    dist.initialize(f"localhost:{port}", nproc, pid)
    dist.initialize(f"localhost:{port}", nproc, pid, generation=0)
    try:
        dist.initialize(f"localhost:{port}", nproc, pid, generation=1)
    except RuntimeError as exc:
        assert "shutdown()" in str(exc), exc
    else:
        raise AssertionError("a generation-1 initialize did not raise")
    assert dist.generation() == 0
    assert dist.process_info() == (pid, nproc, 2), dist.process_info()
    mesh = dist.global_mesh()
    assert mesh.size == 2 * nproc and mesh.offset == 2 * pid, mesh

    # every process loads only its own bounds of the 37 rows, padded to the
    # uniform per-process share with zero-weight rows
    X = dataset()[0]
    lo, hi, per = dist.host_shard_bounds(N)
    assert per == 20 and (lo, hi) == ((0, 20), (20, 37))[pid], (lo, hi)
    rows = np.zeros((per, M), np.float32)
    rows[:hi - lo] = X[lo:hi]
    w = np.zeros(per, np.float32)
    w[:hi - lo] = 1.0
    out = run(mesh, shard_local(mesh, rows, N), shard_local(mesh, w, N), X)
    np.testing.assert_allclose(out["colsum"], X.sum(axis=0), rtol=1e-5,
                               atol=1e-5)
    assert float(out["weight"]) == N
    np.savez(os.path.join(outdir, f"worker{pid}.npz"), **out)
    dist.shutdown()
    assert dist.generation() is None
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
