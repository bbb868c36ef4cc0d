"""Multi-device fitting over a data-parallel mesh, on the port.

The port's counterpart of ``examples/sharded_fit.py``. The reference
parallelizes with OpenMP threads and a multiprocessing pool (SURVEY
§2.3); the port shards rows over a :class:`~sq_learn_tpu_torch.parallel.
Mesh` of cards. Every estimator below takes a ``mesh``:

- ``QKMeans(mesh=...)`` runs the Lloyd loop shard by shard (the fused
  Lloyd kernel on each shard) and sums the centroid and inertia partials
  in shard order on the mesh's first device.
- ``QPCA(mesh=...)`` computes the fit SVD from a sample-sharded Gram
  contraction (per-shard products + one m×m sum), and its quantum
  transform draws tomography estimates in-shard.
- ``KNeighborsClassifier(mesh=...)`` shards the TRAINING corpus: each
  shard searches its rows (the fused k-nearest kernel), and only (n_q, k)
  candidate lists are merged.
- ``TruncatedSVD(mesh=...)`` is the uncentered variant of the qPCA path.

By default the mesh is every visible card, one shard each
(``make_mesh()``); ``--shards N`` makes N shards of the one device
instead (``make_mesh(["cuda:0"] * N)``, or the CPU with ``--device
cpu``): the counterpart of XLA's forced host device count. For several
processes, call ``sq_learn_tpu_torch.parallel.distributed.initialize()``
first and build the mesh from ``global_mesh()``.

Run: python examples_torch/sharded_fit.py [--shards 4] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device  # noqa: E402

import argparse  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sq_learn_tpu_torch.datasets import load_digits, make_blobs  # noqa: E402
from sq_learn_tpu_torch.models import QKMeans, QPCA  # noqa: E402
from sq_learn_tpu_torch.parallel import make_mesh  # noqa: E402


def mesh_devices(device, shards):
    """The mesh's devices: ``shards`` copies of ``device`` (the current
    card for 'cuda'), or, for None, every visible card (one CPU shard on
    the CPU)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if shards is None:
        if device.type == "cpu":
            return [device]
        return list(make_mesh().devices)
    if shards < 1:
        raise ValueError(f"--shards must be >= 1, got {shards}")
    return [device] * shards


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the one device (default: one per "
                         "visible card)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    with on_device(args.device) as device, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        devices = mesh_devices(device, args.shards)
        mesh = make_mesh(devices)
        print(f"mesh: {len(devices)} x {devices[0].type}")

        # data-parallel q-means (delta-means noise mode)
        X, y = make_blobs(n_samples=4003, centers=5, n_features=16,
                          random_state=0)  # 4003: uneven shards exercise padding
        km = QKMeans(n_clusters=5, delta=0.5, true_distance_estimate=False,
                     n_init=2, random_state=0, mesh=mesh).fit(X)
        n_clusters = len(np.unique(km.labels_))
        print(f"q-means: inertia={km.inertia_:.1f} n_iter={km.n_iter_} "
              f"clusters={n_clusters}")

        # data-parallel qPCA (classical fit; quantum estimators compose the
        # same way — they consume the spectrum, which is replicated)
        Xd, yd = load_digits()
        pca = QPCA(n_components=16, svd_solver="full", mesh=mesh,
                   random_state=0).fit(Xd)
        evr = float(np.sum(pca.explained_variance_ratio_))
        print(f"qPCA: explained variance ratio (top-16) = {evr:.4f}")

        # ...and its tomography-noised transform, drawn in-shard over the
        # mesh
        noisy = pca.transform(Xd[:64], classic_transform=False,
                              quantum_representation=True, epsilon_delta=0.5,
                              norm="None", psi=0.5)
        Zq = noisy["quantum_representation_results"]
        print(f"qPCA quantum transform (sharded tomography): "
              f"shape={tuple(Zq.shape)}")

        # train-sharded KNN: the corpus lives on its shards, every search
        # merges per-shard candidate lists
        from sq_learn_tpu_torch.models import (KNeighborsClassifier,
                                               TruncatedSVD)

        knn = KNeighborsClassifier(n_neighbors=5, mesh=mesh).fit(Xd, yd)
        acc = float((np.asarray(knn.predict(Xd[:300])) == yd[:300]).mean())
        print(f"sharded KNN: train accuracy on 300 digits = {acc:.3f}")

        # uncentered sharded SVD (the LSA/TruncatedSVD contract)
        tsvd = TruncatedSVD(n_components=8, mesh=mesh).fit(Xd)
        sigma1 = float(tsvd.singular_values_[0])
        print(f"sharded TruncatedSVD: top singular value = {sigma1:.1f}")
    return {"shards": len(devices), "platform": devices[0].type,
            "inertia": float(km.inertia_), "n_iter": int(km.n_iter_),
            "clusters": n_clusters, "explained_variance_ratio": evr,
            "transform_shape": tuple(Zq.shape), "knn_accuracy": acc,
            "sigma1": sigma1}


if __name__ == "__main__":
    main()
