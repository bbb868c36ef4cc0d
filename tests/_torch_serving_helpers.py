"""Shared set-up of the serving tests (``tests/test_torch_serving*.py``):
tenants fitted by the JAX package on a small blob set and written as JAX
checkpoints, the same request stream for both packages, the margin rule
for labels and the float64 bounds for transforms.
"""

import os

import numpy as np

#: feature width and rows of the blob set the tenants are fitted on
WIDTH = 12
ROWS = 400

#: tolerances of a served float32 transform against float64: squared
#: center distances within 1e-5·(‖x‖² + ‖c‖²), projections within
#: 1e-5·‖x − μ‖ per row (a plain rtol fails where a distance nears 0)
DIST_RTOL = 1e-5
PROJ_RTOL = 1e-5

#: labels must agree wherever the float64 gap between the two nearest
#: squared center distances exceeds this many times the measured float32
#: squared-distance error (the k-NN margin rule of ROADMAP §3)
MARGIN_FACTOR = 3.0


def blobs(seed=0, rows=ROWS, width=WIDTH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, width))
            + 5.0 * rng.integers(0, 3, size=(rows, 1))).astype(np.float32)


def jax_tenants(tmp_path):
    """A JAX q-means, TruncatedSVD and QPCA fitted on :func:`blobs`, each
    also written as a JAX checkpoint. Returns ``{name: (estimator,
    checkpoint dir)}``."""
    from sq_learn_tpu.models import QKMeans, QPCA, TruncatedSVD
    from sq_learn_tpu.utils.checkpoint import save_estimator

    X = blobs()
    fitted = {
        "km": QKMeans(n_clusters=3, random_state=0, n_init=1).fit(X),
        "svd": TruncatedSVD(n_components=3, random_state=0).fit(X),
        "pca": QPCA(n_components=3, svd_solver="full").fit(X),
    }
    return {name: (est, save_estimator(est, os.path.join(str(tmp_path),
                                                         name)))
            for name, est in fitted.items()}


def request_stream(n=96, seed=7, sizes=(1, 2, 4, 8, 16), width=WIDTH):
    """``n`` requests of the given row counts, alternating float32 and
    float64, drawn around the blob centers."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = (rng.normal(size=(sizes[i % len(sizes)], width))
                + 5.0 * rng.integers(0, 3))
        out.append(rows.astype(np.float32 if i % 2 == 0 else np.float64))
    return out


def sq_distances64(rows, centers):
    x = np.asarray(rows, np.float32).astype(np.float64)
    c = np.asarray(centers, np.float64)
    return ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
            - 2.0 * (x @ c.T))


def check_labels(labels, rows, centers, f32_sq_err, expected):
    """``labels`` equal ``expected`` wherever the float64 gap between the
    two nearest squared center distances exceeds
    ``MARGIN_FACTOR · f32_sq_err``; returns the number of rows held."""
    d2 = np.sort(sq_distances64(rows, centers), axis=1)
    held = (d2[:, 1] - d2[:, 0]) > MARGIN_FACTOR * f32_sq_err
    np.testing.assert_array_equal(np.asarray(labels)[held],
                                  np.asarray(expected)[held])
    return int(held.sum())


def check_center_distances(dist, rows, centers):
    """Served distances, squared, within ``DIST_RTOL·(‖x‖² + ‖c‖²)`` of
    the float64 squared distances."""
    x = np.asarray(rows, np.float32).astype(np.float64)
    c = np.asarray(centers, np.float64)
    scale = (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
    err = np.abs(np.asarray(dist, np.float64) ** 2 - sq_distances64(x, c))
    assert (err <= DIST_RTOL * scale).all(), float((err / scale).max())


def check_projection(proj, rows, mean, components):
    """Served projections within ``PROJ_RTOL·‖x − μ‖`` of float64, per
    row."""
    x = np.asarray(rows, np.float32).astype(np.float64)
    centered = x - np.asarray(mean, np.float64)
    ref = centered @ np.asarray(components, np.float64).T
    err = np.abs(np.asarray(proj, np.float64) - ref).max(axis=1)
    bound = PROJ_RTOL * np.linalg.norm(centered, axis=1)
    assert (err <= bound + 1e-12).all(), float((err - bound).max())


def reset_serving():
    """Both packages' process-wide serving state back to a fresh process:
    result caches, warmed signatures, pinned budgets, faults, breakers,
    recorders."""
    from sq_learn_tpu import obs as jobs
    from sq_learn_tpu.resilience import faults as jfaults
    from sq_learn_tpu.resilience.supervisor import breaker as jbreaker
    from sq_learn_tpu.serving import aot as jaot
    from sq_learn_tpu.serving import cache as jcache
    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.resilience import faults
    from sq_learn_tpu_torch.resilience.supervisor import breaker
    from sq_learn_tpu_torch.serving import aot, cache, dispatcher

    for o in (obs, jobs):
        if o.enabled():
            o.disable()
    for c in (cache, jcache):
        c.clear()
        c.flush_counters()  # drop the tallies not yet flushed
    aot.clear()
    jaot.clear()
    dispatcher.pin_compile_budgets(None)
    for f in (faults, jfaults):
        f.disarm()
    breaker.reset("test teardown")
    jbreaker.reset("test teardown")
