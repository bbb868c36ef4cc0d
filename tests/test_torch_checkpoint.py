"""The port's checkpoints (``sq_learn_tpu_torch.utils.checkpoint``) against
the JAX package's, on the CPU: estimator checkpoints round-trip in the
port, a checkpoint the JAX package wrote loads in the port and predicts
what the JAX estimator predicts, and the stream-state files are
torn-write hardened and readable by either package.

Tolerances: a port round trip is exact (the same arrays come back); a JAX
checkpoint's predictions are held to the JAX estimator's — labels and
neighbor lists equal, transforms at rtol 1e-5.

Run as a script (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_checkpoint.py``, ~1 min) it prints the ARI of
``examples/streaming_fit.py``'s flow on the CICIDS surrogate (50 000 × 78,
standardized; ``partial_fit`` on 1024-row batches with a save and a load
after 10) for random_state 0–9 in both packages: the JAX package's lowest
sets ``chip_smoke.STREAM_FIT_ARI_FLOOR``.
"""

import json
import os

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import KNeighborsClassifier as JaxKNN
from sq_learn_tpu.models import QKMeans as JaxQKMeans
from sq_learn_tpu.models import QPCA as JaxQPCA
from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu.preprocessing import StandardScaler as JaxScaler
from sq_learn_tpu.utils import checkpoint as jckpt
from sq_learn_tpu_torch import config_context, streaming
from sq_learn_tpu_torch.models import (QLSSVC, QPCA, KNeighborsClassifier,
                                       MiniBatchQKMeans, QKMeans,
                                       TruncatedSVD)
from sq_learn_tpu_torch.preprocessing import StandardScaler
from sq_learn_tpu_torch.utils import checkpoint as ckpt
from sq_learn_tpu_torch.utils import load_estimator, save_estimator


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=5.0, size=(4, 8))
    y = rng.integers(0, 4, 600)
    X = (centers[y] + rng.normal(size=(600, 8))).astype(np.float32)
    return X, y


def _numpy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- port round trips ---------------------------------------------------------


def _fitted(name, X, y):
    if name == "qkmeans":
        return QKMeans(n_clusters=4, delta=0.5, true_distance_estimate=False,
                       random_state=0).fit(X)
    if name == "qpca":
        return QPCA(n_components=3, svd_solver="full", random_state=0).fit(
            X, estimate_all=True, eps=0.1, delta=0.1, theta_major=1e-9,
            true_tomography=False)
    if name == "knn":
        return KNeighborsClassifier(n_neighbors=5).fit(X, y)
    if name == "tsvd":
        return TruncatedSVD(3, random_state=0).fit(X)
    if name == "scaler":
        return StandardScaler().fit(X)
    two = y <= 1
    return QLSSVC(kernel="linear", random_state=0).fit(
        X[two][:80], 1.0 - 2.0 * y[two][:80])


def _outputs(name, est, X):
    if name == "qkmeans":
        return [est.predict(X), est.transform(X), est.score(X)]
    if name == "qpca":
        return [_numpy(est.transform(X)), est.estimate_s_values]
    if name == "knn":
        return [est.predict(X), *est.kneighbors(X[:50])]
    if name == "qlssvc":
        return [est.predict(X[:40])]
    return [_numpy(est.transform(X))]


@pytest.mark.parametrize("name", ["qkmeans", "qpca", "knn", "tsvd",
                                  "scaler", "qlssvc"])
def test_port_round_trip_predicts_the_same(tmp_path, blobs, name):
    X, y = blobs
    est = _fitted(name, X, y)
    path = save_estimator(est, str(tmp_path / name))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["format"] == "sq-learn-tpu-estimator-v1"
    assert meta["format_version"] == 2
    assert meta["class"].startswith("sq_learn_tpu_torch.")
    loaded = load_estimator(path)
    assert type(loaded) is type(est)
    assert loaded.get_params() == est.get_params()
    for a, b in zip(_outputs(name, loaded, X), _outputs(name, est, X)):
        np.testing.assert_array_equal(a, b)


def test_knn_device_cache_is_rebuilt_after_a_load(tmp_path, blobs):
    """Private attributes are transient: the training rows come back as
    numpy and no norms; the first search places both, once."""
    X, y = blobs
    path = save_estimator(KNeighborsClassifier().fit(X, y),
                          str(tmp_path / "knn"))
    loaded = load_estimator(path)
    assert isinstance(loaded.X_fit_, np.ndarray)
    assert not hasattr(loaded, "_x_sq_fit")
    loaded.predict(X[:3])
    assert isinstance(loaded.X_fit_, torch.Tensor)
    assert loaded._x_sq_fit.shape == (600,)


def test_digest_and_format_version_guards(tmp_path, blobs):
    X, y = blobs
    path = save_estimator(TruncatedSVD(2, random_state=0).fit(X),
                          str(tmp_path / "svd"))
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path))
    # a v1 checkpoint (no digest) loads unchecked
    json.dump({k: v for k, v in meta.items()
               if k not in ("state_digest", "format_version")},
              open(meta_path, "w"))
    assert load_estimator(path).components_.shape == (2, 8)
    json.dump(dict(meta, format_version=3), open(meta_path, "w"))
    with pytest.raises(ValueError, match="format_version 3"):
        load_estimator(path)
    json.dump(dict(meta, state_digest="00000000"), open(meta_path, "w"))
    with pytest.raises(ValueError, match="stale or corrupt"):
        load_estimator(path)
    json.dump(dict(meta, format="other"), open(meta_path, "w"))
    with pytest.raises(ValueError, match="not an estimator checkpoint"):
        load_estimator(path)


def streaming_fit_flow(cls, save, load, X, random_state, tmp_dir,
                       save_after=10, batch=1024):
    """``examples/streaming_fit.py``'s flow with either package's classes:
    ``MiniBatchQKMeans(6, delta=0.3)`` ``partial_fit`` on ``batch``-row
    slices of X, saved after ``save_after`` of them, loaded, continued.
    Returns the fitted estimator."""
    est = cls(n_clusters=6, delta=0.3, true_distance_estimate=False,
              random_state=random_state)
    batches = [X[i:i + batch] for i in range(0, len(X), batch)]
    for b in batches[:save_after]:
        est.partial_fit(b)
    path = save(est, os.path.join(tmp_dir, f"mb{random_state}"))
    est = load(path)
    for b in batches[save_after:]:
        est.partial_fit(b)
    assert est.n_steps_ == len(batches)
    return est


def test_streaming_fit_flow_in_both_packages(tmp_path):
    from sq_learn_tpu.models import MiniBatchQKMeans as JaxMB

    rng = np.random.default_rng(3)
    centers = rng.normal(scale=6.0, size=(6, 5))
    X = (centers[rng.integers(0, 6, 3000)]
         + rng.normal(size=(3000, 5))).astype(np.float32)
    for cls, save, load in ((MiniBatchQKMeans, save_estimator,
                             load_estimator),
                            (JaxMB, jckpt.save_estimator,
                             jckpt.load_estimator)):
        est = streaming_fit_flow(cls, save, load, X, 0, str(tmp_path),
                                 save_after=2, batch=256)
        assert est.n_steps_ == 12 and np.isfinite(est.cluster_centers_).all()


def test_partial_fit_resumes_across_a_checkpoint(tmp_path, blobs):
    """``examples/streaming_fit.py``'s flow: ``partial_fit`` on batches,
    save after a few, load, continue."""
    X, _ = blobs
    est = MiniBatchQKMeans(n_clusters=4, delta=0.3,
                           true_distance_estimate=False, random_state=0)
    for batch in np.array_split(X[:300], 3):
        est.partial_fit(batch)
    path = save_estimator(est, str(tmp_path / "mb"))
    resumed = load_estimator(path)
    assert resumed.n_steps_ == 3
    np.testing.assert_array_equal(resumed.cluster_centers_,
                                  est.cluster_centers_)
    for batch in np.array_split(X[300:], 3):
        resumed.partial_fit(batch)
    assert resumed.n_steps_ == 6
    assert np.isfinite(resumed.cluster_centers_).all()


# -- checkpoints the JAX package wrote ---------------------------------------


def _jax_and_port(name, X, y):
    if name == "qkmeans":
        return (JaxQKMeans(n_clusters=4, delta=0.0, random_state=0).fit(X),
                lambda e: e.predict(X))
    if name == "knn":
        return (JaxKNN(n_neighbors=5).fit(X, y),
                lambda e: _numpy(e.kneighbors(X[:50])[1]))
    if name == "qpca":
        return (JaxQPCA(n_components=3, svd_solver="full").fit(X),
                lambda e: _numpy(e.transform(X)))
    if name == "tsvd":
        return (JaxTruncatedSVD(3, random_state=0).fit(X),
                lambda e: _numpy(e.transform(X)))
    return JaxScaler().fit(X), lambda e: _numpy(e.transform(X))


@pytest.mark.parametrize("name", ["qkmeans", "knn", "qpca", "tsvd",
                                  "scaler"])
def test_jax_written_checkpoint_loads_and_predicts_alike(tmp_path, blobs,
                                                         name):
    X, y = blobs
    jest, outputs = _jax_and_port(name, X, y)
    path = jckpt.save_estimator(jest, str(tmp_path / name))
    assert json.load(open(os.path.join(path, "meta.json")))[
        "class"].startswith("sq_learn_tpu.")
    port = load_estimator(path)
    assert type(port).__module__.startswith("sq_learn_tpu_torch.")
    ours, theirs = outputs(port), outputs(jest)
    if ours.dtype.kind in "iu":
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_port_checkpoint_reads_in_the_jax_loader_format(tmp_path, blobs):
    """The file format is shared: the JAX package's reader verifies the
    port's digest and reads its arrays (it cannot build a port class)."""
    X, _ = blobs
    path = save_estimator(QKMeans(n_clusters=4, delta=0.0,
                                  random_state=0).fit(X), str(tmp_path / "k"))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["state_digest"] == jckpt._file_crc32(
        os.path.join(path, "state.npz"))
    with np.load(os.path.join(path, "state.npz")) as npz:
        assert npz["state_cluster_centers_"].shape == (4, 8)


def test_unknown_class_raises(tmp_path, blobs):
    X, _ = blobs
    path = jckpt.save_estimator(JaxQKMeans(n_clusters=4, delta=0.0).fit(X),
                                str(tmp_path / "k"))
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path))
    json.dump(dict(meta, **{"class": "sq_learn_tpu.serving.Nope"}),
              open(meta_path, "w"))
    with pytest.raises(ValueError, match="no counterpart"):
        load_estimator(path)


# -- pytrees ------------------------------------------------------------------


def test_pytree_round_trip_and_jax_compatibility(tmp_path):
    tree = {"centers": torch.arange(6.0).reshape(2, 3),
            "counts": (np.ones(2, np.float32), torch.tensor(3))}
    path = str(tmp_path / "state.npz")
    ckpt.save_pytree(path, tree, step=7)
    back, step = ckpt.load_pytree(path, tree)
    assert step == 7
    np.testing.assert_array_equal(back["centers"], tree["centers"].numpy())
    np.testing.assert_array_equal(back["counts"][0], tree["counts"][0])
    # the same leaf order as jax.tree_util: the JAX loader reads it
    jtree = {"centers": np.zeros((2, 3)), "counts": (np.zeros(2),
                                                     np.zeros(()))}
    jback, jstep = jckpt.load_pytree(path, jtree)
    assert jstep == 7
    np.testing.assert_array_equal(jback["centers"], back["centers"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_pytree(path, {"centers": 0})


# -- stream state ------------------------------------------------------------


def _acc(v):
    return (torch.full((3, 3), float(v)), torch.full((3,), float(v)))


def test_stream_state_retains_prev_and_falls_back(tmp_path):
    path = str(tmp_path / "s.npz")
    ckpt.save_stream_state(path, _acc(1), 2, "fp")
    ckpt.save_stream_state(path, _acc(2), 4, "fp")
    assert os.path.exists(path + ".prev")
    acc, cursor = ckpt.load_stream_state(path, _acc(0), "fp")
    assert cursor == 4 and acc[0][0, 0] == 2.0
    with open(path, "wb") as fh:
        fh.write(b"torn")
    acc, cursor = ckpt.load_stream_state(path, _acc(0), "fp")
    assert cursor == 2 and acc[1][0] == 1.0
    os.remove(path)  # killed between the two renames
    assert ckpt.load_stream_state(path, _acc(0), "fp")[1] == 2
    with open(path + ".prev", "wb") as fh:
        fh.write(b"torn")
    assert ckpt.load_stream_state(path, _acc(0), "fp") is None


def test_stream_state_mismatch_never_falls_back(tmp_path):
    path = str(tmp_path / "s.npz")
    ckpt.save_stream_state(path, _acc(1), 2, "fp")
    ckpt.save_stream_state(path, _acc(2), 4, "other pass")
    assert ckpt.load_stream_state(path, _acc(0), "fp") is None
    assert ckpt.load_stream_state(path, (_acc(0)[0],), "other pass") is None


def test_stream_state_files_are_shared_with_jax(tmp_path):
    ours, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ckpt.save_stream_state(ours, _acc(5), 3, "fp")
    jckpt.save_stream_state(theirs, tuple(a.numpy() for a in _acc(6)), 5,
                            "fp")
    like = tuple(np.zeros_like(a.numpy()) for a in _acc(0))
    acc, cursor = jckpt.load_stream_state(ours, like, "fp")
    assert cursor == 3 and acc[0][0, 0] == 5.0
    acc, cursor = ckpt.load_stream_state(theirs, _acc(0), "fp")
    assert cursor == 5 and acc[1][2] == 6.0


def test_async_checkpointer_snapshots_before_the_next_update(tmp_path):
    """The snapshot is a copy taken at submit: an in-place update right
    after it does not reach the file; latest wins; close drains."""
    path = str(tmp_path / "a.npz")
    writer = ckpt.AsyncStreamCheckpointer(path)
    acc = _acc(1)
    writer.submit(acc, 1, "fp")
    acc[0].add_(100.0)  # the next tile's in-place update
    writer.close()
    got, cursor = ckpt.load_stream_state(path, acc, "fp")
    assert cursor == 1 and (got[0] == 1.0).all()
    writer = ckpt.AsyncStreamCheckpointer(path)
    for i in range(20):
        writer.submit(_acc(i), i, "fp")
    writer.close()
    assert writer.writes + writer.dropped == 20
    assert ckpt.load_stream_state(path, acc, "fp")[1] == 19


def test_async_checkpointer_surfaces_writer_errors(tmp_path):
    writer = ckpt.AsyncStreamCheckpointer(str(tmp_path / "no" / "dir.npz"))
    writer.submit(_acc(1), 1, "fp")
    with pytest.raises(OSError):
        writer.close()


def test_stream_fold_checkpoint_is_removed_after_a_completed_pass(tmp_path):
    X = np.random.default_rng(1).normal(size=(400, 4)).astype(np.float32)
    path = str(tmp_path / "g.npz")
    out = streaming.streamed_centered_gram(
        X, max_bytes=40 * 16,
        checkpoint=streaming.StreamCheckpoint(path, every=2))
    assert np.isfinite(out[1].numpy()).all()
    assert not os.path.exists(path) and not os.path.exists(path + ".prev")


if __name__ == "__main__":
    import tempfile
    import warnings

    from sq_learn_tpu.models import MiniBatchQKMeans as JaxMB
    from sq_learn_tpu_torch import set_config
    from sq_learn_tpu_torch.datasets import load_cicids
    from sq_learn_tpu_torch.metrics import adjusted_rand_score

    warnings.simplefilter("ignore")
    set_config(device="cpu")
    X, y, _ = load_cicids(n_samples=50_000)
    Xs = StandardScaler().fit_transform(X).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cls, save, load in (
                ("port", MiniBatchQKMeans, save_estimator, load_estimator),
                ("jax", JaxMB, jckpt.save_estimator, jckpt.load_estimator)):
            aris = [float(adjusted_rand_score(y, np.asarray(
                streaming_fit_flow(cls, save, load, Xs, seed, tmp).predict(
                    Xs)))) for seed in range(10)]
            print(name, aris, "lowest", min(aris))
