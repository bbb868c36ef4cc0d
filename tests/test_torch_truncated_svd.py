"""The port's TruncatedSVD against the JAX package's.

'arpack' (the exact thin SVD, V-based signs) must give the JAX package's
singular values at rtol 1e-4 and its components within atol 1e-4 up to
sign; 'randomized' draws its range finder from another stream, so it is
held on a low-rank-plus-noise matrix with a spectral gap, where both
sides resolve the same leading spectrum (rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from sq_learn_tpu.models import TruncatedSVD as JaxTruncatedSVD
from sq_learn_tpu_torch import TruncatedSVD, config_context
from sq_learn_tpu_torch.convert import truncated_svd_from_numpy
from sq_learn_tpu_torch.datasets import synthetic_surrogate


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _low_rank(n=400, m=30, rank=5, seed=0):
    """Rank-``rank`` signal (singular values 100 down to 20) plus noise
    of spectral norm ~1: a gap of ~20× after the leading values."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    V = np.linalg.qr(rng.normal(size=(m, rank)))[0]
    S = np.linspace(100.0, 20.0, rank)
    noise = rng.normal(size=(n, m)) / (np.sqrt(n) + np.sqrt(m))
    return ((U * S) @ V.T + noise).astype(np.float32)


def _same_up_to_sign(a, b, atol):
    signs = np.sign(np.sum(a * b, axis=1, keepdims=True))
    np.testing.assert_allclose(a * signs, b, atol=atol)


@pytest.mark.parametrize("shape", [(600, 24), (60, 40)])
def test_arpack_matches_jax(shape):
    X, _ = synthetic_surrogate(*shape, 4, seed=5)
    ours = TruncatedSVD(n_components=6, algorithm="arpack")
    ref = JaxTruncatedSVD(n_components=6, algorithm="arpack")
    Xt, Xt_ref = ours.fit_transform(X), ref.fit_transform(X)
    assert isinstance(Xt, torch.Tensor) and Xt.shape == (shape[0], 6)
    np.testing.assert_allclose(ours.singular_values_, ref.singular_values_,
                               rtol=1e-4)
    _same_up_to_sign(ours.components_, ref.components_, atol=1e-4)
    # V-based signs: both sides flip alike
    np.testing.assert_allclose(ours.components_, ref.components_, atol=1e-4)
    np.testing.assert_allclose(ours.explained_variance_,
                               ref.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(ours.explained_variance_ratio_,
                               ref.explained_variance_ratio_, rtol=1e-4)
    scale = np.abs(Xt_ref).max()
    np.testing.assert_allclose(Xt.numpy(), Xt_ref, rtol=1e-4,
                               atol=1e-4 * scale)
    assert ours.n_features_in_ == shape[1]


def test_randomized_matches_jax_on_a_spectral_gap():
    X = _low_rank()
    ours = TruncatedSVD(n_components=5, random_state=0).fit(X)
    ref = JaxTruncatedSVD(n_components=5, random_state=0).fit(X)
    np.testing.assert_allclose(ours.singular_values_, ref.singular_values_,
                               rtol=1e-4)
    _same_up_to_sign(ours.components_, ref.components_, atol=1e-4)
    np.testing.assert_allclose(ours.explained_variance_ratio_,
                               ref.explained_variance_ratio_, rtol=1e-4)
    assert 0 < ours.explained_variance_ratio_.sum() <= 1


def test_randomized_is_reproducible_from_its_seed():
    X = _low_rank(seed=1)
    a = TruncatedSVD(n_components=3, n_iter=2, random_state=7).fit(X)
    b = TruncatedSVD(n_components=3, n_iter=2, random_state=7).fit(X)
    np.testing.assert_array_equal(a.components_, b.components_)
    np.testing.assert_array_equal(a.singular_values_, b.singular_values_)


def test_explained_variance_is_the_variance_of_the_projection():
    X = _low_rank(seed=2)
    est = TruncatedSVD(n_components=4, algorithm="arpack")
    Xt = est.fit_transform(X).numpy()
    np.testing.assert_allclose(est.explained_variance_, Xt.var(axis=0),
                               rtol=1e-4)
    np.testing.assert_allclose(est.explained_variance_ratio_,
                               Xt.var(axis=0) / X.var(axis=0).sum(),
                               rtol=1e-4)


def test_transform_and_inverse_transform_round_trip():
    X = _low_rank(rank=4, seed=3)
    est = TruncatedSVD(n_components=4, algorithm="arpack").fit(X)
    Xt = est.transform(X)
    np.testing.assert_allclose(Xt.numpy(), est.fit_transform(X).numpy(),
                               rtol=1e-4, atol=1e-3)
    back = est.inverse_transform(Xt).numpy()
    # the rank-4 signal comes back; what is lost is the noise
    assert np.linalg.norm(back - X) <= 1.5 * np.linalg.norm(
        X - X @ est.components_.T @ est.components_) + 1e-3
    with pytest.raises(ValueError, match="expecting 30 features"):
        est.transform(X[:, :5])


def test_truncated_svd_from_numpy_transforms_as_jax():
    X = _low_rank(seed=4)
    ref = JaxTruncatedSVD(n_components=3, algorithm="arpack").fit(X)
    port = truncated_svd_from_numpy(vars(ref), device="cpu",
                                    params=ref.get_params())
    assert port.n_components == 3 and port.n_features_in_ == 30
    np.testing.assert_array_equal(port.singular_values_,
                                  ref.singular_values_)
    Xq = _low_rank(n=50, seed=5)
    np.testing.assert_allclose(port.transform(Xq).numpy(), ref.transform(Xq),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port.inverse_transform(port.transform(Xq))
                               .numpy(),
                               ref.inverse_transform(ref.transform(Xq)),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="components_"):
        truncated_svd_from_numpy({})


def test_unported_options_raise_and_bad_ones_are_rejected():
    X = _low_rank()
    with pytest.raises(NotImplementedError, match="item 6"):
        TruncatedSVD(mesh=object()).fit(X)
    # ingest='streamed' was ported since (item 7): it fits, tile by tile
    est = TruncatedSVD(ingest="streamed", random_state=0).fit(X)
    assert est.ingest_ == "streamed" and np.isfinite(
        est.singular_values_).all()
    for kw, match in (({"n_components": 30}, "n_components"),
                      ({"algorithm": "lobpcg"}, "algorithm"),
                      ({"ingest": "tiled"}, "ingest")):
        with pytest.raises(ValueError, match=match):
            TruncatedSVD(**kw).fit(X)
    assert TruncatedSVD(ingest="monolithic", n_components=2).fit(
        X).components_.shape == (2, 30)


def test_decomposition_facade_exports_the_estimator():
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch.decomposition import TruncatedSVD as facade

    assert facade is TruncatedSVD is sqt.models.TruncatedSVD
