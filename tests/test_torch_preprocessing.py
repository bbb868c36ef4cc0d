"""The port's scalers against the JAX package's.

The same seeded float32 data (with a constant column, and a zero row for
the normalizer) goes through both; statistics and outputs must agree at
rtol 1e-5 (float32 reductions in another order), and outputs near zero
within 1e-5 of the output's largest magnitude (X − mean cancels a mean
that differs by an ulp). ``torch.var`` defaults to
the unbiased estimator while ``jnp.var`` takes ddof 0: the port passes
``correction=0``, which the variance check pins.
"""

import numpy as np
import pytest
import torch

from sq_learn_tpu import preprocessing as jp
from sq_learn_tpu_torch import config_context, preprocessing
from sq_learn_tpu_torch.convert import scaler_from_numpy

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _data(n=200, m=7, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, m)) * np.geomspace(0.1, 30.0, m)
         + rng.normal(size=m) * 5).astype(np.float32)
    X[:, 2] = 3.0  # a constant column: exact in float32 sums
    return X


def _close(actual, desired):
    np.testing.assert_allclose(actual, desired, rtol=RTOL,
                               atol=RTOL * np.abs(desired).max())


def _np(t):
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    return t.numpy()


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True),
                                                (True, False)])
def test_standard_scaler_matches_jax(with_mean, with_std):
    X, Xq = _data(), _data(50, seed=1)
    ours = preprocessing.StandardScaler(with_mean=with_mean,
                                        with_std=with_std).fit(X)
    ref = jp.StandardScaler(with_mean=with_mean, with_std=with_std).fit(X)
    np.testing.assert_allclose(ours.mean_, ref.mean_, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.scale_, ref.scale_, rtol=RTOL)
    if with_std:
        np.testing.assert_allclose(ours.var_, ref.var_, rtol=RTOL)
        # ddof 0: the biased variance, as jnp.var
        np.testing.assert_allclose(ours.var_, X.var(axis=0), rtol=RTOL)
        assert ours.scale_[2] == 1.0
    else:
        assert ours.var_ is None and ref.var_ is None
    assert ours.n_samples_seen_ == ref.n_samples_seen_ == 200
    assert ours.n_features_in_ == 7
    _close(_np(ours.transform(Xq)), ref.transform(Xq))
    Xt = ours.fit_transform(X)
    _close(_np(Xt), ref.fit_transform(X))
    np.testing.assert_allclose(_np(ours.inverse_transform(Xt)),
                               ref.inverse_transform(ref.transform(X)),
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("feature_range", [(0, 1), (-2.0, 3.0)])
def test_minmax_scaler_matches_jax(feature_range):
    X, Xq = _data(), _data(50, seed=1)
    ours = preprocessing.MinMaxScaler(feature_range).fit(X)
    ref = jp.MinMaxScaler(feature_range).fit(X)
    for name in ("data_min_", "data_max_", "scale_", "min_"):
        np.testing.assert_allclose(getattr(ours, name), getattr(ref, name),
                                   rtol=RTOL, atol=ATOL)
    _close(_np(ours.transform(Xq)), ref.transform(Xq))
    Xt = ours.transform(X)
    lo, hi = feature_range
    assert float(Xt.min()) >= lo - 1e-5 and float(Xt.max()) <= hi + 1e-5
    np.testing.assert_allclose(_np(ours.inverse_transform(Xt)), X,
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("norm", ["l2", "l1", "max"])
def test_normalizer_matches_jax(norm):
    X = _data()
    X[5] = 0.0  # a zero row stays zero
    ours = preprocessing.Normalizer(norm).fit(X)
    assert ours.n_features_in_ == 7
    out = _np(ours.transform(X))
    _close(out, jp.Normalizer(norm).fit_transform(X))
    assert not out[5].any()


def test_normalizer_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="unknown norm"):
        preprocessing.Normalizer("l3").fit_transform(_data())


def test_scalers_keep_a_tensor_where_it_lies_and_check_the_width():
    X = torch.from_numpy(_data())
    sc = preprocessing.StandardScaler().fit(X)
    out = sc.transform(X)
    assert out.dtype == torch.float32 and out.device == X.device
    with pytest.raises(ValueError, match="expecting 7 features"):
        sc.transform(X[:, :3])
    with pytest.raises(ValueError, match="not fitted"):
        preprocessing.MinMaxScaler().transform(X)


@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler",
                                  "Normalizer"])
def test_scaler_from_numpy_transforms_as_the_jax_scaler(name):
    X, Xq = _data(), _data(50, seed=1)
    ref = getattr(jp, name)().fit(X)
    port = scaler_from_numpy(vars(ref), name, device="cpu",
                             params=ref.get_params())
    assert type(port) is getattr(preprocessing, name)
    assert port.n_features_in_ == 7 and port.device == "cpu"
    _close(_np(port.transform(Xq)), ref.transform(Xq))
    with pytest.raises(ValueError, match="scaler must be one of"):
        scaler_from_numpy(vars(ref), "RobustScaler")
    with pytest.raises(ValueError, match="attrs must hold"):
        scaler_from_numpy({}, name)
