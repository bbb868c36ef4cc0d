"""The port's MurmurHash3 and FeatureHasher against the JAX package's and
sklearn's.

The hash must be bit-equal to the JAX package's native
``murmurhash3_bulk``. The hasher follows sklearn's column rule,
``abs(signed h) % n_features`` (sklearn's ``FeatureHasher.toarray()`` is
the reference here); the JAX package takes the unsigned hash instead, so
the two agree only where the signed hash is ≥ 0 (ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch
from sklearn.feature_extraction import FeatureHasher as SkHasher

from sq_learn_tpu.feature_extraction import FeatureHasher as JaxHasher
from sq_learn_tpu.native import murmurhash3_bulk
from sq_learn_tpu_torch import FeatureHasher, config_context
from sq_learn_tpu_torch.utils.murmurhash import murmurhash3_32


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _tokens(kind, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    # non-ASCII code points below the UTF-16 surrogates
    lo, hi = (32, 127) if kind == "ascii" else (160, 0xD800)
    return ["".join(chr(c) for c in rng.integers(lo, hi,
                                                  rng.integers(0, 41)))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["ascii", "non-ascii"])
def test_murmurhash_is_bit_equal_to_the_jax_package(kind):
    toks = _tokens(kind) + ["", "a", "ab", "abc", "abcd", "abcde"]
    np.testing.assert_array_equal(murmurhash3_32(toks),
                                  murmurhash3_bulk(toks, seed=0))


def test_murmurhash_of_the_empty_string_and_bytes():
    assert murmurhash3_32([""])[0] == murmurhash3_bulk([""])[0] == 0
    assert murmurhash3_32([b"foo"])[0] == murmurhash3_32(["foo"])[0]
    assert murmurhash3_32([]).shape == (0,)
    with pytest.raises(TypeError, match="str or bytes"):
        murmurhash3_32([3])


def _rows(seed=0, n=60):
    rng = np.random.default_rng(seed)
    vocab = _tokens("ascii", 200, seed + 1)[:150] + _tokens("non-ascii", 50,
                                                           seed + 2)
    dicts, pairs, strings = [], [], []
    for _ in range(n):
        toks = list(rng.choice(vocab, rng.integers(0, 12)))
        vals = rng.integers(-3, 4, len(toks)).astype(float)
        dicts.append(dict(zip(toks, vals)))
        pairs.append(list(zip(toks, vals)))
        strings.append(toks)
    # string values hash as "name=value" with value 1
    dicts[0] = {"proto": "tcp", "port": 80.0, "zero": 0.0}
    return {"dict": dicts, "pair": pairs, "string": strings}


@pytest.mark.parametrize("alternate_sign", [True, False])
@pytest.mark.parametrize("input_type", ["dict", "pair", "string"])
def test_hasher_equals_sklearn(input_type, alternate_sign):
    rows = _rows()[input_type]
    for n_features in (16, 1024):
        out = FeatureHasher(n_features, input_type=input_type,
                            alternate_sign=alternate_sign).transform(rows)
        ref = SkHasher(n_features, input_type=input_type,
                       alternate_sign=alternate_sign).transform(
            rows).toarray()
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
        assert out.device.type == "cpu" and out.shape == (len(rows),
                                                          n_features)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("input_type", ["dict", "pair", "string"])
def test_hasher_equals_the_jax_package_where_the_signed_hash_is_not_negative(
        input_type):
    """Rows of tokens whose signed hash is ≥ 0 land in the same columns
    with the same values; a token with a negative signed hash lands in
    another column unless the two rules coincide."""
    rows = _rows(seed=3)[input_type]
    toks = sorted({t for r in _rows(seed=3)["string"] for t in r})
    h = murmurhash3_32(toks).view(np.int32)
    keep = {t for t, v in zip(toks, h) if v >= 0}
    if input_type == "dict":
        rows = [{t: v for t, v in r.items() if t in keep} for r in rows[1:]]
    elif input_type == "pair":
        rows = [[(t, v) for t, v in r if t in keep] for r in rows]
    else:
        rows = [[t for t in r if t in keep] for r in rows]
    out = FeatureHasher(64, input_type=input_type).transform(rows)
    ref = JaxHasher(64, input_type=input_type).transform(rows)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_baz_lands_in_column_6_not_the_jax_packages_column_10():
    """The smallest input that shows the JAX package's column fault:
    murmurhash3_32("baz") is −244 814 614 signed, 4 050 152 682 unsigned;
    sklearn puts −1 in column 244 814 614 % 16 = 6, the JAX package in
    column 4 050 152 682 % 16 = 10."""
    out = FeatureHasher(16, input_type="string").transform([["baz"]])
    expected = np.zeros((1, 16), np.float32)
    expected[0, 6] = -1.0
    np.testing.assert_array_equal(out.numpy(), expected)
    np.testing.assert_array_equal(
        SkHasher(16, input_type="string").transform([["baz"]]).toarray(),
        expected)
    jax_out = JaxHasher(16, input_type="string").transform([["baz"]])
    assert jax_out[0, 10] == -1.0 and jax_out[0, 6] == 0.0
    # "foo" and "bar" agree with the JAX package
    both = [["foo"], ["bar"]]
    np.testing.assert_array_equal(
        FeatureHasher(16, input_type="string").transform(both).numpy(),
        JaxHasher(16, input_type="string").transform(both))


def test_hasher_sums_collisions_and_drops_zeros():
    out = FeatureHasher(1, input_type="pair",
                        alternate_sign=False).transform(
        [[("a", 2.0), ("b", 0.5), ("c", 0.0)], []])
    np.testing.assert_array_equal(out.numpy(), [[2.5], [0.0]])
    empty = FeatureHasher(8).transform([{}, {}])
    assert empty.shape == (2, 8) and not bool(empty.any())


def test_hasher_validates_its_parameters_and_tokens():
    with pytest.raises(ValueError, match="n_features"):
        FeatureHasher(0).fit()
    with pytest.raises(ValueError, match="input_type"):
        FeatureHasher(8, input_type="list").transform([[]])
    with pytest.raises(TypeError, match="feature names"):
        FeatureHasher(8, input_type="pair").transform([[(3, 1.0)]])
    est = FeatureHasher(8, input_type="string")
    np.testing.assert_array_equal(est.fit_transform([["x"]]).numpy(),
                                  est.transform([["x"]]).numpy())


def test_hasher_output_dtype_follows_the_parameter():
    out = FeatureHasher(8, input_type="string", dtype=np.float64).transform(
        [["x", "y"]])
    assert out.dtype == torch.float64
