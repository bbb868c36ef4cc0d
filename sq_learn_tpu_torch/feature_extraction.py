"""Feature hashing, the hashing trick (counterpart of
``sq_learn_tpu/feature_extraction.py``) on the port's numpy MurmurHash3
(:mod:`~sq_learn_tpu_torch.utils.murmurhash`).

The column of a token is ``abs(h) % n_features`` with ``h`` its signed
32-bit hash, and with ``alternate_sign`` the value takes the sign of
``h``: sklearn's rule (``_hashing_fast.pyx``). The JAX package takes the
column from the unsigned hash instead, which moves every token whose
signed hash is negative to another column unless the two coincide
(ROADMAP.md §3). Tokens are hashed and their values summed per (row,
column) on the host in a fixed order; only the nonzero entries are
uploaded and scattered into a dense tensor on the estimator's device.
"""

import numbers

import numpy as np
import torch

from ._config import resolve_device
from .base import BaseEstimator, TransformerMixin
from .utils.murmurhash import murmurhash3_32


class FeatureHasher(TransformerMixin, BaseEstimator):
    """Hash string or (token, value) features into a dense
    (n_samples, n_features) tensor on ``device`` (None = the configured
    one).

    ``input_type='dict'`` takes mappings {feature_name: value}, ``'pair'``
    iterables of (token, value) and ``'string'`` token iterables with
    value 1. A string value hashes ``"name=value"`` with value 1, and
    zero values are dropped. Sparse output is not ported (the JAX package
    has none either).
    """

    def __init__(self, n_features=1024, *, input_type="dict",
                 dtype=np.float32, alternate_sign=True, device=None):
        self.n_features = n_features
        self.input_type = input_type
        self.dtype = dtype
        self.alternate_sign = alternate_sign
        self.device = device

    def fit(self, X=None, y=None):
        if not isinstance(self.n_features, numbers.Integral) or \
                self.n_features < 1:
            raise ValueError(
                f"n_features must be a positive integer, got "
                f"{self.n_features!r}")
        if self.input_type not in ("dict", "pair", "string"):
            raise ValueError(
                f"input_type must be 'dict', 'pair' or 'string', got "
                f"{self.input_type!r}")
        return self

    def _entries(self, rows):
        """(tokens, values, row indices) of every nonzero feature."""
        tokens, values, row_idx = [], [], []
        for i, row in enumerate(rows):
            if self.input_type == "dict":
                items = row.items()
            elif self.input_type == "pair":
                items = row
            else:
                items = ((tok, 1.0) for tok in row)
            for tok, val in items:
                if isinstance(val, str):
                    tok, val = f"{tok}={val}", 1.0
                if not isinstance(tok, (str, bytes)):
                    raise TypeError(
                        f"feature names must be str or bytes, got "
                        f"{type(tok).__name__}")
                if val == 0:
                    continue
                tokens.append(tok)
                values.append(float(val))
                row_idx.append(i)
        return tokens, values, row_idx

    def transform(self, raw_X):
        self.fit()
        rows = list(raw_X)
        dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        out = torch.zeros((len(rows), self.n_features), dtype=dtype,
                          device=resolve_device(self.device))
        tokens, values, row_idx = self._entries(rows)
        if not tokens:
            return out
        h = murmurhash3_32(tokens).view(np.int32).astype(np.int64)
        cols = np.abs(h) % self.n_features
        vals = np.asarray(values, np.float64)
        if self.alternate_sign:
            vals = np.where(h < 0, -vals, vals)
        flat = np.asarray(row_idx, np.int64) * self.n_features + cols
        keys, inverse = np.unique(flat, return_inverse=True)
        sums = np.bincount(inverse, weights=vals, minlength=len(keys))
        out.view(-1)[torch.from_numpy(keys).to(out.device)] = \
            torch.from_numpy(sums).to(device=out.device, dtype=dtype)
        return out

    def fit_transform(self, X, y=None):
        return self.transform(X)


__all__ = ["FeatureHasher"]
