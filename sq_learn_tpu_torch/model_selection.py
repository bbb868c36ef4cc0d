"""Model selection: CV splitters, cross-validation and grid search
(counterpart of ``sq_learn_tpu/model_selection.py``).

The slice the MNIST pipeline uses (``MnistTrial.py:20-22`` runs
``cross_validate(KNN, ..., cv=StratifiedKFold(10))``): ``KFold``,
``StratifiedKFold``, ``train_test_split``, ``cross_validate`` and
``cross_val_score``, and the exhaustive ``GridSearchCV`` over a
``ParameterGrid``. They are host-side numpy index bookkeeping; each fold's
estimator computes on the device it is configured for. ``n_jobs`` fans the
folds out over a thread pool, and every worker thread runs under the
caller's thread-local config, so the folds compute on the caller's device.
"""

import itertools
import math
import numbers
import os
import time
import warnings

import numpy as np
import torch

from .base import clone
from .utils.random import check_random_state
from .utils.validation import to_numpy as _host


class KFold:
    """K-fold splitter (reference ``model_selection/_split.py`` semantics)."""

    def __init__(self, n_splits=5, *, shuffle=False, random_state=None):
        if n_splits < 2:
            raise ValueError(f"n_splits must be >= 2, got {n_splits}")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def split(self, X, y=None, groups=None):
        n = len(X)
        indices = np.arange(n)
        if self.shuffle:
            check_random_state(self.random_state).shuffle(indices)
        fold_sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        fold_sizes[: n % self.n_splits] += 1
        current = 0
        for size in fold_sizes:
            test = indices[current:current + size]
            train = np.concatenate(
                [indices[:current], indices[current + size:]])
            yield train, test
            current += size


class StratifiedKFold(KFold):
    """Stratified K-fold: folds preserve class proportions (the splitter of
    the reference MNIST pipeline, ``MnistTrial.py:21``)."""

    def split(self, X, y, groups=None):
        """Split semantics of the reference splitter
        (``model_selection/_split.py:643`` ``_make_test_folds``) in closed
        form: classes, numbered by first appearance, are laid out in
        contiguous blocks (class c from offset a_c) and fold i of S takes
        the block positions congruent to i mod S, so fold i receives
        ceil((count_c − o_ic) / S) members of class c with
        o_ic = (i − a_c) mod S. Per-fold class counts and fold sizes then
        both differ by at most one."""
        y = _host(y)
        n = len(y)
        rng = check_random_state(self.random_state)
        S = self.n_splits
        classes, y_lex = np.unique(y, return_inverse=True)
        y_lex = y_lex.ravel()
        n_classes = len(classes)
        first_pos = np.full(n_classes, n)
        np.minimum.at(first_pos, y_lex, np.arange(n))
        appearance_rank = np.argsort(np.argsort(first_pos))
        y_enc = appearance_rank[y_lex]
        y_counts = np.bincount(y_enc, minlength=n_classes)
        if y_counts.max() < S:
            raise ValueError(
                f"n_splits={S} exceeds the number of members in each "
                "class of y.")
        if y_counts.min() < S:
            warnings.warn(
                f"The least populated class in y has only "
                f"{int(y_counts.min())} members, fewer than "
                f"n_splits={S}.", UserWarning)
        block_starts = np.concatenate([[0], np.cumsum(y_counts)[:-1]])
        phase = (np.arange(S)[:, None] - block_starts[None, :]) % S
        # ceil((count - phase) / S), clamped at 0, via floor division
        allocation = -((phase - y_counts[None, :]) // S)
        fold_of = np.empty(n, dtype=int)
        for c in range(n_classes):
            idx = np.flatnonzero(y_enc == c)
            if self.shuffle:
                rng.shuffle(idx)
            fold_of[idx] = np.repeat(np.arange(S), allocation[:, c])
        indices = np.arange(n)
        for f in range(S):
            yield indices[fold_of != f], indices[fold_of == f]


def train_test_split(*arrays, test_size=None, train_size=None,
                     random_state=None, shuffle=True, stratify=None):
    """Split arrays into random train and test subsets (reference
    ``model_selection/_split.py`` ``train_test_split`` semantics). Tensors
    are indexed where they lie; anything else comes back as numpy."""
    n = len(arrays[0])
    if test_size is None and train_size is None:
        test_size = 0.25
    if isinstance(test_size, float):
        n_test = int(np.ceil(n * test_size))
    elif isinstance(test_size, numbers.Integral):
        n_test = int(test_size)
    else:
        n_test = n - (int(np.floor(n * train_size))
                      if isinstance(train_size, float) else int(train_size))
    n_train = n - n_test

    rng = check_random_state(random_state)
    if stratify is not None:
        stratify = _host(stratify)
        test_idx = []
        for cls in np.unique(stratify):
            idx = np.flatnonzero(stratify == cls)
            if shuffle:
                rng.shuffle(idx)
            k = int(round(len(idx) * n_test / n))
            test_idx.append(idx[:k])
        mask = np.zeros(n, dtype=bool)
        mask[np.concatenate(test_idx)] = True
        train_idx = np.flatnonzero(~mask)
        test_idx = np.flatnonzero(mask)
        if shuffle:
            rng.shuffle(train_idx)
            rng.shuffle(test_idx)
    elif shuffle:
        perm = rng.permutation(n)
        test_idx, train_idx = perm[:n_test], perm[n_test:]
    else:
        train_idx = np.arange(n_train)
        test_idx = np.arange(n_train, n)

    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            tr = torch.as_tensor(train_idx, device=a.device)
            te = torch.as_tensor(test_idx, device=a.device)
            out.extend([a[tr], a[te]])
        else:
            a = np.asarray(a)
            out.extend([a[train_idx], a[test_idx]])
    return out


def _score(estimator, X, y, scoring):
    if callable(scoring):
        return float(scoring(estimator, X, y))
    if scoring in (None, "accuracy"):
        return float(estimator.score(X, y))
    if scoring == "adjusted_rand_score":
        from .metrics import adjusted_rand_score

        return float(adjusted_rand_score(y, estimator.fit_predict(X)))
    raise ValueError(f"unknown scoring {scoring!r}")


def _resolve_n_jobs(n_jobs, n_tasks):
    """joblib-style ``n_jobs``: None/1 → serial, -1 → all cores, negative
    k → cores+1+k, capped by the task count."""
    if n_jobs is None:
        return 1
    n_jobs = int(n_jobs)
    if n_jobs == 0:
        raise ValueError("n_jobs == 0 has no meaning (joblib semantics)")
    if n_jobs < 0:
        n_jobs = max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    return max(1, min(n_jobs, n_tasks))


def cross_validate(estimator, X, y=None, *, cv=5, scoring=None, n_jobs=None,
                   return_train_score=False, fit_params=None):
    """Evaluate by cross-validation (reference ``cross_validate``, used at
    ``MnistTrial.py:22`` with ``n_jobs=4``): a clone of ``estimator`` is
    fitted on each fold's training rows and scored on its test rows.
    Returns numpy arrays ``fit_time``, ``score_time``, ``test_score`` (and
    ``train_score``)."""
    X = _host(X)
    if isinstance(cv, numbers.Integral):
        # sklearn semantics: an int cv stratifies for classifiers
        if (y is not None
                and getattr(estimator, "_estimator_type", "") == "classifier"):
            cv = StratifiedKFold(n_splits=int(cv))
        else:
            cv = KFold(n_splits=int(cv))
    fit_params = fit_params or {}
    y_arr = None if y is None else _host(y)

    def one_fold(train, test):
        est = clone(estimator)
        y_tr = None if y_arr is None else y_arr[train]
        y_te = None if y_arr is None else y_arr[test]
        t0 = time.perf_counter()
        if y_tr is None:
            est.fit(X[train], **fit_params)
        else:
            est.fit(X[train], y_tr, **fit_params)
        t1 = time.perf_counter()
        test_score = _score(est, X[test], y_te, scoring)
        t2 = time.perf_counter()
        train_score = (_score(est, X[train], y_tr, scoring)
                       if return_train_score else None)
        return t1 - t0, t2 - t1, test_score, train_score

    folds = list(cv.split(X, y_arr))
    n_workers = _resolve_n_jobs(n_jobs, len(folds))
    if n_workers == 1:
        fold_results = [one_fold(tr, te) for tr, te in folds]
    else:
        from concurrent.futures import ThreadPoolExecutor

        from ._config import _get_threadlocal_config

        caller_config = _get_threadlocal_config().copy()

        def with_config(args):
            # a worker thread starts from the global defaults: run it under
            # the caller's config instead
            _get_threadlocal_config().update(caller_config)
            return one_fold(*args)

        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            fold_results = list(pool.map(with_config, folds))

    results = {
        "fit_time": [r[0] for r in fold_results],
        "score_time": [r[1] for r in fold_results],
        "test_score": [r[2] for r in fold_results],
    }
    if return_train_score:
        results["train_score"] = [r[3] for r in fold_results]
    return {k: np.asarray(v) for k, v in results.items()}


def cross_val_score(estimator, X, y=None, *, cv=5, scoring=None, n_jobs=None):
    """The ``test_score`` of :func:`cross_validate`."""
    return cross_validate(estimator, X, y, cv=cv, scoring=scoring,
                          n_jobs=n_jobs)["test_score"]


class ParameterGrid:
    """Every combination of a parameter grid (a dict or a list of dicts):
    keys in sorted order, values in ``itertools.product`` order."""

    def __init__(self, param_grid):
        if isinstance(param_grid, dict):
            param_grid = [param_grid]
        self.param_grid = param_grid

    def __iter__(self):
        for grid in self.param_grid:
            keys = sorted(grid)
            for values in itertools.product(*(grid[k] for k in keys)):
                yield dict(zip(keys, values))

    def __len__(self):
        return sum(math.prod(len(v) for v in grid.values()) or 1
                   for grid in self.param_grid)


class GridSearchCV:
    """Exhaustive search over a parameter grid by cross-validation: fit
    sets ``cv_results_`` (``params``, ``mean_test_score``,
    ``split_test_scores``), ``best_params_`` and ``best_score_`` (the first
    of tied means in grid order) and, with ``refit``, ``best_estimator_``
    fitted on all of X."""

    def __init__(self, estimator, param_grid, *, cv=5, scoring=None,
                 n_jobs=None, refit=True):
        self.estimator = estimator
        self.param_grid = param_grid
        self.cv = cv
        self.scoring = scoring
        self.n_jobs = n_jobs
        self.refit = refit

    def fit(self, X, y=None, **fit_params):
        grid = list(ParameterGrid(self.param_grid))
        all_scores = [
            cross_val_score(clone(self.estimator).set_params(**params), X, y,
                            cv=self.cv, scoring=self.scoring,
                            n_jobs=self.n_jobs)
            for params in grid]
        mean_scores = [float(np.mean(s)) for s in all_scores]
        best = int(np.argmax(mean_scores))
        self.best_params_ = grid[best]
        self.best_score_ = mean_scores[best]
        self.cv_results_ = {
            "params": grid,
            "mean_test_score": np.asarray(mean_scores),
            "split_test_scores": np.asarray(all_scores),
        }
        if self.refit:
            self.best_estimator_ = clone(self.estimator).set_params(
                **self.best_params_)
            if y is None:
                self.best_estimator_.fit(X, **fit_params)
            else:
                self.best_estimator_.fit(X, y, **fit_params)
        return self

    def predict(self, X):
        return self.best_estimator_.predict(X)

    def score(self, X, y=None):
        return _score(self.best_estimator_, X, y, self.scoring)
