"""Estimator composition (counterpart of ``sq_learn_tpu/pipeline.py``).

``Pipeline`` chains transformers and a final estimator with the
``name__param`` nested ``get_params``/``set_params`` contract, so CV and
grid search compose with the quantum estimators as the reference
pipelines do. Each step hands the next what it returns: the port's
transformers return tensors on their device, so data uploaded by the
first step stays on the card to the last.
"""

from .base import BaseEstimator, clone


class Pipeline(BaseEstimator):
    """Chain of (name, transformer) steps with a final estimator."""

    def __init__(self, steps):
        self.steps = steps
        names = [n for n, _ in steps]
        if len(set(names)) != len(names):
            raise ValueError(f"step names must be unique, got {names}")

    # -- params ---------------------------------------------------------------

    def get_params(self, deep=True):
        out = {"steps": self.steps}
        if deep:
            for name, est in self.steps:
                out[name] = est
                if est is not None and hasattr(est, "get_params"):
                    for k, v in est.get_params(deep=True).items():
                        out[f"{name}__{k}"] = v
        return out

    def set_params(self, **params):
        if "steps" in params:
            self.steps = params.pop("steps")
        step_map = dict(self.steps)
        nested = {}
        for key, value in params.items():
            name, delim, sub = key.partition("__")
            if not delim:
                if name not in step_map:
                    raise ValueError(f"invalid parameter {name!r}")
                self.steps = [
                    (n, value if n == name else e) for n, e in self.steps]
            else:
                nested.setdefault(name, {})[sub] = value
        for name, sub_params in nested.items():
            dict(self.steps)[name].set_params(**sub_params)
        return self

    # -- fitting --------------------------------------------------------------

    @property
    def named_steps(self):
        return dict(self.steps)

    def _fit_transforms(self, X, y, **fit_params):
        for name, est in self.steps[:-1]:
            if est is None or est == "passthrough":
                continue
            if hasattr(est, "fit_transform"):
                X = est.fit_transform(X, y)
            else:
                X = est.fit(X, y).transform(X)
        return X

    def fit(self, X, y=None, **fit_params):
        Xt = self._fit_transforms(X, y)
        name, final = self.steps[-1]
        if y is None:
            final.fit(Xt, **fit_params)
        else:
            final.fit(Xt, y, **fit_params)
        return self

    def _transform_only(self, X):
        for name, est in self.steps[:-1]:
            if est is None or est == "passthrough":
                continue
            X = est.transform(X)
        return X

    def transform(self, X):
        Xt = self._transform_only(X)
        return self.steps[-1][1].transform(Xt)

    def fit_transform(self, X, y=None, **fit_params):
        Xt = self._fit_transforms(X, y)
        name, final = self.steps[-1]
        if hasattr(final, "fit_transform"):
            return final.fit_transform(Xt, y, **fit_params)
        return final.fit(Xt, y, **fit_params).transform(Xt)

    def predict(self, X, **predict_params):
        return self.steps[-1][1].predict(
            self._transform_only(X), **predict_params)

    def predict_proba(self, X):
        return self.steps[-1][1].predict_proba(self._transform_only(X))

    def fit_predict(self, X, y=None, **fit_params):
        Xt = self._fit_transforms(X, y)
        return self.steps[-1][1].fit_predict(Xt, y)

    def score(self, X, y=None):
        Xt = self._transform_only(X)
        if y is None:
            return self.steps[-1][1].score(Xt)
        return self.steps[-1][1].score(Xt, y)


def make_pipeline(*steps):
    """Build a Pipeline with auto-generated lowercase step names."""
    names = []
    for est in steps:
        base = type(est).__name__.lower()
        name = base
        i = 1
        while name in names:
            i += 1
            name = f"{base}-{i}"
        names.append(name)
    return Pipeline(list(zip(names, steps)))
