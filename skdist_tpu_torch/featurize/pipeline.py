"""
``Pipeline``: a copy of scikit-learn's (``sklearn/pipeline.py``) for
the chains featurisation builds: ``fit``, ``transform``,
``fit_transform``, ``named_steps``, and ``get_params(deep=True)`` /
``set_params`` over ``step__param`` names, so that the port's ``clone``
and the searches' generic path take it. Steps may be ``"passthrough"``
or None. No caching (``memory``) and no ``transform_input``.
"""

from ..base import BaseEstimator

__all__ = ["Pipeline"]


class _Bunch(dict):
    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None


def _skipped(step):
    return step is None or (isinstance(step, str) and step == "passthrough")


class Pipeline(BaseEstimator):
    """Steps ``[(name, transformer), ..., (name, estimator)]``, fitted in
    turn: each transformer's ``fit_transform`` feeds the next, the last
    step is fitted on what they produce."""

    def __init__(self, steps, *, transform_input=None, memory=None,
                 verbose=False):
        self.steps = steps
        self.transform_input = transform_input
        self.memory = memory
        self.verbose = verbose

    # ---- parameters ---------------------------------------------------
    def get_params(self, deep=True):
        out = super().get_params(deep=False)
        if not deep:
            return out
        out.update(self.steps)
        for name, est in self.steps:
            if hasattr(est, "get_params"):
                for key, value in est.get_params(deep=True).items():
                    out[f"{name}__{key}"] = value
        return out

    def set_params(self, **params):
        if "steps" in params:
            self.steps = params.pop("steps")
        names = [name for name, _ in self.steps]
        for key in list(params):
            if "__" not in key and key in names:
                i = names.index(key)
                self.steps[i] = (key, params.pop(key))
        own = {k: v for k, v in params.items() if "__" not in k}
        for key, value in own.items():
            if key not in self._get_param_names():
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator {self!r}.")
            setattr(self, key, value)
        for key, value in params.items():
            if "__" not in key:
                continue
            name, sub = key.split("__", 1)
            if name not in names:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator {self!r}.")
            self.steps[names.index(name)][1].set_params(**{sub: value})
        return self

    # ---- fitting --------------------------------------------------------
    @property
    def named_steps(self):
        return _Bunch(self.steps)

    @property
    def _final_estimator(self):
        return self.steps[-1][1]

    def _check(self):
        if self.memory is not None or self.transform_input is not None:
            raise ValueError("memory and transform_input are not ported")
        names = [name for name, _ in self.steps]
        if len(set(names)) != len(names):
            raise ValueError(f"Names provided are not unique: {names!r}")

    def _fit_head(self, X, y, **fit_params):
        self._check()
        for name, est in self.steps[:-1]:
            if _skipped(est):
                continue
            params = {k.split("__", 1)[1]: v for k, v in fit_params.items()
                      if k.startswith(name + "__")}
            if hasattr(est, "fit_transform"):
                X = est.fit_transform(X, y, **params)
            else:
                X = est.fit(X, y, **params).transform(X)
        return X

    def _last_params(self, fit_params):
        name = self.steps[-1][0]
        return {k.split("__", 1)[1]: v for k, v in fit_params.items()
                if k.startswith(name + "__")}

    def fit(self, X, y=None, **fit_params):
        Xt = self._fit_head(X, y, **fit_params)
        if not _skipped(self._final_estimator):
            self._final_estimator.fit(Xt, y, **self._last_params(fit_params))
        return self

    def fit_transform(self, X, y=None, **fit_params):
        Xt = self._fit_head(X, y, **fit_params)
        last = self._final_estimator
        if _skipped(last):
            return Xt
        params = self._last_params(fit_params)
        if hasattr(last, "fit_transform"):
            return last.fit_transform(Xt, y, **params)
        return last.fit(Xt, y, **params).transform(Xt)

    def transform(self, X):
        for _, est in self.steps:
            if not _skipped(est):
                X = est.transform(X)
        return X

    def _head_transform(self, X):
        for _, est in self.steps[:-1]:
            if not _skipped(est):
                X = est.transform(X)
        return X

    def predict(self, X, **params):
        return self._final_estimator.predict(self._head_transform(X),
                                             **params)

    def predict_proba(self, X, **params):
        return self._final_estimator.predict_proba(self._head_transform(X),
                                                   **params)

    def decision_function(self, X):
        return self._final_estimator.decision_function(
            self._head_transform(X))

    def score(self, X, y=None, sample_weight=None):
        kw = {} if sample_weight is None else {"sample_weight": sample_weight}
        return self._final_estimator.score(self._head_transform(X), y, **kw)

    @property
    def classes_(self):
        return self._final_estimator.classes_
