"""
Estimator base protocol and backend-aware cloning: a copy of
``skdist_tpu/base.py``'s ``BaseEstimator``, ``ClassifierMixin``,
``RegressorMixin``, ``TransformerMixin``, ``clone`` and
``strip_runtime`` (the scores use the port's own metrics, not
scikit-learn's).

The "cluster handle" is a :class:`skdist_tpu_torch.parallel.TaskBackend`,
which must never be deep-copied or pickled into a fitted artifact.
"""

import copy
import inspect
from collections import defaultdict

import numpy as np

# Constructor attribute names that hold live runtime handles. They are
# excluded from deep-copy during clone and stripped after fit so fitted
# estimators stay picklable.
_RUNTIME_ATTRS = ("backend", "sc", "mesh")


class BaseEstimator:
    """sklearn-protocol base: introspective ``get_params``/``set_params``.
    Parameters are the constructor arguments; fitted state is attributes
    with trailing underscores."""

    @classmethod
    def _get_param_names(cls):
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        names = [
            p.name
            for p in sig.parameters.values()
            if p.name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]
        return sorted(names)

    def get_params(self, deep=True):
        out = {}
        for key in self._get_param_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params") and not isinstance(
                    value, type):
                for sub_key, sub_value in value.get_params(deep=True).items():
                    out[f"{key}__{sub_key}"] = sub_value
            out[key] = value
        return out

    def set_params(self, **params):
        if not params:
            return self
        valid = set(self._get_param_names())
        nested = defaultdict(dict)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator {self!r}. "
                    f"Valid parameters are: {sorted(valid)}."
                )
            if delim:
                nested[key][sub_key] = value
            else:
                setattr(self, key, value)
        for key, sub_params in nested.items():
            getattr(self, key).set_params(**sub_params)
        return self

    def __repr__(self):
        params = ", ".join(
            f"{k}={getattr(self, k, None)!r}"
            for k in self._get_param_names()
            if not isinstance(getattr(self, k, None), np.ndarray)
        )
        return f"{type(self).__name__}({params})"


class ClassifierMixin:
    _estimator_type = "classifier"

    def score(self, X, y, sample_weight=None):
        """Mean accuracy of ``predict(X)`` against ``y``."""
        from .metrics import accuracy_score

        return accuracy_score(y, self.predict(X), sample_weight=sample_weight)


class RegressorMixin:
    _estimator_type = "regressor"

    def score(self, X, y, sample_weight=None):
        """R^2 of ``predict(X)`` against ``y``."""
        from .metrics import r2_score

        return r2_score(y, self.predict(X), sample_weight=sample_weight)


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)


def clone(estimator, safe=True):
    """Backend-aware clone: an unfitted copy with the same parameters.
    Runtime handles (``backend``/``sc``/``mesh`` constructor params) are
    carried over by reference, never deep-copied."""
    if estimator is None:
        return None
    if isinstance(estimator, (list, tuple)):
        return type(estimator)(clone(e, safe=safe) for e in estimator)
    if not hasattr(estimator, "get_params"):
        if not safe:
            return copy.deepcopy(estimator)
        raise TypeError(
            f"Cannot clone object {estimator!r}: it does not implement "
            "get_params."
        )
    params = estimator.get_params(deep=False)
    handles = {}
    for name in _RUNTIME_ATTRS:
        if name in params:
            handles[name] = params.pop(name)
    new_params = {}
    for name, value in params.items():
        if hasattr(value, "get_params") and not isinstance(value, type):
            new_params[name] = clone(value, safe=safe)
        else:
            new_params[name] = copy.deepcopy(value)
    new_params.update(handles)
    new_object = type(estimator)(**new_params)
    check_params = new_object.get_params(deep=False)
    for name in params:
        if check_params[name] is not new_params[name] and not isinstance(
            new_params[name], (int, float, str, bool, type(None))
        ):
            raise RuntimeError(
                f"Cannot clone {estimator!r}: constructor does not set "
                f"parameter {name!r} verbatim."
            )
    return new_object


def strip_runtime(estimator):
    """Remove live runtime handles post-fit so the artifact pickles clean.
    Recurses into nested estimators."""
    if estimator is None or not hasattr(estimator, "get_params"):
        return estimator
    for name in _RUNTIME_ATTRS:
        if hasattr(estimator, name) and getattr(estimator, name) is not None:
            try:
                setattr(estimator, name, None)
            except AttributeError:
                pass
    for value in vars(estimator).values():
        if hasattr(value, "get_params"):
            strip_runtime(value)
        elif isinstance(value, (list, tuple)):
            for item in value:
                if hasattr(item, "get_params"):
                    strip_runtime(item)
    return estimator
