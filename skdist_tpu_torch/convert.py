"""Carry a fitted model from the JAX package into the port.

``forest_from_reference`` turns a fitted JAX forest or single tree into
the port's (below); ``ridge_from_reference`` does the same for a fitted
``Ridge``, ``LinearRegression`` or ``RidgeClassifier``.
``logistic_regression_from_reference`` takes the
fitted state of a JAX ``skdist_tpu`` ``LogisticRegression`` as plain
numpy (its ``_params`` and ``_meta``) and returns a fitted port
``LogisticRegression`` that computes the same ``decision_function`` and
``predict_proba``: the counterpart of ``_set_fitted`` in
``skdist_tpu/models/linear.py``. The
two packages share the weight layout (``W`` is ``(p,)`` binary or
``(p, k)``, rows ``[:d]`` the coefficients and row ``d`` the intercept
when fitted), so nothing is reshaped. Carrying weights the other way
waits for a later slice.
"""

import numpy as np

from .base import BaseEstimator
from .models import linear
from .models.linear import LogisticRegression

__all__ = ["forest_from_reference", "logistic_regression_from_reference",
           "ridge_from_reference"]

_TREE_KEYS = ("feat", "thr", "is_split", "leaf", "gain")


def logistic_regression_from_reference(params, meta, device=None):
    """A fitted port ``LogisticRegression`` from the JAX package's
    ``params`` (``{"W": ..., "n_iter": ...}``) and ``meta``
    (``classes``, ``n_features``, ``n_classes``; ``cw_arr`` optional)."""
    W = np.asarray(params["W"], dtype=np.float32)
    d = int(meta["n_features"])
    n_classes = int(meta["n_classes"])
    classes = np.asarray(meta["classes"])
    if len(classes) != n_classes:
        raise ValueError(
            f"meta has {len(classes)} classes but n_classes={n_classes}"
        )
    want_ndim = 1 if n_classes <= 2 else 2
    if W.ndim != want_ndim or (want_ndim == 2 and W.shape[1] != n_classes):
        raise ValueError(
            f"W of shape {W.shape} does not fit {n_classes} classes"
        )
    if W.shape[0] not in (d, d + 1):
        raise ValueError(
            f"W has {W.shape[0]} rows; expected {d} or {d + 1} for "
            f"{d} features"
        )
    est = LogisticRegression(fit_intercept=W.shape[0] == d + 1,
                             device=device)
    fitted = {"W": W}
    if "n_iter" in params:
        fitted["n_iter"] = np.asarray(params["n_iter"])
    est._set_fitted(fitted, {
        "n_features": d,
        "classes": classes,
        "n_classes": n_classes,
        "cw_arr": meta.get("cw_arr"),
        "x_format": meta.get("x_format", "dense"),
    })
    return est


def ridge_from_reference(ref, device=None):
    """A fitted port ``Ridge``, ``LinearRegression`` or
    ``RidgeClassifier`` from a fitted JAX one. Only its attributes are
    read: the class name, its parameters, ``_params["W"]`` and
    ``_meta`` (``n_features``; ``y_ndim`` for a regressor, ``classes``,
    ``n_classes`` and ``cw_arr`` for the classifier). The two packages
    share the weight layout, so the port's ``decision_function`` and
    ``predict`` then equal the JAX package's."""
    name = type(ref).__name__
    if name not in ("Ridge", "LinearRegression", "RidgeClassifier"):
        raise ValueError(f"{name} is not of the ridge family")
    if not hasattr(ref, "_params"):
        raise ValueError(f"{name} is not fitted")
    cls = getattr(linear, name)
    names = cls._get_param_names()
    est = cls(**{k: v for k, v in ref.get_params(deep=False).items()
                 if k in names and k != "device"}, device=device)
    W = np.asarray(ref._params["W"], dtype=np.float32)
    d = int(ref._meta["n_features"])
    if W.shape[0] != d + int(bool(est.fit_intercept)):
        raise ValueError(f"W has {W.shape[0]} rows for {d} features")
    meta = {"n_features": d,
            "x_format": ref._meta.get("x_format", "dense")}
    if name == "RidgeClassifier":
        classes = np.asarray(ref._meta["classes"])
        meta.update(classes=classes, n_classes=len(classes),
                    cw_arr=ref._meta.get("cw_arr"))
    else:
        meta.update(y_ndim=W.ndim, n_targets=1 if W.ndim == 1 else W.shape[1])
    est._set_fitted({"W": W}, meta)
    return est


def _port_class(name):
    """The port's estimator class of the JAX package's class ``name``."""
    from .distribute import ensemble
    from .models import forest, tree

    for module in (ensemble, forest, tree):
        cls = getattr(module, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseEstimator):
            return cls
    raise ValueError(f"{name} has no counterpart in the port")


def forest_from_reference(ref, device=None):
    """A fitted port forest (or single tree) from a fitted JAX one.

    ``ref`` is a fitted estimator of the JAX package's forests
    (``RandomForest*``, ``ExtraTrees*``, ``RandomTreesEmbedding`` and
    their ``Dist*`` wrappers) or trees (``DecisionTree*``,
    ``ExtraTree*``); only its attributes are read: a forest's ``_trees``
    (``feat/thr/is_split/leaf/gain/seed`` as numpy), ``_edges``,
    ``classes_``, ``n_features_in_`` and its parameters, or a tree's
    ``_params`` and ``_meta``. The port's ``predict``/``predict_proba``
    and ``apply`` then equal the JAX package's.

    The JAX trees drew their bootstrap with ``jax.random``, which the
    port does not reproduce: the converted forest records how many of
    its trees did so and refuses to compute out-of-bag scores over them
    (``oob_score=True`` refits and warm starts raise) rather than score
    with masks the port would draw for those seeds.
    """
    cls = _port_class(type(ref).__name__)
    names = cls._get_param_names()
    params = {k: v for k, v in ref.get_params(deep=False).items()
              if k in names and k not in ("backend", "device")}
    est = cls(**params, device=device)
    if hasattr(ref, "_trees"):  # a forest
        trees = {k: np.array(ref._trees[k]) for k in _TREE_KEYS + ("seed",)}
        est._trees = trees
        est._edges = np.asarray(ref._edges, np.float32)
        est.n_features_in_ = int(ref.n_features_in_)
        if hasattr(ref, "classes_"):
            est.classes_ = np.asarray(ref.classes_)
        if hasattr(ref, "_n_nodes"):
            est._n_nodes = int(ref._n_nodes)
        est._foreign_seeds = int(trees["feat"].shape[0])
        return est
    if not hasattr(ref, "_params"):
        raise ValueError(f"{type(ref).__name__} is not fitted")
    est._params = {k: np.array(ref._params[k]) for k in _TREE_KEYS}
    est._params["edges"] = np.asarray(ref._params["edges"], np.float32)
    est._meta = {"n_features": int(ref._meta["n_features"])}
    est.n_features_in_ = int(ref.n_features_in_)
    if hasattr(ref, "classes_"):
        est.classes_ = np.asarray(ref.classes_)
        est._meta.update(classes=est.classes_, n_classes=len(est.classes_))
    return est
