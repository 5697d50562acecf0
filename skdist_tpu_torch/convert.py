"""Carry a fitted model from the JAX package into the port.

``forest_from_reference`` turns a fitted JAX forest or single tree into
the port's (below), and ``tree_from_reference`` a single tree; ``ridge_from_reference`` does the same for a fitted
``Ridge``, ``LinearRegression`` or ``RidgeClassifier``, and
``multiclass_from_reference`` for a fitted ``DistOneVsRestClassifier``
or ``DistOneVsOneClassifier`` (each binary estimator converted),
``gbdt_from_reference`` for a fitted ``DistHistGradientBoosting*`` (its
tree bank) and ``naive_bayes_from_reference`` for a fitted
``GaussianNB`` or ``MultinomialNB``; ``eliminator_from_reference`` for
a fitted ``DistFeatureEliminator`` and ``voter_from_reference`` for a
``SimpleVoter``, whose inner models go through
``model_from_reference``, the converter of any of these by its class.
``logistic_regression_from_reference``, ``linear_svc_from_reference``
and ``sgd_from_reference`` take the fitted state of a JAX ``skdist_tpu``
``LogisticRegression``, ``LinearSVC`` or ``SGDClassifier`` as plain
numpy (its ``_params`` and ``_meta``) and return the fitted port model, which computes the same
``decision_function`` and ``predict_proba``: the counterpart of
``_set_fitted`` in ``skdist_tpu/models/linear.py``. The
two packages share the weight layout (``W`` is ``(p,)`` binary or
``(p, k)``, rows ``[:d]`` the coefficients and row ``d`` the intercept
when fitted), so nothing is reshaped. Carrying weights the other way
waits for a later slice.
"""

import numpy as np

from .base import BaseEstimator
from .distribute import multiclass
from .models import linear
from .models.linear import LinearSVC, LogisticRegression, SGDClassifier

__all__ = ["eliminator_from_reference", "forest_from_reference",
           "gbdt_from_reference", "linear_svc_from_reference",
           "logistic_regression_from_reference", "model_from_reference",
           "multiclass_from_reference", "naive_bayes_from_reference",
           "ridge_from_reference", "sgd_from_reference",
           "tree_from_reference", "voter_from_reference"]

_TREE_KEYS = ("feat", "thr", "is_split", "leaf", "gain")


def logistic_regression_from_reference(params, meta, device=None):
    """A fitted port ``LogisticRegression`` from the JAX package's
    ``params`` (``{"W": ..., "n_iter": ...}``) and ``meta``
    (``classes``, ``n_features``, ``n_classes``; ``cw_arr`` optional)."""
    return _linear_classifier_from_reference(LogisticRegression, params,
                                             meta, device)


def sgd_from_reference(params, meta, device=None, **est_params):
    """A fitted port ``SGDClassifier`` from the JAX package's ``params``
    and ``meta``, as :func:`logistic_regression_from_reference`;
    ``est_params`` are the model's constructor arguments (``loss``
    decides whether ``predict_proba`` is available)."""
    return _linear_classifier_from_reference(SGDClassifier, params, meta,
                                             device, **est_params)


def linear_svc_from_reference(params, meta, device=None, **est_params):
    """A fitted port ``LinearSVC`` from the JAX package's ``params`` and
    ``meta``, as :func:`logistic_regression_from_reference`."""
    return _linear_classifier_from_reference(LinearSVC, params, meta, device,
                                             **est_params)


def _linear_classifier_from_reference(cls, params, meta, device,
                                      **est_params):
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
    est = cls(**{**est_params, "fit_intercept": W.shape[0] == d + 1,
                 "device": device})
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
    return _fitted_tree(est, ref)


def tree_from_reference(ref, device=None):
    """A fitted port tree from a fitted JAX ``DecisionTree*`` or
    ``ExtraTree*``, as :func:`forest_from_reference` builds a forest:
    its parameters, ``_params`` (the nodes and bin edges) and ``_meta``.
    The port's ``predict``, ``predict_proba``, ``apply`` and its predict
    plan then compute the JAX tree's."""
    cls = _port_class(type(ref).__name__)
    if hasattr(ref, "_trees") or not hasattr(cls, "_build_decision_kernel"):
        raise ValueError(f"{type(ref).__name__} is not a single tree")
    names = cls._get_param_names()
    params = {k: v for k, v in ref.get_params(deep=False).items()
              if k in names and k not in ("backend", "device")}
    return _fitted_tree(cls(**params, device=device), ref)


def _fitted_tree(est, ref):
    """``est`` (a port tree) given the fitted state of the JAX tree
    ``ref``."""
    if not hasattr(ref, "_params"):
        raise ValueError(f"{type(ref).__name__} is not fitted")
    est._params = {k: np.array(ref._params[k]) for k in _TREE_KEYS}
    est._params["edges"] = np.array(ref._params["edges"], np.float32)
    est._meta = {"n_features": int(ref._meta["n_features"])}
    est.n_features_in_ = int(ref.n_features_in_)
    if hasattr(ref, "classes_"):
        est.classes_ = np.asarray(ref.classes_)
        est._meta.update(classes=est.classes_, n_classes=len(est.classes_))
    return est


#: the JAX package's linear classifiers that a multiclass model may hold
_LINEAR_CLASSIFIERS = {"LogisticRegression": LogisticRegression,
                       "LinearSVC": LinearSVC, "SGDClassifier": SGDClassifier}


def _port_params(cls, ref):
    """``ref``'s constructor parameters that ``cls`` takes, but the
    runtime ones (``backend``, ``device``) and nested estimators."""
    names = cls._get_param_names()
    return {k: v for k, v in ref.get_params(deep=False).items()
            if k in names and k not in ("backend", "device", "estimator",
                                        "fit_intercept")}


def _binary_from_reference(ref, device):
    """The port's counterpart of one fitted binary estimator of a JAX
    multiclass model."""
    name = type(ref).__name__
    if name == "_ConstantPredictor":
        out = multiclass._ConstantPredictor()
        out.y_ = np.asarray(ref.y_)
        return out
    if name in _LINEAR_CLASSIFIERS:
        cls = _LINEAR_CLASSIFIERS[name]
        return _linear_classifier_from_reference(
            cls, ref._params, ref._meta, device, **_port_params(cls, ref))
    raise ValueError(f"{name} inside a multiclass model has no converter")


def multiclass_from_reference(ref, device=None):
    """A fitted port ``DistOneVsRestClassifier`` or
    ``DistOneVsOneClassifier`` from a fitted JAX one: every entry of
    ``estimators_`` (``LogisticRegression``, ``LinearSVC``,
    ``SGDClassifier`` or the constant-column fallback) is converted, and
    ``classes_``, ``pairs_``, ``binary_``, ``multilabel_`` and the
    parameters (``norm`` among them) are copied; the template estimator
    becomes the port's class with the same parameters."""
    name = type(ref).__name__
    if name not in ("DistOneVsRestClassifier", "DistOneVsOneClassifier"):
        raise ValueError(f"{name} is not a multiclass meta-estimator")
    if not hasattr(ref, "estimators_"):
        raise ValueError(f"{name} is not fitted")
    cls = getattr(multiclass, name)
    base = ref.estimator
    base_cls = _LINEAR_CLASSIFIERS.get(type(base).__name__)
    if base_cls is None:
        raise ValueError(
            f"{type(base).__name__} inside a multiclass model has no converter")
    template = base_cls(**_port_params(base_cls, base),
                        fit_intercept=base.fit_intercept, device=device)
    est = cls(template, **_port_params(cls, ref))
    est.estimators_ = [_binary_from_reference(e, device)
                       for e in ref.estimators_]
    est.classes_ = np.asarray(ref.classes_)
    for attr in ("pairs_", "binary_", "multilabel_"):
        if hasattr(ref, attr):
            setattr(est, attr, getattr(ref, attr))
    return est


def _fitted_meta(ref, keys):
    """The port's ``_meta`` of a fitted JAX estimator: ``keys`` of its
    ``_meta``, the classes as numpy, dense input."""
    meta = {k: ref._meta[k] for k in keys if k in ref._meta}
    meta["n_features"] = int(ref._meta["n_features"])
    meta["x_format"] = "dense"
    if "classes" in ref._meta:
        meta["classes"] = np.asarray(ref._meta["classes"])
        meta["n_classes"] = len(meta["classes"])
    return meta


def gbdt_from_reference(ref, device=None):
    """A fitted port ``DistHistGradientBoostingClassifier`` or
    ``...Regressor`` from a fitted JAX one: its parameters, its tree bank
    (``_params``: ``feat/thr/is_split/leaf`` ``(max_iter, Kt, N)``,
    ``baseline``, ``n_iter``, ``edges``) and ``_meta``. Both walk the
    same trees over the same bins, so the port's decision, probabilities
    and predictions then equal the JAX model's."""
    from .models import gbdt

    name = type(ref).__name__
    cls = getattr(gbdt, name, None)
    if cls is None or not name.startswith("DistHistGradientBoosting"):
        raise ValueError(f"{name} is not a histogram boosting model")
    if not hasattr(ref, "_params"):
        raise ValueError(f"{name} is not fitted")
    names = cls._get_param_names()
    est = cls(**{k: v for k, v in ref.get_params(deep=False).items()
                 if k in names and k != "device"}, device=device)
    params = {k: np.array(ref._params[k]) for k in
              ("feat", "thr", "is_split", "leaf", "baseline", "n_iter")}
    meta = _fitted_meta(ref, ("n_samples",))
    meta["edges"] = np.array(ref._params["edges"], np.float32)
    return est._set_fitted(params, meta)


def naive_bayes_from_reference(ref, device=None):
    """A fitted port ``GaussianNB`` or ``MultinomialNB`` from a fitted JAX
    one: its parameters, ``_params`` (``gmean/means_c/var/log_prior``, or
    the linear ``W``) and ``_meta``; the port's decision and
    probabilities then equal the JAX model's."""
    from .models import naive_bayes

    name = type(ref).__name__
    if name not in ("GaussianNB", "MultinomialNB"):
        raise ValueError(f"{name} is not a naive Bayes model")
    if not hasattr(ref, "_params"):
        raise ValueError(f"{name} is not fitted")
    cls = getattr(naive_bayes, name)
    names = cls._get_param_names()
    est = cls(**{k: v for k, v in ref.get_params(deep=False).items()
                 if k in names and k != "device"}, device=device)
    params = {k: np.array(v, np.float32) for k, v in ref._params.items()}
    meta = _fitted_meta(ref, ())
    meta["cw_arr"] = None
    est._set_fitted(params, meta)
    return est


_RIDGE_FAMILY = ("Ridge", "LinearRegression", "RidgeClassifier")


def model_from_reference(ref, device=None):
    """The fitted port model of a fitted JAX one, by its class: a linear
    classifier, the ridge family, a tree or forest, a boosting model,
    naive Bayes, a multiclass meta-estimator, a feature eliminator or a
    voter (each through its converter above)."""
    name = type(ref).__name__
    if name in _LINEAR_CLASSIFIERS:
        cls = _LINEAR_CLASSIFIERS[name]
        if not hasattr(ref, "_params"):
            raise ValueError(f"{name} is not fitted")
        return _linear_classifier_from_reference(
            cls, ref._params, ref._meta, device, **_port_params(cls, ref))
    if name in _RIDGE_FAMILY:
        return ridge_from_reference(ref, device)
    if name.startswith("DistHistGradientBoosting"):
        return gbdt_from_reference(ref, device)
    if name in ("GaussianNB", "MultinomialNB"):
        return naive_bayes_from_reference(ref, device)
    if name in ("DistOneVsRestClassifier", "DistOneVsOneClassifier"):
        return multiclass_from_reference(ref, device)
    if name == "DistFeatureEliminator":
        return eliminator_from_reference(ref, device)
    if name == "SimpleVoter":
        return voter_from_reference(ref, device)
    return forest_from_reference(ref, device)


def _template_from_reference(ref, device):
    """An unfitted port estimator of ``ref``'s class with its
    parameters (the runtime ones aside)."""
    from .models import gbdt, naive_bayes

    name = type(ref).__name__
    cls = (_LINEAR_CLASSIFIERS.get(name)
           or (getattr(linear, name) if name in _RIDGE_FAMILY else None)
           or getattr(gbdt, name, None) or getattr(naive_bayes, name, None))
    if not (isinstance(cls, type) and issubclass(cls, BaseEstimator)):
        cls = _port_class(name)
    names = cls._get_param_names()
    return cls(**{k: v for k, v in ref.get_params(deep=False).items()
                  if k in names and k not in ("backend", "device")},
               device=device)


def eliminator_from_reference(ref, device=None):
    """A fitted port ``DistFeatureEliminator`` from a fitted JAX one: its
    parameters (the estimator as the port's class, ``adaptive`` as the
    port's ``HalvingSpec``), ``best_features_``, ``n_features_``,
    ``scores_``, ``best_score_`` and ``rung_``, and the refit
    ``estimator_`` through :func:`model_from_reference`; its
    ``predict`` and ``predict_proba`` then equal the JAX model's."""
    from .distribute.adaptive import HalvingSpec
    from .distribute.eliminate import DistFeatureEliminator

    name = type(ref).__name__
    if name != "DistFeatureEliminator":
        raise ValueError(f"{name} is not a feature eliminator")
    if not hasattr(ref, "estimator_"):
        raise ValueError(f"{name} is not fitted")
    names = DistFeatureEliminator._get_param_names()
    params = {k: v for k, v in ref.get_params(deep=False).items()
              if k in names and k not in ("backend", "estimator", "adaptive")}
    adaptive = (None if ref.adaptive is None
                else HalvingSpec(**ref.adaptive.get_params()))
    est = DistFeatureEliminator(_template_from_reference(ref.estimator,
                                                         device),
                                adaptive=adaptive, **params)
    est.estimator_ = model_from_reference(ref.estimator_, device)
    est.best_features_ = np.array(ref.best_features_)
    est.n_features_ = int(ref.n_features_)
    est.scores_ = np.array(ref.scores_)
    est.best_score_ = float(ref.best_score_)
    if hasattr(ref, "rung_"):
        est.rung_ = np.array(ref.rung_)
    return est


def voter_from_reference(ref, device=None):
    """A port ``SimpleVoter`` from a JAX one: every member through
    :func:`model_from_reference` (a dropped member stays dropped), the
    same classes, voting and weights."""
    from .postprocessing import SimpleVoter, _dropped

    if type(ref).__name__ != "SimpleVoter":
        raise ValueError(f"{type(ref).__name__} is not a SimpleVoter")
    members = [(name, est if _dropped(est)
                else model_from_reference(est, device))
               for name, est in ref.estimators]
    return SimpleVoter(members, classes=np.asarray(ref.classes),
                       voting=ref.voting, weights=ref.weights)
