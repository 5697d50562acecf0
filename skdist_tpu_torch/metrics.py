"""
Scoring: the device scorer kernels of the search, batched over tasks.

Counterpart of ``skdist_tpu/metrics.py`` (its device scorers). Each
kernel is ``(y, out, w, meta) -> score`` and runs on the device of its
tensors inside the search round that fitted the models, with CV fold
selection as 0/1 weight masks; no prediction leaves the device.

``out`` is the estimator's raw output for one task (``(n,)`` binary
decision scores, ``(n, k)`` multinomial scores or probabilities, a
regressor's ``(n,)`` predictions) or for a batch of tasks, with a
leading task axis; ``w`` is ``(n,)`` or ``(T, n)`` to match. An output
with one more axis than ``w`` is per-class. The result is a scalar or a
``(T,)`` tensor.

The host scorers (:class:`Scorer`, :func:`check_multimetric_scoring`)
score a fitted estimator's predictions through the same kernels, on the
host in float64, for the generic search path and ``score()``.
"""

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .utils.device import lane_sum

__all__ = [
    "accuracy",
    "f1_weighted",
    "f1_macro",
    "f1_micro",
    "neg_log_loss",
    "roc_auc_binary",
    "r2",
    "neg_mean_squared_error",
    "neg_root_mean_squared_error",
    "neg_mean_absolute_error",
    "DEVICE_SCORERS",
    "BINARY_ONLY_SCORERS",
    "CLASSIFICATION_ONLY_SCORERS",
    "REGRESSION_ONLY_SCORERS",
    "default_device_scorer",
    "device_scorer_compatible",
    "resolve_rung_scorer",
    "scorer_task_compatible",
    "accuracy_score",
    "r2_score",
    "HOST_SCORERS",
    "Scorer",
    "check_multimetric_scoring",
    "aggregate_score_dicts",
]


def _per_class(out, w):
    return out.ndim == w.ndim + 1


def _pred_idx(out, w):
    if _per_class(out, w):
        return torch.argmax(out, dim=-1)
    return (out > 0).long()


def _wsum(x, w):
    return lane_sum(x * w) if w.ndim > 1 else torch.sum(x * w, dim=-1)


def accuracy(y, out, w, meta):
    correct = (_pred_idx(out, w) == y.long()).to(w.dtype)
    return _wsum(correct, w) / torch.clamp(torch.sum(w, dim=-1), min=1e-12)


def _confusion(y, out, w, k):
    """Weighted confusion matrix ``C[..., t, p]``."""
    pred = _pred_idx(out, w)
    oh_t = F.one_hot(y.long(), k).to(w.dtype)  # (n, k)
    oh_p = F.one_hot(pred, k).to(w.dtype)  # (..., n, k)
    return (oh_t * w[..., None]).transpose(-1, -2) @ oh_p


def _prf(C):
    tp = torch.diagonal(C, dim1=-2, dim2=-1)
    support = torch.sum(C, dim=-1)
    pred_tot = torch.sum(C, dim=-2)
    precision = tp / torch.clamp(pred_tot, min=1e-12)
    recall = tp / torch.clamp(support, min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return precision, recall, f1, support


def _f1_avg(y, out, w, meta, average):
    C = _confusion(y, out, w, meta["n_classes"])
    _precision, _recall, f1, support = _prf(C)
    if average == "micro":
        return torch.sum(torch.diagonal(C, dim1=-2, dim2=-1), dim=-1) / \
            torch.clamp(torch.sum(C, dim=(-2, -1)), min=1e-12)
    if average == "macro":
        # average over the classes present in y or in the predictions
        present = (support > 0) | (torch.sum(C, dim=-2) > 0)
        return torch.sum(torch.where(present, f1, 0.0), dim=-1) / \
            torch.clamp(torch.sum(present.to(f1.dtype), dim=-1), min=1e-12)
    return torch.sum(f1 * support, dim=-1) / \
        torch.clamp(torch.sum(support, dim=-1), min=1e-12)


def f1_macro(y, out, w, meta):
    return _f1_avg(y, out, w, meta, "macro")


def f1_micro(y, out, w, meta):
    return _f1_avg(y, out, w, meta, "micro")


def f1_weighted(y, out, w, meta):
    return _f1_avg(y, out, w, meta, "weighted")


def neg_log_loss(y, proba, w, meta):
    p = torch.clamp(proba, 1e-15, 1.0 - 1e-15)
    k = meta["n_classes"]
    ll = torch.sum(F.one_hot(y.long(), k).to(p.dtype) * torch.log(p), dim=-1)
    return _wsum(ll, w) / torch.clamp(torch.sum(w, dim=-1), min=1e-12)


def roc_auc_binary(y, out, w, meta):
    """Weighted binary ROC-AUC with average-rank tie handling. ``out`` is
    decision scores, or probabilities whose last column is the positive
    class."""
    s = out[..., -1] if _per_class(out, w) else out
    pos_label = meta["n_classes"] - 1
    s, w = torch.broadcast_tensors(s, w)
    pos = (y == pos_label).to(w.dtype) * w
    neg = (y != pos_label).to(w.dtype) * w
    order = torch.argsort(s, dim=-1, stable=True)
    s_s = torch.gather(s, -1, order)
    pos_s = torch.gather(pos, -1, order)
    neg_s = torch.gather(neg, -1, order)
    cneg = torch.cumsum(neg_s, dim=-1) - neg_s  # negatives strictly before
    # ties: each positive gets credit for the negatives strictly below
    # its group plus half the group's own negative mass
    same_prev = torch.cat([
        torch.zeros_like(s_s[..., :1], dtype=torch.bool),
        s_s[..., 1:] == s_s[..., :-1],
    ], dim=-1)
    grp = torch.cumsum((~same_prev).long(), dim=-1) - 1
    total_neg_per_grp = torch.zeros_like(neg_s).scatter_add(-1, grp, neg_s)
    neg_before_grp = torch.full_like(cneg, -float("inf")).scatter_reduce(
        -1, grp, torch.where(same_prev, -float("inf"), cneg), "amax",
    )
    neg_before = torch.gather(neg_before_grp, -1, grp)
    tie_neg = torch.gather(total_neg_per_grp, -1, grp)
    auc_num = torch.sum(pos_s * (neg_before + 0.5 * tie_neg), dim=-1)
    denom = torch.sum(pos, dim=-1) * torch.sum(neg, dim=-1)
    return auc_num / torch.clamp(denom, min=1e-12)


def _wtotal(w):
    return torch.clamp(torch.sum(w, dim=-1), min=1e-12)


def r2(y, pred, w, meta):
    ybar = _wsum(y, w) / _wtotal(w)
    ss_res = _wsum((y - pred) ** 2, w)
    ss_tot = _wsum((y - ybar[..., None]) ** 2, w)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)


def neg_mean_squared_error(y, pred, w, meta):
    return -_wsum((y - pred) ** 2, w) / _wtotal(w)


def neg_root_mean_squared_error(y, pred, w, meta):
    return -torch.sqrt(-neg_mean_squared_error(y, pred, w, meta))


def neg_mean_absolute_error(y, pred, w, meta):
    return -_wsum(torch.abs(y - pred), w) / _wtotal(w)


#: name -> (kernel, required estimator output kind); the kinds are
#: 'decision' (raw scores), 'proba' and 'predict' (a regressor's output)
DEVICE_SCORERS = {
    "accuracy": (accuracy, "decision"),
    "f1_macro": (f1_macro, "decision"),
    "f1_micro": (f1_micro, "decision"),
    "f1_weighted": (f1_weighted, "decision"),
    "neg_log_loss": (neg_log_loss, "proba"),
    "roc_auc": (roc_auc_binary, "decision"),
    "r2": (r2, "predict"),
    "neg_mean_squared_error": (neg_mean_squared_error, "predict"),
    "neg_root_mean_squared_error": (neg_root_mean_squared_error, "predict"),
    "neg_mean_absolute_error": (neg_mean_absolute_error, "predict"),
}

#: metrics whose device kernels hold only for binary problems with the
#: positive class encoded as label 1 (sklearn's default pos_label)
BINARY_ONLY_SCORERS = {"roc_auc"}

#: the task-kind split of the device scorers: the classification kernels
#: read ``meta["n_classes"]`` and encoded labels, and the regression
#: kernels score raw predictions (a classifier's device 'predict' output
#: is its decision scores, not its labels)
CLASSIFICATION_ONLY_SCORERS = {
    "accuracy", "f1_macro", "f1_micro", "f1_weighted", "neg_log_loss",
    "roc_auc",
}
REGRESSION_ONLY_SCORERS = {
    "r2", "neg_mean_squared_error", "neg_root_mean_squared_error",
    "neg_mean_absolute_error",
}


def scorer_task_compatible(metric, task):
    """Whether ``metric``'s device kernel fits this estimator kind
    (``task``: an estimator, an estimator class, or ``'classifier'``/
    ``'regressor'``; unknown kinds pass)."""
    kind = task if isinstance(task, str) else getattr(
        task, "_estimator_type", None
    )
    if kind == "classifier" and metric in REGRESSION_ONLY_SCORERS:
        return False
    if kind == "regressor" and metric in CLASSIFICATION_ONLY_SCORERS:
        return False
    return True


def device_scorer_compatible(metric, classes):
    """Whether the device kernel for ``metric`` agrees with sklearn's
    semantics for this label set."""
    if metric in BINARY_ONLY_SCORERS:
        if classes is None or len(classes) != 2:
            return False
        try:
            return classes[-1] == 1  # {0,1} or {-1,1}
        except (TypeError, ValueError):
            return False
    return True


def default_device_scorer(estimator):
    """Mirror estimator.score defaults: accuracy for classifiers, r2
    for regressors."""
    kind = getattr(estimator, "_estimator_type", None)
    return "accuracy" if kind == "classifier" else "r2"


def resolve_rung_scorer(metric, scorer_specs, refit, classes=None,
                        est_cls=None):
    """Resolve a ``HalvingSpec.metric`` to the device scorer spec the
    adaptive rung evaluator runs, or None when no device kernel can
    serve it (the caller then warns and runs exhaustively).

    ``'auto'`` follows the search's refit metric: the spec among the
    resolved ``scorer_specs`` whose output name is ``refit`` (a
    single-metric search has one, named 'score'). An explicit metric
    must have a ``DEVICE_SCORERS`` kernel that holds for this label set
    and estimator kind, and whose output kind the family can produce (a
    proba metric needs ``_build_proba_kernel``). Returns an
    ``(out_name, metric, kernel, kind)`` tuple, named ``'rung'`` for an
    explicit metric."""
    def producible(spec):
        if spec is None or spec[3] != "proba" or est_cls is None:
            return spec
        if not hasattr(est_cls, "_build_proba_kernel"):
            return None
        return spec

    if metric in (None, "auto"):
        if not scorer_specs:
            return None
        want = refit if isinstance(refit, str) else "score"
        for spec in scorer_specs:
            if spec[0] == want:
                return producible(spec)
        if len(scorer_specs) > 1:
            warnings.warn(
                "HalvingSpec(metric='auto') with multimetric scoring "
                f"and refit={refit!r}: rung kills will rank candidates "
                f"by {scorer_specs[0][1]!r} (the first resolved scoring "
                "entry). Pass HalvingSpec(metric=...) to choose the "
                "metric adaptive halving eliminates by.",
                UserWarning,
            )
        return producible(scorer_specs[0])
    if metric not in DEVICE_SCORERS:
        return None
    if est_cls is not None and not scorer_task_compatible(metric, est_cls):
        return None
    if not device_scorer_compatible(metric, classes):
        return None
    kernel, kind = DEVICE_SCORERS[metric]
    return producible(("rung", metric, kernel, kind))


def accuracy_score(y_true, y_pred, sample_weight=None):
    """Host accuracy of label arrays (what ``ClassifierMixin.score``
    reports)."""
    correct = np.asarray(y_true).ravel() == np.asarray(y_pred).ravel()
    return float(np.average(correct, weights=sample_weight))


def r2_score(y_true, y_pred, sample_weight=None):
    """Host coefficient of determination (what ``RegressorMixin.score``
    reports): sklearn's R^2, 1.0 for a perfect fit of a constant target
    and 0.0 for an imperfect one."""
    y = np.asarray(y_true, np.float64).ravel()
    p = np.asarray(y_pred, np.float64).ravel()
    w = (np.ones_like(y) if sample_weight is None
         else np.asarray(sample_weight, np.float64).ravel())
    ss_res = float(np.sum(w * (y - p) ** 2))
    ss_tot = float(np.sum(w * (y - np.average(y, weights=w)) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


# ---------------------------------------------------------------------------
# host scorers: scorer(estimator, X, y) -> float, for the generic search
# path, a search's ``scorer_`` and ``score()``
# ---------------------------------------------------------------------------

#: the names of the host scorers (scikit-learn's names)
HOST_SCORERS = (
    "accuracy", "f1_macro", "f1_micro", "f1_weighted", "neg_log_loss",
    "roc_auc", "r2", "neg_mean_squared_error", "neg_root_mean_squared_error",
    "neg_mean_absolute_error",
)


def _check_labels(*arrays):
    """Raise, as scikit-learn's classification metrics do, for targets
    that are continuous (floats with a fractional part)."""
    for a in arrays:
        if a.dtype.kind == "f" and np.any(a != np.rint(a)):
            raise ValueError(
                "Classification metrics can't handle a continuous target")


def _ones(n):
    return torch.ones(n, dtype=torch.float64)


class Scorer:
    """``scorer(estimator, X, y) -> float`` for the named metric of
    :data:`HOST_SCORERS`: the estimator's response on X, from the method
    scikit-learn's scorer of that name calls (``predict_proba`` for
    ``neg_log_loss``; ``decision_function``, else the positive class's
    probability, for ``roc_auc``; ``predict`` for the rest), scored on the
    host by the metric kernels above, in float64, with unit weights.
    Picklable."""

    def __init__(self, name):
        if name not in HOST_SCORERS:
            raise ValueError(
                f"{name!r} is not a valid scoring value; the scorers are "
                f"{sorted(HOST_SCORERS)}, None (the estimator's score) or "
                "a callable scorer(estimator, X, y)")
        self.name = name

    def __repr__(self):
        return f"Scorer({self.name!r})"

    def __call__(self, estimator, X, y):
        name = self.name
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y.ravel()
        if name == "neg_log_loss":
            return self._log_loss(estimator, X, y)
        if name == "roc_auc":
            return self._roc_auc(estimator, X, y)
        pred = np.asarray(estimator.predict(X))
        if name in REGRESSION_ONLY_SCORERS:
            if name == "r2":
                return r2_score(y, pred)
            kernel, _kind = DEVICE_SCORERS[name]
            yt = torch.as_tensor(np.asarray(y, np.float64).ravel())
            pt = torch.as_tensor(np.asarray(pred, np.float64).ravel())
            return float(kernel(yt, pt, _ones(len(yt)), {}))
        y, pred = y.ravel(), pred.ravel()
        _check_labels(y, pred)
        labels = np.unique(np.concatenate([y, pred]))
        k = len(labels)
        onehot = F.one_hot(torch.as_tensor(np.searchsorted(labels, pred)),
                           k).to(torch.float64)
        kernel, _kind = DEVICE_SCORERS[name]
        return float(kernel(torch.as_tensor(np.searchsorted(labels, y)),
                            onehot, _ones(len(y)), {"n_classes": k}))

    @staticmethod
    def _log_loss(estimator, X, y):
        proba = np.asarray(estimator.predict_proba(X))
        classes = np.asarray(estimator.classes_)
        present = np.unique(y)
        if len(present) != proba.shape[1] or not np.all(
                np.isin(present, classes)):
            raise ValueError(
                f"y_true holds {len(present)} labels and the probabilities "
                f"{proba.shape[1]} columns; neg_log_loss needs every class "
                "of the estimator in y")
        # clipped at the probabilities' own machine epsilon, as
        # scikit-learn's log_loss does, then summed in float64
        eps = np.finfo(proba.dtype).eps
        p = np.clip(proba, eps, 1 - eps).astype(np.float64)
        y_idx = torch.as_tensor(np.searchsorted(classes, y))
        return float(neg_log_loss(y_idx, torch.as_tensor(p), _ones(len(y)),
                                  {"n_classes": len(classes)}))

    @staticmethod
    def _roc_auc(estimator, X, y):
        classes = np.asarray(estimator.classes_)
        present = np.unique(y)
        if len(present) > 2 or len(classes) != 2:
            raise ValueError("roc_auc scores a binary problem only; this "
                             "target is multiclass")
        if len(present) < 2:
            warnings.warn("Only one class is present in y_true. ROC AUC "
                          "score is not defined in that case.",
                          RuntimeWarning)
            return float("nan")
        if hasattr(estimator, "decision_function"):
            s = np.asarray(estimator.decision_function(X), np.float64)
        else:
            s = np.asarray(estimator.predict_proba(X), np.float64)[:, 1]
        # the positive class is the larger label, as in roc_auc_score
        y_idx = torch.as_tensor((y == present[-1]).astype(np.int64))
        return float(roc_auc_binary(y_idx, torch.as_tensor(s.ravel()),
                                    _ones(len(y)), {"n_classes": 2}))


def _estimator_score(estimator, X, y):
    """``scoring=None``: the estimator's own ``score``."""
    return estimator.score(X, y)


def _one_scorer(scoring):
    if scoring is None:
        return _estimator_score
    if callable(scoring):
        return scoring
    if isinstance(scoring, str):
        return Scorer(scoring)
    raise ValueError(f"Invalid scoring: {scoring!r}")


def check_multimetric_scoring(estimator, scoring):
    """``scoring`` as ``({name: scorer}, multimetric)``: None (the
    estimator's ``score``), a name or a callable give one scorer named
    ``"score"``; a list, tuple or set of names, or a dict of names or
    callables, several. The counterpart of the JAX package's, which asks
    scikit-learn; the port builds its own :class:`Scorer` objects."""
    if scoring is None or isinstance(scoring, str) or callable(scoring):
        return {"score": _one_scorer(scoring)}, False
    if isinstance(scoring, (list, tuple, set)):
        keys = list(scoring)
        if len(set(keys)) != len(keys):
            raise ValueError(f"Duplicate scorer names: {keys}")
        if not all(isinstance(k, str) for k in keys):
            raise ValueError(f"Invalid scoring: {scoring!r}")
        return {name: Scorer(name) for name in keys}, True
    if isinstance(scoring, dict):
        return {name: _one_scorer(s) for name, s in scoring.items()}, True
    raise ValueError(f"Invalid scoring: {scoring!r}")


def aggregate_score_dicts(scores):
    """A list of dicts as a dict of arrays."""
    return {key: np.asarray([s[key] for s in scores]) for key in scores[0]}
