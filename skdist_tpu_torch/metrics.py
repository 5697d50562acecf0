"""
Scoring: the device scorer kernels of the search, batched over tasks.

Counterpart of ``skdist_tpu/metrics.py`` (its device scorers). Each
kernel is ``(y, out, w, meta) -> score`` and runs on the device of its
tensors inside the search round that fitted the models, with CV fold
selection as 0/1 weight masks; no prediction leaves the device.

``out`` is the estimator's raw output for one task (``(n,)`` binary
decision scores, ``(n, k)`` multinomial scores or probabilities) or for
a batch of tasks, with a leading task axis; ``w`` is ``(n,)`` or
``(T, n)`` to match. An output with one more axis than ``w`` is
per-class. The result is a scalar or a ``(T,)`` tensor.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "accuracy",
    "f1_weighted",
    "f1_macro",
    "f1_micro",
    "neg_log_loss",
    "roc_auc_binary",
    "DEVICE_SCORERS",
    "BINARY_ONLY_SCORERS",
    "default_device_scorer",
    "device_scorer_compatible",
    "accuracy_score",
    "DeviceScorer",
]


def _per_class(out, w):
    return out.ndim == w.ndim + 1


def _pred_idx(out, w):
    if _per_class(out, w):
        return torch.argmax(out, dim=-1)
    return (out > 0).long()


def _wsum(x, w):
    return torch.sum(x * w, dim=-1)


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


#: name -> (kernel, required estimator output kind)
DEVICE_SCORERS = {
    "accuracy": (accuracy, "decision"),
    "f1_macro": (f1_macro, "decision"),
    "f1_micro": (f1_micro, "decision"),
    "f1_weighted": (f1_weighted, "decision"),
    "neg_log_loss": (neg_log_loss, "proba"),
    "roc_auc": (roc_auc_binary, "decision"),
}

#: metrics whose device kernels hold only for binary problems with the
#: positive class encoded as label 1 (sklearn's default pos_label)
BINARY_ONLY_SCORERS = {"roc_auc"}


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
    """Mirror estimator.score defaults: accuracy for classifiers."""
    kind = getattr(estimator, "_estimator_type", None)
    return "accuracy" if kind == "classifier" else "r2"


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


class DeviceScorer:
    """``scorer(estimator, X, y)`` over a fitted port estimator, through
    the device scorer kernel of ``metric`` (the search's ``scorer_``)."""

    def __init__(self, metric):
        if metric not in DEVICE_SCORERS:
            raise ValueError(f"no device scorer named {metric!r}")
        self.metric = metric

    def __call__(self, estimator, X, y):
        kernel, kind = DEVICE_SCORERS[self.metric]
        out = (estimator.predict_proba(X) if kind == "proba"
               else estimator.decision_function(X))
        classes = np.asarray(estimator.classes_)
        y = np.asarray(y).ravel()
        y_idx = np.searchsorted(classes, y)
        if (y_idx >= len(classes)).any() or (classes[np.minimum(
                y_idx, len(classes) - 1)] != y).any():
            raise ValueError("y holds labels the estimator was not fit on")
        meta = {"n_classes": len(classes)}
        w = torch.ones(len(y), dtype=torch.float32)
        return float(kernel(torch.as_tensor(y_idx), torch.as_tensor(out),
                            w, meta))
