"""
``VarianceThreshold``, ``f_classif`` and the univariate selectors
(``SelectFpr``, ``SelectFdr``, ``SelectFwe``, ``SelectKBest``,
``SelectPercentile``): copies of scikit-learn's
(``sklearn/feature_selection/_variance_threshold.py``,
``_univariate_selection.py``, ``_base.py``).

Kept as scikit-learn has them, because featurisation's results depend
on them: ``VarianceThreshold(threshold=0)`` takes the smaller of each
column's variance and its peak-to-peak range, so a column that is
constant apart from float noise goes; ``SelectKBest`` keeps the last
``k`` of a stable argsort and ``SelectPercentile`` keeps ties up to
``int(n * p / 100)``, both with NaN scores as the lowest float;
``SelectFdr`` is Benjamini-Hochberg and ``SelectFwe`` tests against
``alpha / n``.
"""

import warnings

import numpy as np
from scipy import sparse, special

from ..base import BaseEstimator, TransformerMixin
from .scale import as_float_array, csr_mean_variance_axis0, min_max_axis

__all__ = [
    "SelectFdr",
    "SelectFpr",
    "SelectFwe",
    "SelectKBest",
    "SelectPercentile",
    "VarianceThreshold",
    "f_classif",
]


class _SelectorMixin(TransformerMixin):
    """``get_support`` and ``transform`` over ``_get_support_mask``."""

    def get_support(self, indices=False):
        mask = self._get_support_mask()
        return np.flatnonzero(mask) if indices else mask

    def transform(self, X):
        if not sparse.issparse(X):
            X = np.asarray(X)
        mask = self.get_support()
        if not mask.any():
            warnings.warn(
                "No features were selected: either the data is too noisy or "
                "the selection test too strict.", UserWarning)
            return np.empty(0, dtype=X.dtype).reshape((X.shape[0], 0))
        if len(mask) != X.shape[1]:
            raise ValueError("X has a different shape than during fitting.")
        if sparse.issparse(X):
            return X.tocsr()[:, np.flatnonzero(mask)]
        return X[:, mask]


class VarianceThreshold(_SelectorMixin, BaseEstimator):
    """Drop features whose variance is at most ``threshold``
    (``variances_``); at ``threshold=0`` a feature's variance is the
    smaller of its variance and its peak-to-peak range."""

    def __init__(self, threshold=0.0):
        self.threshold = threshold

    def fit(self, X, y=None):
        if sparse.issparse(X):
            X = X.tocsr().astype(np.float64)
            _, self.variances_, _ = csr_mean_variance_axis0(X)
            if self.threshold == 0:
                mins, maxes = min_max_axis(X, axis=0)
                peak_to_peaks = maxes - mins
        else:
            X = np.asarray(X, dtype=np.float64)
            if X.ndim != 2:
                raise ValueError(
                    f"Expected a 2D array, got {X.ndim} dimension(s)")
            self.variances_ = np.nanvar(X, axis=0)
            if self.threshold == 0:
                peak_to_peaks = np.ptp(X, axis=0)
        if self.threshold == 0:
            self.variances_ = np.nanmin(
                np.array([self.variances_, peak_to_peaks]), axis=0)
        self.n_features_in_ = X.shape[1]
        if np.all(~np.isfinite(self.variances_)
                  | (self.variances_ <= self.threshold)):
            msg = "No feature in X meets the variance threshold {0:.5f}"
            if X.shape[0] == 1:
                msg += " (X contains only one sample)"
            raise ValueError(msg.format(self.threshold))
        return self

    def _get_support_mask(self):
        return self.variances_ > self.threshold


def f_classif(X, y):
    """The ANOVA F-value of every feature against the class labels
    ``y``, and its p-value: scikit-learn's ``f_classif`` (its
    ``f_oneway`` on the rows of each class). Returns ``(F, p)``."""
    if sparse.issparse(X):
        X = X.tocsr()
    else:
        X = np.asarray(X)
    y = np.asarray(y)
    args = [X[np.flatnonzero(y == k)] for k in np.unique(y)]
    n_classes = len(args)
    args = [as_float_array(a) for a in args]
    n_per_class = np.array([a.shape[0] for a in args])
    n_samples = np.sum(n_per_class)
    ss_alldata = sum(_squared(a).sum(axis=0) for a in args)
    sums_args = [np.asarray(a.sum(axis=0)) for a in args]
    square_of_sums_alldata = sum(sums_args) ** 2
    square_of_sums_args = [s ** 2 for s in sums_args]
    sstot = ss_alldata - square_of_sums_alldata / float(n_samples)
    ssbn = 0.0
    for k in range(n_classes):
        ssbn += square_of_sums_args[k] / n_per_class[k]
    ssbn -= square_of_sums_alldata / float(n_samples)
    sswn = sstot - ssbn
    dfbn = n_classes - 1
    dfwn = n_samples - n_classes
    msb = ssbn / float(dfbn)
    msw = sswn / float(dfwn)
    constant = np.where(msw == 0.0)[0]
    if np.nonzero(msb)[0].size != msb.size and constant.size:
        warnings.warn(f"Features {constant} are constant.", UserWarning)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.asarray(msb / msw).ravel()
    return f, special.fdtrc(dfbn, dfwn, f)


def _squared(a):
    if sparse.issparse(a):
        a = a.copy()
        a.data **= 2
        return a
    return a ** 2


def _clean_nans(scores):
    """NaN scores as the lowest float of their type (a copy)."""
    scores = as_float_array(scores, copy=True)
    scores[np.isnan(scores)] = np.finfo(scores.dtype).min
    return scores


class _BaseFilter(_SelectorMixin, BaseEstimator):
    """A univariate filter over ``score_func(X, y) -> (scores,
    pvalues)`` (or scores alone)."""

    def fit(self, X, y):
        if not sparse.issparse(X):
            X = np.asarray(X)
        self._check_params(X, y)
        ret = self.score_func(X, y)
        if isinstance(ret, (list, tuple)):
            self.scores_, self.pvalues_ = ret
            self.pvalues_ = np.asarray(self.pvalues_)
        else:
            self.scores_, self.pvalues_ = ret, None
        self.scores_ = np.asarray(self.scores_)
        self.n_features_in_ = X.shape[1]
        return self

    def _check_params(self, X, y):
        pass


class SelectPercentile(_BaseFilter):
    """Keep the features of the top ``percentile`` scores."""

    def __init__(self, score_func=f_classif, *, percentile=10):
        self.score_func = score_func
        self.percentile = percentile

    def _get_support_mask(self):
        if self.percentile == 100:
            return np.ones(len(self.scores_), dtype=bool)
        if self.percentile == 0:
            return np.zeros(len(self.scores_), dtype=bool)
        scores = _clean_nans(self.scores_)
        threshold = np.percentile(scores, 100 - self.percentile)
        mask = scores > threshold
        ties = np.where(scores == threshold)[0]
        if len(ties):
            max_feats = int(len(scores) * self.percentile / 100)
            mask[ties[:max_feats - mask.sum()]] = True
        return mask


class SelectKBest(_BaseFilter):
    """Keep the features of the ``k`` highest scores (``"all"`` keeps
    every one)."""

    def __init__(self, score_func=f_classif, *, k=10):
        self.score_func = score_func
        self.k = k

    def _check_params(self, X, y):
        if not isinstance(self.k, str) and self.k > X.shape[1]:
            warnings.warn(
                f"k={self.k} is greater than n_features={X.shape[1]}. All "
                "the features will be returned.")

    def _get_support_mask(self):
        if self.k == "all":
            return np.ones(self.scores_.shape, dtype=bool)
        if self.k == 0:
            return np.zeros(self.scores_.shape, dtype=bool)
        scores = _clean_nans(self.scores_)
        mask = np.zeros(scores.shape, dtype=bool)
        mask[np.argsort(scores, kind="mergesort")[-self.k:]] = 1
        return mask


class SelectFpr(_BaseFilter):
    """Keep the features whose p-value is below ``alpha``."""

    def __init__(self, score_func=f_classif, *, alpha=5e-2):
        self.score_func = score_func
        self.alpha = alpha

    def _get_support_mask(self):
        return self.pvalues_ < self.alpha


class SelectFdr(_BaseFilter):
    """Benjamini-Hochberg: keep the features up to the largest sorted
    p-value at most ``alpha * rank / n``."""

    def __init__(self, score_func=f_classif, *, alpha=5e-2):
        self.score_func = score_func
        self.alpha = alpha

    def _get_support_mask(self):
        n_features = len(self.pvalues_)
        sv = np.sort(self.pvalues_)
        selected = sv[sv <= float(self.alpha) / n_features
                      * np.arange(1, n_features + 1)]
        if selected.size == 0:
            return np.zeros_like(self.pvalues_, dtype=bool)
        return self.pvalues_ <= selected.max()


class SelectFwe(_BaseFilter):
    """Keep the features whose p-value is below ``alpha / n``."""

    def __init__(self, score_func=f_classif, *, alpha=5e-2):
        self.score_func = score_func
        self.alpha = alpha

    def _get_support_mask(self):
        return self.pvalues_ < self.alpha / len(self.pvalues_)
