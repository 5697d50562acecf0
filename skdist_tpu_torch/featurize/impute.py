"""
``SimpleImputer``: a copy of scikit-learn's
(``sklearn/impute/_base.py``) for the strategies ``"mean"`` and
``"median"`` over dense float input, with NaN as the missing value.

A column with no observed value has a NaN statistic and is dropped by
``transform`` with scikit-learn's warning (``keep_empty_features=False``).
"""

import warnings

import numpy as np

from ..base import BaseEstimator, TransformerMixin
from .scale import as_float_array

__all__ = ["SimpleImputer"]


class SimpleImputer(TransformerMixin, BaseEstimator):
    """Replace NaN entries by their column's ``"mean"`` or ``"median"``
    (``statistics_``, by ``numpy.ma`` over the observed entries, as
    scikit-learn computes them)."""

    def __init__(self, *, missing_values=np.nan, strategy="mean", copy=True,
                 keep_empty_features=False):
        self.missing_values = missing_values
        self.strategy = strategy
        self.copy = copy
        self.keep_empty_features = keep_empty_features

    def _validate(self, X):
        if self.strategy not in ("mean", "median"):
            raise ValueError(
                f"strategy {self.strategy!r} is not ported; use 'mean' or "
                "'median'")
        if not (isinstance(self.missing_values, float)
                and np.isnan(self.missing_values)):
            raise ValueError("only missing_values=np.nan is ported")
        X = as_float_array(X, copy=self.copy)
        if X.ndim != 2:
            raise ValueError(
                f"Expected a 2D array, got {X.ndim} dimension(s)")
        if np.isinf(X).any():
            raise ValueError("Input X contains infinity")
        return X

    def fit(self, X, y=None):
        X = self._validate(X)
        masked = np.ma.masked_array(X, mask=np.isnan(X))
        reduce = np.ma.median if self.strategy == "median" else np.ma.mean
        stat = reduce(masked, axis=0)
        statistics = np.ma.getdata(stat)
        statistics[np.ma.getmaskarray(stat)] = (
            0 if self.keep_empty_features else np.nan)
        self.statistics_ = statistics
        self._fill_dtype = X.dtype
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        X = self._validate(X)
        statistics = self.statistics_
        if X.shape[1] != statistics.shape[0]:
            raise ValueError(
                "X has %d features per sample, expected %d"
                % (X.shape[1], statistics.shape[0]))
        missing = np.isnan(X)
        valid = ~np.isnan(statistics)
        fill = statistics[valid].astype(self._fill_dtype, copy=False)
        if not valid.all():
            invalid = np.arange(X.shape[1])[~valid]
            warnings.warn(
                f"Skipping features without any observed values: {invalid}. "
                "At least one non-missing value is needed for imputation "
                f"with strategy='{self.strategy}'.")
            X = X[:, valid]
            missing = missing[:, valid]
        values = np.repeat(fill, np.sum(missing, axis=0))
        X[np.where(missing.transpose())[::-1]] = values
        return X
