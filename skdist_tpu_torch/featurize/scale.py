"""
``StandardScaler`` and ``normalize``: copies of scikit-learn's
(``sklearn/preprocessing/_data.py``), with the sparse column statistics
they and ``selection.VarianceThreshold`` share
(``sklearn/utils/sparsefuncs.py``).

The arithmetic follows scikit-learn's operation for operation (the same
numpy reductions, and sequential sums where its Cython loops sum in
order), so that fitted statistics and outputs equal scikit-learn's to
the last bit on the same inputs (``tests/test_torch_featurize.py``).
"""

import numpy as np
from scipy import sparse

from ..base import BaseEstimator, TransformerMixin

__all__ = ["StandardScaler", "normalize"]

_EPS64 = np.finfo(np.float64).eps


def as_float_array(X, copy=False):
    """``X`` as a float array: float32 and float64 kept, anything else
    float64 (scikit-learn's ``FLOAT_DTYPES`` rule); sparse stays sparse."""
    if sparse.issparse(X):
        X = X.tocsr() if X.format not in ("csr", "csc") else X
        if X.dtype not in (np.float32, np.float64):
            return X.astype(np.float64)
        return X.copy() if copy else X
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        return X.astype(np.float64)
    return X.copy() if copy else X


def _sums(index, weights, n):
    """Float64 sums of ``weights`` by ``index``, each bin summed in the
    order of its entries (``np.bincount``, which gives an integer array
    for empty input)."""
    return np.bincount(index, weights=weights, minlength=n).astype(
        np.float64, copy=False)


def _row_ids(X):
    return np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))


def csr_mean_variance_axis0(X):
    """Per-column mean and variance of a CSR matrix, implicit zeros
    counted and NaN entries left out: scikit-learn's
    ``_csr_mean_variance_axis0`` with unit weights (its two passes, each
    summing in row order, in float64). Returns (means, variances, the
    non-NaN count a column)."""
    n, d = X.shape
    data = np.asarray(X.data, dtype=np.float64)
    ok = ~np.isnan(data)
    idx, data = X.indices[ok], data[ok]
    counts_nz = np.bincount(idx, minlength=d)
    n_nan = np.bincount(X.indices[~ok], minlength=d)
    sum_weights = float(n) - n_nan.astype(np.float64)
    counts = n - n_nan
    means = _sums(idx, data, d) / sum_weights
    diff = data - means[idx]
    correction = _sums(idx, diff, d)
    variances = _sums(idx, diff * diff, d)
    implicit = counts != counts_nz
    zeros_w = sum_weights - counts_nz
    correction[implicit] -= zeros_w[implicit] * means[implicit]
    correction = correction ** 2 / sum_weights
    variances[implicit] += zeros_w[implicit] * means[implicit] ** 2
    variances = (variances - correction) / sum_weights
    return means, variances, sum_weights


def min_max_axis(X, axis):
    """Per-column (``axis=0``) or per-row (``axis=1``) minimum and
    maximum of a CSR/CSC matrix, its implicit zeros counted:
    scikit-learn's ``min_max_axis``."""
    mat = X.tocsc() if axis == 0 else X.tocsr()
    mat = mat.copy()
    mat.sum_duplicates()
    N = X.shape[axis]
    M = X.shape[1 - axis]
    nnz = np.diff(mat.indptr)
    mins = np.zeros(M, dtype=mat.dtype)
    maxs = np.zeros(M, dtype=mat.dtype)
    major = np.flatnonzero(nnz)
    if major.size:
        starts = mat.indptr[major]
        lo = np.minimum.reduceat(mat.data, starts)
        hi = np.maximum.reduceat(mat.data, starts)
        full = nnz[major] == N
        mins[major] = np.where(full, lo, np.minimum(lo, 0))
        maxs[major] = np.where(full, hi, np.maximum(hi, 0))
    return mins, maxs


def normalize(X, norm="l2", *, copy=True):
    """Scale rows to unit ``"l1"``, ``"l2"`` or ``"max"`` norm:
    scikit-learn's ``normalize`` along its default axis. A dense row
    whose norm is below ten float epsilons is left as it is; a sparse
    row of norm 0 too. Sparse rows sum in order in float64, as
    scikit-learn's in-place Cython loops do."""
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"'{norm}' is not a supported norm")
    if sparse.issparse(X):
        X = X.tocsr()
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        elif copy or not X.data.flags.writeable:
            X = X.copy()
    else:
        X = as_float_array(X, copy=copy)
        if not X.flags.writeable:
            X = X.copy()
    if sparse.issparse(X):
        rows = _row_ids(X)
        if norm in ("l1", "l2"):
            terms = np.abs(X.data) if norm == "l1" else X.data * X.data
            sums = _sums(rows, terms, X.shape[0])
            if norm == "l2":
                sums = np.sqrt(sums)
            scale = sums[rows]
            live = scale != 0.0
            X.data[live] = X.data[live] / scale[live]
        else:
            mins, maxes = min_max_axis(X, 1)
            norms = np.maximum(abs(mins), maxes)
            elementwise = norms.repeat(np.diff(X.indptr))
            mask = elementwise != 0
            X.data[mask] /= elementwise[mask]
    else:
        if norm == "l1":
            norms = np.sum(np.abs(X), axis=1)
        elif norm == "l2":
            norms = np.sqrt(np.einsum("ij,ij->i", X, X))
        else:
            norms = np.max(np.abs(X), axis=1)
        X /= _handle_zeros_in_scale(norms)[:, None]
    return X


def _handle_zeros_in_scale(scale, constant_mask=None):
    """Scales below ten epsilons of their type (or those in
    ``constant_mask``) become 1, in place."""
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


def _safe_sum(op, X, **kw):
    """``op`` with a float64 accumulator for float32 (or smaller)
    input."""
    if np.issubdtype(X.dtype, np.floating) and X.dtype.itemsize < 8:
        return op(X, dtype=np.float64, **kw)
    return op(X, **kw)


def _mean_and_var(X):
    """Column means, variances and counts of a dense float ``X`` (NaN
    left out), by scikit-learn's first call of
    ``_incremental_mean_and_var``: the corrected two-pass algorithm in
    float64."""
    last_count = np.zeros(X.shape[1], dtype=np.float64)
    last_sum = 0.0 * last_count
    nan_mask = np.isnan(X)
    sum_op = np.nansum if np.any(nan_mask) else np.sum
    new_sum = _safe_sum(sum_op, X, axis=0)
    new_count = X.shape[0] - _safe_sum(sum_op, nan_mask.astype(X.dtype),
                                       axis=0)
    count = last_count + new_count
    mean = (last_sum + new_sum) / count
    temp = X - new_sum / new_count
    correction = _safe_sum(sum_op, temp, axis=0)
    temp **= 2
    unnormalized = _safe_sum(sum_op, temp, axis=0)
    unnormalized -= correction ** 2 / new_count
    return mean, unnormalized / count, count


class StandardScaler(TransformerMixin, BaseEstimator):
    """Standardise features by removing the mean and scaling to unit
    variance: scikit-learn's ``StandardScaler`` (one ``fit``, no
    ``partial_fit`` or sample weights). ``mean_``, ``var_``, ``scale_``
    (a feature whose variance is zero up to rounding gets scale 1) and
    ``n_samples_seen_`` as scikit-learn computes them; with
    ``copy=False`` a float input is transformed in place. Dense input
    only (a sparse matrix cannot be centred)."""

    def __init__(self, *, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        X = self._dense(X)
        if not self.with_mean and not self.with_std:
            self.mean_ = self.var_ = None
            count = (X.shape[0] - np.isnan(X).sum(axis=0)).astype(np.int64)
        else:
            self.mean_, self.var_, count = _mean_and_var(X)
            if not self.with_std:
                self.var_ = None
        self.n_samples_seen_ = (count[0] if np.max(count) == np.min(count)
                                else count)
        self.n_features_in_ = X.shape[1]
        if self.with_std:
            n = self.n_samples_seen_
            bound = n * _EPS64 * self.var_ + (n * self.mean_ * _EPS64) ** 2
            self.scale_ = _handle_zeros_in_scale(
                np.sqrt(self.var_), constant_mask=self.var_ <= bound)
        else:
            self.scale_ = None
        return self

    @staticmethod
    def _dense(X, copy=False):
        if sparse.issparse(X):
            raise TypeError("the port's StandardScaler takes dense input")
        X = as_float_array(X, copy=copy)
        if X.ndim != 2:
            raise ValueError(
                f"Expected a 2D array, got an array of {X.ndim} dimension(s)")
        return X

    def transform(self, X, copy=None):
        X = self._dense(X, self.copy if copy is None else copy)
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features, but StandardScaler is "
                f"expecting {self.n_features_in_} features as input.")
        if self.with_mean:
            X -= self.mean_.astype(X.dtype)
        if self.with_std:
            X /= self.scale_.astype(X.dtype)
        return X
