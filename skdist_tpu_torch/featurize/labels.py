"""
``LabelEncoder`` and ``MultiLabelBinarizer``: copies of scikit-learn's
(``sklearn/preprocessing/_label.py``, ``sklearn/utils/_encode.py``).
"""

import array
import itertools
import warnings

import numpy as np
from scipy import sparse

from ..base import BaseEstimator, TransformerMixin

__all__ = ["LabelEncoder", "MultiLabelBinarizer"]


def _column_or_1d(y, dtype=None):
    y = np.asarray(y, dtype=dtype)
    if y.ndim == 2 and y.shape[1] == 1:
        warnings.warn("A column-vector y was passed when a 1d array was "
                      "expected.")
        return y.ravel()
    if y.ndim != 1:
        raise ValueError(
            f"y should be a 1d array, got an array of shape {y.shape} "
            "instead.")
    return y


def _is_missing(v):
    return v is None or (isinstance(v, float) and np.isnan(v))


def _nan_key(v):
    """Every float NaN as the one ``np.nan`` key (NaN != NaN)."""
    return np.nan if isinstance(v, float) and np.isnan(v) else v


def _unique(values):
    """Sorted unique values: ``np.unique``, or for object arrays the
    sorted set with None and NaN last, as scikit-learn's ``_unique``."""
    if values.dtype != object:
        return np.unique(values)
    uniques = set(values)
    missing = [v for v in uniques if _is_missing(v)]
    try:
        out = sorted(v for v in uniques if not _is_missing(v))
    except TypeError:
        types = sorted(t.__qualname__ for t in {type(v) for v in values})
        raise TypeError(
            "Encoders require their input argument must be uniformly "
            f"strings or numbers. Got {types}") from None
    if any(v is None for v in missing):
        out.append(None)
    if any(v is not None for v in missing):
        out.append(np.nan)
    return np.array(out, dtype=values.dtype)


class LabelEncoder(TransformerMixin, BaseEstimator):
    """Labels to indices into the sorted ``classes_`` and back."""

    def fit(self, y):
        self.classes_ = _unique(_column_or_1d(y))
        return self

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def transform(self, y):
        y = _column_or_1d(y, dtype=self.classes_.dtype)
        if y.shape[0] == 0:
            return np.asarray([])
        if y.dtype.kind in "OUS":
            table = {_nan_key(c): i for i, c in enumerate(self.classes_)}
            try:
                return np.asarray([table[_nan_key(v)] for v in y])
            except KeyError as exc:
                raise ValueError(
                    f"y contains previously unseen labels: {exc}") from None
        diff = np.setdiff1d(y, self.classes_)
        if len(diff):
            raise ValueError(
                f"y contains previously unseen labels: {list(diff)}")
        return np.searchsorted(self.classes_, y)

    def inverse_transform(self, y):
        y = _column_or_1d(y)
        if y.shape[0] == 0:
            return np.asarray([])
        diff = np.setdiff1d(y, np.arange(len(self.classes_)))
        if len(diff):
            raise ValueError(f"y contains previously unseen labels: {diff}")
        return self.classes_[np.asarray(y)]


class MultiLabelBinarizer(TransformerMixin, BaseEstimator):
    """Sequences of labels to a ``(n, n_classes)`` indicator matrix over
    the sorted ``classes_`` (int when every class is an int, else
    object). Labels unseen at fit are left out with a warning."""

    def __init__(self, *, classes=None, sparse_output=False):
        self.classes = classes
        self.sparse_output = sparse_output

    def fit(self, y):
        if self.classes is None:
            classes = sorted(set(itertools.chain.from_iterable(y)))
        elif len(set(self.classes)) < len(self.classes):
            raise ValueError(
                "The classes argument contains duplicate classes. Remove "
                "these duplicates before passing them to "
                "MultiLabelBinarizer.")
        else:
            classes = self.classes
        dtype = int if all(isinstance(c, int) for c in classes) else object
        self.classes_ = np.empty(len(classes), dtype=dtype)
        self.classes_[:] = classes
        return self

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def transform(self, y):
        mapping = dict(zip(self.classes_, range(len(self.classes_))))
        indices = array.array("i")
        indptr = array.array("i", [0])
        unknown = set()
        for labels in y:
            index = set()
            for label in labels:
                try:
                    index.add(mapping[label])
                except KeyError:
                    unknown.add(label)
            indices.extend(sorted(index))
            indptr.append(len(indices))
        if unknown:
            warnings.warn(
                f"unknown class(es) {sorted(unknown, key=str)} will be "
                "ignored")
        data = np.ones(len(indices), dtype=int)
        yt = sparse.csr_matrix((data, indices, indptr),
                               shape=(len(indptr) - 1, len(mapping)))
        return yt if self.sparse_output else yt.toarray()
