"""
``DictVectorizer``: a copy of scikit-learn's
(``sklearn/feature_extraction/_dict_vectorizer.py``).

Mappings of feature name to value become rows of a matrix: a number (or
None, which becomes NaN) is that feature's value, a string ``v`` of
feature ``f`` is the feature ``"f=v"`` with value 1, and an iterable of
strings is one such feature for each. With ``sort=True`` the features
are sorted by name (``feature_names_``, ``vocabulary_``).
"""

from array import array
from collections.abc import Iterable, Mapping
from numbers import Number

import numpy as np
from scipy import sparse

from ..base import BaseEstimator, TransformerMixin

__all__ = ["DictVectorizer"]


class DictVectorizer(TransformerMixin, BaseEstimator):
    """Feature mappings to a sparse (or dense) ``dtype`` matrix."""

    def __init__(self, *, dtype=np.float64, separator="=", sparse=True,
                 sort=True):
        self.dtype = dtype
        self.separator = separator
        self.sparse = sparse
        self.sort = sort

    def _iterable_element(self, f, v, feature_names, vocab, fitting,
                          indices=None, values=None):
        for vv in v:
            if not isinstance(vv, str):
                raise TypeError(
                    f"Unsupported type {type(vv)} in iterable value. Only "
                    "iterables of string are supported.")
            name = f"{f}{self.separator}{vv}"
            if fitting and name not in vocab:
                vocab[name] = len(feature_names)
                feature_names.append(name)
            if indices is not None and name in vocab:
                indices.append(vocab[name])
                values.append(self.dtype(1))

    def fit(self, X, y=None):
        feature_names, vocab = [], {}
        for x in X:
            for f, v in x.items():
                if isinstance(v, str):
                    name = f"{f}{self.separator}{v}"
                elif isinstance(v, Number) or v is None:
                    name = f
                elif isinstance(v, Mapping):
                    raise TypeError(
                        f"Unsupported value type {type(v)} for {f}: {v}.\n"
                        "Mapping objects are not supported.")
                elif isinstance(v, Iterable):
                    name = None
                    self._iterable_element(f, v, feature_names, vocab, True)
                if name is not None and name not in vocab:
                    vocab[name] = len(feature_names)
                    feature_names.append(name)
        if self.sort:
            feature_names.sort()
            vocab = {f: i for i, f in enumerate(feature_names)}
        self.feature_names_ = feature_names
        self.vocabulary_ = vocab
        return self

    def _transform(self, X, fitting):
        if fitting:
            feature_names, vocab = [], {}
        else:
            feature_names, vocab = self.feature_names_, self.vocabulary_
        X = [X] if isinstance(X, Mapping) else X
        indices = array("i")
        indptr = [0]
        values = []
        for x in X:
            for f, v in x.items():
                if isinstance(v, str):
                    name = f"{f}{self.separator}{v}"
                    v = 1
                elif isinstance(v, Number) or v is None:
                    name = f
                elif not isinstance(v, Mapping) and isinstance(v, Iterable):
                    name = None
                    self._iterable_element(f, v, feature_names, vocab,
                                           fitting, indices, values)
                else:
                    raise TypeError(
                        f"Unsupported value Type {type(v)} for {f}: {v}.\n"
                        f"{type(v)} objects are not supported.")
                if name is not None:
                    if fitting and name not in vocab:
                        vocab[name] = len(feature_names)
                        feature_names.append(name)
                    if name in vocab:
                        indices.append(vocab[name])
                        values.append(self.dtype(v))
            indptr.append(len(indices))
        if len(indptr) == 1:
            raise ValueError("Sample sequence X is empty.")
        indices = np.frombuffer(indices, dtype=np.intc)
        out = sparse.csr_matrix((values, indices, indptr),
                                shape=(len(indptr) - 1, len(vocab)),
                                dtype=self.dtype)
        if fitting and self.sort:
            feature_names.sort()
            map_index = np.empty(len(feature_names), dtype=np.int32)
            for new, f in enumerate(feature_names):
                map_index[new] = vocab[f]
                vocab[f] = new
            out = out[:, map_index]
        if self.sparse:
            out.sort_indices()
        else:
            out = out.toarray()
        if fitting:
            self.feature_names_ = feature_names
            self.vocabulary_ = vocab
        return out

    def fit_transform(self, X, y=None):
        return self._transform(X, fitting=True)

    def transform(self, X):
        return self._transform(X, fitting=False)
