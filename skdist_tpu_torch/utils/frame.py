"""
The port's column table, in place of the pandas ``DataFrame`` that the
JAX package's ``Encoderizer`` and ``preprocessing`` read: ordered 1-D
numpy columns with the few pandas behaviours featurisation relies on.

- :class:`Frame`: ``.columns``, ``frame[name]`` (a :class:`Column`),
  ``frame[[names]]`` (a :class:`Frame`), ``.values`` (2-D, in pandas'
  dtype: one numeric dtype promoted, else object), ``head(n)``,
  ``len``.
- :class:`Column`: ``.values``, ``isnull()``, ``nunique()`` (NaN not
  counted), ``len``.
- :func:`isnull`: ``pd.isnull`` of an array or a scalar (None, float
  NaN, NaT, pandas' NA).
- :func:`as_frame`: a :class:`Frame` from a dict of lists or arrays
  (``DataFrame.from_dict``'s dtype inference), a 2-D array or a list of
  rows with column names, or a pandas frame (by duck typing: ``columns``
  and ``to_numpy``; pandas is never imported).

The inference follows pandas 3 (the pandas the JAX package is held to
here): a list of numbers holding None is float64 with NaN; a list whose
values are all strings is a string column, whose missing entries are
NaN and stay NaN through ``astype(str)`` (:class:`StringValues`); bools
with None, mixed types, lists and dicts stay object.
"""

from numbers import Number

import numpy as np

__all__ = ["Column", "Frame", "StringValues", "as_frame", "isnull"]


class StringValues(np.ndarray):
    """An object array of strings and NaN standing for pandas' string
    column: ``astype(str)`` keeps the missing entries NaN, as pandas'
    string arrays do, where a plain object array would write ``"nan"``;
    ``mean`` raises, as theirs does."""

    def astype(self, dtype, *args, **kwargs):
        if dtype is str:
            return np.array(self, dtype=object).view(StringValues)
        return np.asarray(self).astype(dtype, *args, **kwargs)

    def mean(self, *args, **kwargs):
        """A string column has no mean (``np.mean`` of it raises at once,
        as of pandas' string arrays, instead of concatenating every
        string first)."""
        raise TypeError("a string column has no mean")


def _scalar_null(v):
    if v is None:
        return True
    if isinstance(v, (float, np.floating, complex, np.complexfloating)):
        return bool(np.isnan(v))
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return bool(np.isnat(v))
    return type(v).__name__ in ("NaTType", "NAType")


def isnull(X):
    """``pd.isnull``: a boolean array of ``X``'s shape (or a bool for a
    scalar), True where an entry is None, a float NaN, NaT or NA."""
    if isinstance(X, np.ndarray) or isinstance(X, (list, tuple)):
        arr = np.asarray(X) if not isinstance(X, np.ndarray) else X
        kind = arr.dtype.kind
        if kind in "fc":
            return np.isnan(arr)
        if kind in "mM":
            return np.isnat(arr)
        if kind == "O":
            flat = [_scalar_null(v) for v in arr.ravel()]
            return np.asarray(flat, dtype=bool).reshape(arr.shape)
        return np.zeros(arr.shape, dtype=bool)
    return _scalar_null(X)


def _object_array(values):
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _string_column(values):
    out = _object_array([np.nan if _scalar_null(v) else v for v in values])
    return out.view(StringValues)


def _infer_list(values):
    """A list's column as ``DataFrame.from_dict`` infers it."""
    present = [v for v in values if not _scalar_null(v)]
    has_null = len(present) != len(values)
    if present and all(isinstance(v, str) for v in present):
        return _string_column(values)
    if present and all(isinstance(v, (bool, np.bool_)) for v in present):
        if not has_null:
            return np.asarray(values, dtype=bool)
        return _object_array(values)
    if present and all(isinstance(v, Number) and not isinstance(
            v, (bool, np.bool_, complex)) for v in present):
        dtype = np.asarray(present).dtype
        if has_null:
            dtype = dtype if dtype.kind == "f" else np.dtype(np.float64)
            return np.asarray([np.nan if _scalar_null(v) else v
                               for v in values], dtype=dtype)
        return np.asarray(values, dtype=dtype)
    return _object_array(values)


def _infer_array(arr):
    """A 1-D array's column: strings become a string column, numbers keep
    their dtype, other object arrays stay as they are."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "US":
        return _string_column(arr.tolist())
    if arr.dtype.kind == "O":
        present = [v for v in arr if not _scalar_null(v)]
        if present and all(isinstance(v, str) for v in present):
            return _string_column(arr)
        return arr
    return arr


class Column:
    """One named column of a :class:`Frame`."""

    def __init__(self, name, values):
        self.name = name
        self._values = values

    @property
    def values(self):
        return self._values

    def isnull(self):
        return isnull(np.asarray(self._values))

    def nunique(self):
        """Distinct non-null values (NaN not counted)."""
        vals = np.asarray(self._values)
        if vals.dtype.kind != "O":
            vals = vals[~isnull(vals)]
            return int(len(np.unique(vals)))
        return len({v for v in vals if not _scalar_null(v)})

    def __len__(self):
        return len(self._values)


def _is_string_column(values):
    return isinstance(values, StringValues)


class Frame:
    """Ordered named columns of equal length."""

    def __init__(self, columns):
        self._cols = dict(columns)
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError("All arrays must be of the same length")

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            return Frame({k: self._cols[k] for k in key})
        return Column(key, self._cols[key])

    def head(self, n=5):
        return Frame({k: v[:n] for k, v in self._cols.items()})

    @property
    def values(self):
        """The columns side by side, in pandas' dtype: a single numeric
        (or bool) dtype kept, numeric dtypes promoted, anything else
        (strings, bool beside numbers, objects) object."""
        cols = list(self._cols.values())
        n = len(self)
        if not cols:
            return np.empty((n, 0))
        kinds = {np.asarray(c).dtype.kind for c in cols}
        stringy = any(_is_string_column(c) for c in cols)
        if not stringy and "O" not in kinds and (
                kinds == {"b"} or "b" not in kinds):
            dtype = np.result_type(*[np.asarray(c).dtype for c in cols])
            return np.column_stack([np.asarray(c) for c in cols]).astype(
                dtype, copy=False)
        out = np.empty((n, len(cols)), dtype=object)
        for j, c in enumerate(cols):
            out[:, j] = np.asarray(c, dtype=object)
        return out


def as_frame(X, columns=None):
    """``X`` as a :class:`Frame`: a Frame passes through; a dict maps
    names to lists or arrays; a 2-D array or a list of rows needs
    ``columns``; a pandas frame is read by duck typing."""
    if isinstance(X, Frame):
        return X
    if isinstance(X, dict):
        out = {}
        for name, vals in X.items():
            if isinstance(vals, np.ndarray):
                out[name] = _infer_array(vals)
            else:
                out[name] = _infer_list(list(vals))
        return Frame(out)
    if isinstance(X, np.ndarray):
        if columns is None:
            raise ValueError("a 2-D array needs column names")
        X2 = X.reshape(len(X), -1)
        if X2.shape[1] != len(columns):
            raise ValueError(
                f"{X2.shape[1]} columns passed, passed data had "
                f"{len(columns)} names")
        return Frame({c: _infer_array(X2[:, j])
                      for j, c in enumerate(columns)})
    if isinstance(X, list):
        if columns is None:
            raise ValueError("a list of rows needs column names")
        rows = [list(r) if isinstance(r, (list, tuple, np.ndarray)) else [r]
                for r in X]
        return Frame({c: _infer_list([r[j] for r in rows])
                      for j, c in enumerate(columns)})
    if hasattr(X, "columns") and hasattr(X, "to_numpy"):
        out = {}
        for name in list(X.columns):
            col = X[name]
            if str(col.dtype) in ("str", "string"):
                out[name] = _string_column(list(col.to_numpy()))
            else:
                out[name] = np.asarray(col.to_numpy())
        return Frame(out)
    raise ValueError("Cannot parse input")
