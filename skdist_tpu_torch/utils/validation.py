"""Validation helpers (copies of the functions of
``skdist_tpu/utils/validation.py`` that the searches and the ensembles
use)."""

import numbers

import numpy as np

from .cv import ParameterGrid


def full_length_sample_weight(fit_params, n):
    """The batched path's fit-params contract: the compiled programs
    accept exactly ONE array-valued fit param, a full-length per-sample
    ``sample_weight``, which composes multiplicatively with fold masks.

    Returns ``(sw_or_None, ok)``. ``ok`` False means another fit param
    was given, or weights that are not a length-``n`` vector;
    ``(None, True)`` means "no weights". ``(n, 1)`` columns flatten.
    """
    if not fit_params:
        return None, True
    if set(fit_params) != {"sample_weight"}:
        return None, False
    sw = fit_params["sample_weight"]
    if sw is None:
        return None, True
    try:
        arr = np.asarray(sw, dtype=np.float64)
    except (ValueError, TypeError):
        return None, False
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr.ravel()
    if arr.ndim == 1 and arr.shape[0] == n:
        return arr, True
    return None, False


def check_n_iter(n_iter, param_distributions):
    """Cap ``n_iter`` at the size of the grid when every distribution is
    a list (so the whole space can be enumerated); a dict or a list of
    dicts."""
    dists = ([param_distributions] if isinstance(param_distributions, dict)
             else param_distributions)
    if all(not hasattr(v, "rvs") for d in dists for v in d.values()):
        return min(len(ParameterGrid(param_distributions)), n_iter)
    return n_iter


def check_is_fitted(estimator, attributes=None):
    """Raise if estimator has no fitted attributes."""
    if attributes is not None:
        if isinstance(attributes, str):
            attributes = [attributes]
        fitted = all(hasattr(estimator, a) for a in attributes)
    else:
        fitted = any(
            v for v in vars(estimator)
            if v.endswith("_") and not v.startswith("__")
        )
    if not fitted:
        raise AttributeError(
            f"This {type(estimator).__name__} instance is not fitted yet. "
            "Call 'fit' before using this estimator."
        )


def check_error_score(error_score):
    """Validate the ``error_score`` policy at ``fit()`` entry: 'raise' or
    a real number (NaN included)."""
    if isinstance(error_score, str):
        if error_score == "raise":
            return error_score
        raise ValueError(
            f"error_score must be 'raise' or a number, got "
            f"{error_score!r} (did you mean numpy.nan?)"
        )
    if isinstance(error_score, bool) or not isinstance(
            error_score, numbers.Number):
        raise ValueError(
            f"error_score must be 'raise' or a number, got "
            f"{error_score!r}"
        )
    return error_score


def num_samples(x):
    """Number of samples in array-like x."""
    if hasattr(x, "shape") and x.shape is not None:
        if len(x.shape) == 0:
            raise TypeError(
                "Singleton array cannot be considered a valid collection."
            )
        if isinstance(x.shape[0], numbers.Integral):
            return x.shape[0]
    if hasattr(x, "__len__"):
        return len(x)
    raise TypeError(f"Expected sequence or array-like, got {type(x)}")


def check_estimator_backend(estimator, verbose=False):
    """Print which execution path a fit will use."""
    if verbose:
        backend = getattr(estimator, "backend", None)
        if backend is None:
            print("Will fit using the default CUDABackend")
        else:
            print(f"Will fit using {type(backend).__name__}")


def safe_indexing(X, indices):
    """Row-subset X across container types (pandas, numpy, scipy
    sparse, lists)."""
    if X is None:
        return None
    if hasattr(X, "iloc"):
        return X.iloc[indices]
    if hasattr(X, "shape"):  # numpy / scipy sparse
        return X[indices]
    return [X[i] for i in indices]


def safe_split(estimator, X, y, indices, train_indices=None):
    """Rows ``indices`` of X and y; for an estimator on a precomputed
    kernel, the ``(indices, train_indices)`` block of X (its square
    block without ``train_indices``)."""
    if getattr(estimator, "kernel", None) == "precomputed":
        if not hasattr(X, "shape"):
            raise ValueError("Precomputed kernels require array X")
        if train_indices is None:
            X_subset = X[np.ix_(indices, indices)]
        else:
            X_subset = X[np.ix_(indices, train_indices)]
    else:
        X_subset = safe_indexing(X, indices)
    y_subset = safe_indexing(y, indices) if y is not None else None
    return X_subset, y_subset


def index_fit_params(X, fit_params, indices):
    """Fit params cut to a fold's rows: a value with one entry per
    sample of X (a full-length ``sample_weight``, say) is indexed by
    ``indices``; everything else passes through untouched."""
    if not fit_params:
        return {}
    n = num_samples(X)
    out = {}
    for key, value in fit_params.items():
        is_arraylike = (
            hasattr(value, "__len__") or hasattr(value, "shape")
        ) and not isinstance(value, (str, bytes, dict))
        if is_arraylike:
            try:
                matches = num_samples(value) == n
            except TypeError:
                matches = False
            if matches:
                value = safe_indexing(value, indices)
        out[key] = value
    return out
