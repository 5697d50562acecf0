"""CV splitters and the parameter grid of the search.

The card's machine has no scikit-learn, so the port carries the pieces
of ``sklearn.model_selection`` that ``DistGridSearchCV`` uses:
:class:`KFold`, :class:`StratifiedKFold`, :func:`check_cv` and
:class:`ParameterGrid`. They give the same splits and the same candidate
order as scikit-learn 1.x (with ``shuffle=False``, and with an integer
``random_state`` when shuffling). Any object with a ``split`` method, or
an iterable of ``(train, test)`` pairs, is accepted as ``cv``.
"""

import warnings
from itertools import product

import numpy as np

__all__ = ["KFold", "StratifiedKFold", "check_cv", "ParameterGrid"]


def _is_discrete_target(y):
    """Whether ``y`` is a binary/multiclass target (1-D, or an (n, 1)
    column, of labels; floats only when every value is integral)."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    if y.ndim != 1 or y.size == 0:
        return False
    if y.dtype.kind == "f":
        return bool(np.all(np.isfinite(y)) and np.all(y == np.round(y)))
    return y.dtype.kind in "iubOUS"


class KFold:
    """Consecutive folds: the first ``n % n_splits`` folds hold one extra
    sample."""

    def __init__(self, n_splits=5, shuffle=False, random_state=None):
        if int(n_splits) < 2:
            raise ValueError(f"n_splits must be at least 2; got {n_splits}")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def split(self, X, y=None, groups=None):
        n = _num_rows(X)
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have n_splits={self.n_splits} greater than the "
                f"number of samples n_samples={n}."
            )
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(indices)
        fold_sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        fold_sizes[: n % self.n_splits] += 1
        rows = np.arange(n)
        current = 0
        for size in fold_sizes:
            mask = np.zeros(n, dtype=bool)
            mask[indices[current:current + size]] = True
            yield rows[~mask], rows[mask]
            current += size


class StratifiedKFold:
    """Folds that keep each class's share: the round-robin allocation of
    scikit-learn 1.x, with each class's rows assigned to folds in blocks
    in order of appearance."""

    def __init__(self, n_splits=5, shuffle=False, random_state=None):
        if int(n_splits) < 2:
            raise ValueError(f"n_splits must be at least 2; got {n_splits}")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def _test_folds(self, y):
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y.ravel()
        if not _is_discrete_target(y):
            raise ValueError(
                "StratifiedKFold needs a binary or multiclass target"
            )
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        # classes encoded by order of first appearance
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv.reshape(-1)]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(
                f"n_splits={self.n_splits} cannot be greater than the "
                "number of members in each class."
            )
        if self.n_splits > np.min(y_counts):
            warnings.warn(
                f"The least populated class in y has only "
                f"{np.min(y_counts)} members, which is less than "
                f"n_splits={self.n_splits}.",
                UserWarning,
            )
        y_order = np.sort(y_encoded)
        allocation = np.asarray([
            np.bincount(y_order[i::self.n_splits], minlength=n_classes)
            for i in range(self.n_splits)
        ])
        rng = np.random.RandomState(self.random_state)
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        n = _num_rows(X)
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have n_splits={self.n_splits} greater than the "
                f"number of samples n_samples={n}."
            )
        test_folds = self._test_folds(y)
        indices = np.arange(n)
        for i in range(self.n_splits):
            mask = test_folds == i
            yield indices[~mask], indices[mask]


class _SplitsWrapper:
    """A fixed list of ``(train, test)`` pairs as a splitter."""

    def __init__(self, cv):
        self.splits = [(np.asarray(tr), np.asarray(te)) for tr, te in cv]

    def get_n_splits(self, X=None, y=None, groups=None):
        return len(self.splits)

    def split(self, X=None, y=None, groups=None):
        return iter(self.splits)


def check_cv(cv=5, y=None, classifier=False):
    """sklearn's ``check_cv``: an int (or None, meaning 5) gives
    :class:`StratifiedKFold` for a classifier with a binary/multiclass
    ``y`` and :class:`KFold` otherwise; a splitter is returned as is; an
    iterable of ``(train, test)`` pairs is wrapped."""
    cv = 5 if cv is None else cv
    if isinstance(cv, (int, np.integer)) and not isinstance(cv, bool):
        if classifier and y is not None and _is_discrete_target(y):
            return StratifiedKFold(cv)
        return KFold(cv)
    if hasattr(cv, "split") and hasattr(cv, "get_n_splits"):
        return cv
    if hasattr(cv, "__iter__") and not isinstance(cv, str):
        return _SplitsWrapper(cv)
    raise ValueError(
        "cv must be an int, a splitter with split()/get_n_splits(), or an "
        f"iterable of (train, test) pairs; got {cv!r}"
    )


def _num_rows(X):
    if hasattr(X, "shape"):
        return int(X.shape[0])
    return len(X)


class ParameterGrid:
    """Every combination of a dict (or list of dicts) of value lists, in
    scikit-learn's order: keys sorted, the last key fastest."""

    def __init__(self, param_grid):
        if isinstance(param_grid, dict):
            param_grid = [param_grid]
        for grid in param_grid:
            if not isinstance(grid, dict):
                raise TypeError(f"Parameter grid is not a dict ({grid!r})")
            for key, value in grid.items():
                if isinstance(value, (str, bytes)) or not hasattr(
                        value, "__iter__"):
                    raise TypeError(
                        f"Parameter grid value for {key!r} must be a "
                        f"sequence; got {value!r}"
                    )
        self.param_grid = param_grid

    def __iter__(self):
        for grid in self.param_grid:
            items = sorted(grid.items())
            if not items:
                yield {}
                continue
            keys, values = zip(*items)
            for combo in product(*values):
                yield dict(zip(keys, combo))

    def __len__(self):
        total = 0
        for grid in self.param_grid:
            size = 1
            for v in grid.values():
                size *= len(v)
            total += size
        return total
