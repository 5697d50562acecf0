"""CV splitters, the parameter grid and the parameter sampler of the
searches.

The card's machine has no scikit-learn, so the port carries the pieces
of ``sklearn.model_selection`` that ``DistGridSearchCV`` and
``DistRandomizedSearchCV`` use: :class:`KFold`, :class:`StratifiedKFold`,
:func:`check_cv`, :class:`ParameterGrid` and :class:`ParameterSampler`
(with ``sample_without_replacement`` of ``sklearn.utils.random``). They
give the same splits, the same candidate order and the same sampled
candidates as scikit-learn 1.9 (with ``shuffle=False``, and with an
integer ``random_state`` when shuffling): the sampler makes the same
``numpy.random.RandomState`` calls in the same order. Any object with a
``split`` method, or an iterable of ``(train, test)`` pairs, is accepted
as ``cv``.
"""

import numbers
import warnings
from collections.abc import Iterable, Mapping
from itertools import product

import numpy as np

__all__ = ["KFold", "StratifiedKFold", "check_cv", "ParameterGrid",
           "ParameterSampler", "check_random_state",
           "sample_without_replacement"]


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

    def __getitem__(self, ind):
        """The ``ind``-th candidate of the iteration order, without
        building the others (how the sampler draws without
        replacement)."""
        for grid in self.param_grid:
            if not grid:
                if ind == 0:
                    return {}
                ind -= 1
                continue
            # the last sorted key cycles fastest
            keys, values = zip(*sorted(grid.items())[::-1])
            sizes = [len(v) for v in values]
            total = int(np.prod(sizes))
            if ind >= total:
                ind -= total
                continue
            out = {}
            for key, vals, size in zip(keys, values, sizes):
                ind, offset = divmod(ind, size)
                out[key] = vals[offset]
            return out
        raise IndexError("ParameterGrid index out of range")


def check_random_state(seed):
    """``None`` (numpy's global RandomState), an int or a RandomState ->
    a ``numpy.random.RandomState``, as scikit-learn's."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(
        f"{seed!r} cannot be used to seed a numpy.random.RandomState "
        "instance"
    )


def sample_without_replacement(n_population, n_samples, random_state=None):
    """``n_samples`` distinct integers of ``[0, n_population)``, drawn as
    scikit-learn's ``method="auto"`` draws them: a permutation when the
    ratio ``n_samples / n_population`` lies strictly between 0.01 and
    0.99, else tracking selection below a ratio of 0.2 and reservoir
    sampling from it."""
    n_population, n_samples = int(n_population), int(n_samples)
    if n_population < 0:
        raise ValueError(
            f"n_population should be greater than 0, got {n_population}.")
    if n_samples > n_population:
        raise ValueError(
            "n_population should be greater or equal than n_samples, got "
            f"n_samples > n_population ({n_samples} > {n_population})")
    rng = check_random_state(random_state)
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, dtype=int)
    if ratio < 0.2:  # tracking selection
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
    else:  # reservoir sampling
        out[:] = np.arange(n_samples)
        for i in range(n_samples, n_population):
            j = rng.randint(0, i + 1)
            if j < n_samples:
                out[j] = i
    return out


class ParameterSampler:
    """``n_iter`` candidates drawn from a dict (or list of dicts) of
    value lists and distributions (objects with ``rvs``), as
    scikit-learn's ``ParameterSampler``: when every value is a list,
    ``n_iter`` distinct grid points (capped at the grid's size, with a
    warning) through :func:`sample_without_replacement`; otherwise, per
    candidate, a dict drawn uniformly, then its keys in sorted order,
    ``v.rvs(random_state=rng)`` for a distribution and
    ``v[rng.randint(len(v))]`` for a list."""

    def __init__(self, param_distributions, n_iter, *, random_state=None):
        if not isinstance(param_distributions, (Mapping, Iterable)):
            raise TypeError(
                "Parameter distribution is not a dict or a list, got: "
                f"{param_distributions!r} of type "
                f"{type(param_distributions).__name__}"
            )
        if isinstance(param_distributions, Mapping):
            param_distributions = [param_distributions]
        for dist in param_distributions:
            if not isinstance(dist, dict):
                raise TypeError(f"Parameter distribution is not a dict ({dist!r})")
            for key, value in dist.items():
                if not isinstance(value, Iterable) and not hasattr(value, "rvs"):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} is not "
                        f"iterable or a distribution (value={value})"
                    )
        self.n_iter = n_iter
        self.random_state = random_state
        self.param_distributions = param_distributions

    def _is_all_lists(self):
        return all(not hasattr(v, "rvs")
                   for dist in self.param_distributions
                   for v in dist.values())

    def __iter__(self):
        rng = check_random_state(self.random_state)
        if self._is_all_lists():
            grid = ParameterGrid(self.param_distributions)
            grid_size = len(grid)
            n_iter = self.n_iter
            if grid_size < n_iter:
                warnings.warn(
                    f"The total space of parameters {grid_size} is smaller "
                    f"than n_iter={self.n_iter}. Running {grid_size} "
                    "iterations. For exhaustive searches, use "
                    "GridSearchCV.",
                    UserWarning,
                )
                n_iter = grid_size
            for i in sample_without_replacement(grid_size, n_iter,
                                                random_state=rng):
                yield grid[i]
            return
        for _ in range(self.n_iter):
            dist = rng.choice(self.param_distributions)
            params = {}
            for key, value in sorted(dist.items()):
                if hasattr(value, "rvs"):
                    params[key] = value.rvs(random_state=rng)
                else:
                    params[key] = value[rng.randint(len(value))]
            yield params

    def __len__(self):
        if self._is_all_lists():
            return min(self.n_iter, len(ParameterGrid(self.param_distributions)))
        return self.n_iter
