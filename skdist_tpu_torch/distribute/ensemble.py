"""
Distributed forests of the port.

Counterpart of ``skdist_tpu/distribute/ensemble.py``. The ``Dist*``
classes add ``backend``/``partitions`` to the port's forests and route
the tree axis through ``backend.batched_map``: ``backend=None`` means
``CUDABackend`` on the forest's ``device`` (the card unless
``device="cpu"``), and ``partitions`` sets the number of rounds (an int)
or leaves it to the device memory (``"auto"``). After fit the backend
handle is stripped, so the artifact pickles clean.

Not ported yet (ROADMAP P8): the bring-your-own-base
``DistForestClassifier``/``DistForestRegressor``, which need the generic
search path's host fan-out.
"""

import numpy as np

from ..base import strip_runtime
from ..models.forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    RandomTreesEmbedding,
)
from ..parallel import CUDABackend, parse_partitions
from ..utils.cv import KFold
from ..utils.validation import check_estimator_backend, safe_indexing

__all__ = [
    "DistRandomForestClassifier",
    "DistRandomForestRegressor",
    "DistExtraTreesClassifier",
    "DistExtraTreesRegressor",
    "DistRandomTreesEmbedding",
    "get_oof",
    "get_single_oof",
]


def get_single_oof(clf, X, y, train_index, test_index):
    """Fit on the train index, ``predict_proba`` on the test index."""
    X_train = safe_indexing(X, train_index)
    X_test = safe_indexing(X, test_index)
    y = np.asarray(y)
    clf.fit(X_train, y[train_index])
    return test_index, clf.predict_proba(X_test)


def get_oof(clf, X, y, n_splits=5):
    """Out-of-fold probabilities over ``KFold(n_splits)``, then a final
    fit on all of X. Returns ``(clf, oof_train)``."""
    y = np.asarray(y)
    oof_train = np.zeros((y.shape[0], len(np.unique(y))))
    # KFold.split only needs len(X); pass X as-is so ragged lists work
    for train_index, test_index in KFold(n_splits=n_splits).split(X):
        test_index, proba = get_single_oof(
            clf, X, y, train_index, test_index
        )
        oof_train[test_index] = proba
    clf.fit(X, y)
    return clf, oof_train


class _DistForestMixin:
    """Adds backend/partitions routing to a forest class: the forest's
    ``fit`` calls ``_resolve_fit_backend`` for its ``batched_map``."""

    def _resolve_fit_backend(self):
        backend = self.backend
        if backend is None:
            backend = CUDABackend(device=self.device)
        n_more = self.n_estimators - (
            int(self._trees["feat"].shape[0])
            if self.warm_start and hasattr(self, "_trees")
            else 0
        )
        round_size = parse_partitions(self.partitions, max(n_more, 1))
        return backend, round_size

    def fit(self, X, y=None, sample_weight=None):
        check_estimator_backend(self, self.verbose)
        super().fit(X, y, sample_weight=sample_weight)
        strip_runtime(self)
        return self


class DistRandomForestClassifier(_DistForestMixin, RandomForestClassifier):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=8, n_bins=32, max_features="sqrt",
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=True, oob_score=False,
                 class_weight=None, warm_start=False,
                 random_state=None, verbose=0, hist_mode="auto",
                 device=None):
        RandomForestClassifier.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, class_weight=class_weight,
            warm_start=warm_start, random_state=random_state,
            hist_mode=hist_mode, device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose


class DistRandomForestRegressor(_DistForestMixin, RandomForestRegressor):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=8, n_bins=32, max_features=1.0,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=True, oob_score=False,
                 warm_start=False, random_state=None, verbose=0,
                 hist_mode="auto", device=None):
        RandomForestRegressor.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, hist_mode=hist_mode, device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose


class DistExtraTreesClassifier(_DistForestMixin, ExtraTreesClassifier):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=8, n_bins=32, max_features="sqrt",
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=False, oob_score=False,
                 class_weight=None, warm_start=False,
                 random_state=None, verbose=0, hist_mode="auto",
                 device=None):
        ExtraTreesClassifier.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, class_weight=class_weight,
            warm_start=warm_start, random_state=random_state,
            hist_mode=hist_mode, device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose


class DistExtraTreesRegressor(_DistForestMixin, ExtraTreesRegressor):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=8, n_bins=32, max_features=1.0,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=False, oob_score=False,
                 warm_start=False, random_state=None, verbose=0,
                 hist_mode="auto", device=None):
        ExtraTreesRegressor.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, hist_mode=hist_mode, device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose


class DistRandomTreesEmbedding(_DistForestMixin, RandomTreesEmbedding):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=5, n_bins=32, min_samples_split=2,
                 min_samples_leaf=1, min_impurity_decrease=0.0,
                 sparse_output=True, warm_start=False, random_state=None,
                 verbose=0, hist_mode="auto", device=None):
        RandomTreesEmbedding.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease,
            sparse_output=sparse_output, warm_start=warm_start,
            random_state=random_state, hist_mode=hist_mode, device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose

    def fit_transform(self, X, y=None, sample_weight=None):
        return self.fit(X, y, sample_weight=sample_weight).transform(X)
