"""
Distributed forests of the port.

Counterpart of ``skdist_tpu/distribute/ensemble.py``. The ``Dist*``
classes add ``backend``/``partitions`` to the port's forests and route
the tree axis through ``backend.batched_map``: ``backend=None`` means
``CUDABackend`` on the forest's ``device`` (the card unless
``device="cpu"``), and ``partitions`` sets the number of rounds (an int)
or leaves it to the device memory (``"auto"``). After fit the backend
handle is stripped, so the artifact pickles clean.

``n_jobs`` sets the host C engine's threads and walker's on the CPU
(``models/forest.py``); the ``Dist*`` forests' default ``CUDABackend``
runs a batched kernel, so their ``hist_mode="auto"`` never picks that
engine: pass ``backend=LocalBackend(device="cpu")`` for it, as the JAX
package's default ``LocalBackend`` does.

``DistForestClassifier``/``DistForestRegressor`` are the
bring-your-own-base forests: any estimator with ``fit`` and
``predict``/``predict_proba``, one clone a tree, fitted on the backend's
host threads (``run_tasks``).
"""

import inspect

import numpy as np

from ..base import BaseEstimator, clone, strip_runtime
from ..models.forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    RandomTreesEmbedding,
)
from ..parallel import (
    CUDABackend,
    LocalBackend,
    parse_partitions,
    resolve_backend,
)
from ..utils.cv import KFold
from ..utils.validation import check_estimator_backend, safe_indexing

__all__ = [
    "DistForestClassifier",
    "DistForestRegressor",
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
                 random_state=None, n_jobs=None, verbose=0,
                 hist_mode="auto", device=None):
        RandomForestClassifier.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, class_weight=class_weight,
            warm_start=warm_start, random_state=random_state, n_jobs=n_jobs,
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
                 warm_start=False, random_state=None, n_jobs=None,
                 verbose=0, hist_mode="auto", device=None):
        RandomForestRegressor.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, n_jobs=n_jobs, hist_mode=hist_mode,
            device=device,
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
                 random_state=None, n_jobs=None, verbose=0,
                 hist_mode="auto", device=None):
        ExtraTreesClassifier.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, class_weight=class_weight,
            warm_start=warm_start, random_state=random_state, n_jobs=n_jobs,
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
                 warm_start=False, random_state=None, n_jobs=None,
                 verbose=0, hist_mode="auto", device=None):
        ExtraTreesRegressor.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, n_jobs=n_jobs, hist_mode=hist_mode,
            device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose


class DistRandomTreesEmbedding(_DistForestMixin, RandomTreesEmbedding):
    def __init__(self, n_estimators=100, backend=None, partitions="auto",
                 max_depth=5, n_bins=32, min_samples_split=2,
                 min_samples_leaf=1, min_impurity_decrease=0.0,
                 sparse_output=True, warm_start=False, random_state=None,
                 n_jobs=None, verbose=0, hist_mode="auto", device=None):
        RandomTreesEmbedding.__init__(
            self, n_estimators=n_estimators, max_depth=max_depth,
            n_bins=n_bins, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease,
            sparse_output=sparse_output, warm_start=warm_start,
            random_state=random_state, n_jobs=n_jobs, hist_mode=hist_mode,
            device=device,
        )
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose

    def fit_transform(self, X, y=None, sample_weight=None):
        return self.fit(X, y, sample_weight=sample_weight).transform(X)


# ---------------------------------------------------------------------------
# bring-your-own-base forests: any estimator, one clone a tree
# ---------------------------------------------------------------------------

class _DistBaseEstimatorForest(BaseEstimator):
    """A forest of clones of ``base_estimator``, one a tree, fitted as
    host tasks of the backend (``run_tasks``), in ``partitions`` rounds
    (``"auto"``: one). ``backend=None`` is a ``LocalBackend`` over
    ``n_jobs`` threads on the base's ``device`` (the CPU for a base with
    none: the backend itself only fans out host threads).

    Tree ``t`` takes seed ``t`` of ``RandomState(random_state).randint(
    2**31 - 1, size=n_estimators)`` as its ``random_state`` (when the
    base has one) and, under ``bootstrap``, draws ``n`` row indices from
    ``RandomState(seed)``: a base whose ``fit`` takes ``sample_weight``
    fits all of X under the indices' bincount weights, another fits the
    resampled rows. A caller's ``sample_weight`` multiplies the bootstrap
    weights. The JAX package's semantics, with the port's ``clone``."""

    def __init__(self, base_estimator, backend=None, partitions="auto",
                 n_estimators=100, bootstrap=True, random_state=None,
                 n_jobs=None, verbose=0):
        self.base_estimator = base_estimator
        self.backend = backend
        self.partitions = partitions
        self.n_estimators = n_estimators
        self.bootstrap = bootstrap
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.verbose = verbose

    def fit(self, X, y, **fit_params):
        check_estimator_backend(self, self.verbose)
        if self.backend is None:
            backend = LocalBackend(
                n_jobs=self.n_jobs,
                device=getattr(self.base_estimator, "device", "cpu"))
        else:
            backend = resolve_backend(self.backend, n_jobs=self.n_jobs)
        n = X.shape[0] if hasattr(X, "shape") else len(X)
        y_arr = np.asarray(y)
        self._set_fit_targets(y_arr)
        rng = np.random.RandomState(self.random_state)
        seeds = rng.randint(np.iinfo(np.int32).max, size=self.n_estimators)
        try:
            takes_weight = "sample_weight" in inspect.signature(
                self.base_estimator.fit).parameters
        except (TypeError, ValueError):
            takes_weight = True
        bootstrap = self.bootstrap
        fit_params = dict(fit_params)
        user_weight = fit_params.pop("sample_weight", None)
        if user_weight is not None:
            user_weight = np.asarray(user_weight, dtype=np.float64)

        def build_one(seed):
            est = clone(self.base_estimator)
            if "random_state" in est.get_params():
                est.set_params(random_state=int(seed))
            if not bootstrap:
                if user_weight is not None and takes_weight:
                    est.fit(X, y_arr, sample_weight=user_weight,
                            **fit_params)
                else:
                    est.fit(X, y_arr, **fit_params)
                return est
            idx = np.random.RandomState(seed).randint(0, n, n)
            if takes_weight:
                sw = np.bincount(idx, minlength=n).astype(np.float64)
                if user_weight is not None:
                    sw = sw * user_weight
                est.fit(X, y_arr, sample_weight=sw, **fit_params)
            else:
                est.fit(safe_indexing(X, idx), y_arr[idx], **fit_params)
            return est

        round_size = parse_partitions(self.partitions, len(seeds))
        self.estimators_ = []
        for start in range(0, len(seeds), round_size):
            self.estimators_.extend(backend.run_tasks(
                build_one, seeds[start:start + round_size],
                verbose=self.verbose))
        self.n_features_in_ = X.shape[1] if hasattr(X, "shape") else None
        strip_runtime(self)
        return self

    def __len__(self):
        return len(self.estimators_)

    def __getitem__(self, index):
        return self.estimators_[index]


class DistForestClassifier(_DistBaseEstimatorForest):
    """A forest of clones of a classifier ``base_estimator``; the mean of
    their ``predict_proba`` (a base without one votes with ``predict``)."""

    _estimator_type = "classifier"

    def _set_fit_targets(self, y_arr):
        self.classes_ = np.unique(y_arr)

    def predict_proba(self, X):
        n = X.shape[0] if hasattr(X, "shape") else len(X)
        agg = np.zeros((n, len(self.classes_)))
        for est in self.estimators_:
            if hasattr(est, "predict_proba"):
                proba = np.asarray(est.predict_proba(X))
                agg[:, np.searchsorted(self.classes_, est.classes_)] += proba
            else:
                preds = np.searchsorted(self.classes_, est.predict(X))
                agg[np.arange(len(preds)), preds] += 1.0
        return agg / len(self.estimators_)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))


class DistForestRegressor(_DistBaseEstimatorForest):
    """A forest of clones of a regressor ``base_estimator``; the mean of
    their predictions."""

    _estimator_type = "regressor"

    def _set_fit_targets(self, y_arr):
        pass

    def predict(self, X):
        return np.mean(
            [np.asarray(est.predict(X)) for est in self.estimators_], axis=0)

    def score(self, X, y):
        y = np.asarray(y, dtype=np.float64)
        resid = y - self.predict(X)
        denom = np.sum((y - y.mean()) ** 2)
        return float(1.0 - np.sum(resid ** 2) / denom) if denom else 0.0
