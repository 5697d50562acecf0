"""
Distributed feature elimination of the port: ``DistFeatureEliminator``,
the counterpart of ``skdist_tpu/distribute/eliminate.py``.

A one-shot parallel approximation of scikit-learn's ``RFECV``: an
initial fit on every column ranks the features by ``coef_`` (or
``feature_importances_``), ``step`` builds nested removal sets from that
ranking, every (feature set x CV fold) pair is fitted and scored, and
the best set (ties to the smaller one; a NaN set never wins) is refit.

A removal set is a 0/1 column mask a task. Where the estimator's family
has a batched fit (the linear families, ``MultinomialNB``, the single
trees), the whole (set x fold) grid runs as batched rounds on the card
with the mask riding the task axis, as in the JAX package's one vmapped
program over ``X * fmask``. Here no task gets a masked copy of X: the
family applies the mask to what is indexed by column
(``_mask_operand``, ``_mask_decision_params``). The linear families fit
through a :class:`~skdist_tpu_torch.sparse.MaskedLinearOperator`
(``X @ (m * W)``, ``m * (X.T @ r)``, ``(m m.T) * G``), ``MultinomialNB``
masks its per-class counts, and a tree never splits a masked feature
(``build_tree_kernel(feature_mask=...)``: one K4 launch a level over the
shared bins, as without masks). Each gives what ``X * fmask`` gives: a
zeroed column's weight stays 0, its count is 0, and as a constant column
it never yields a valid split. The classic path runs
``backend.batched_map``; a family with sliced fits takes the
convergence-compacted path, where ``adaptive=HalvingSpec(...)`` races
the feature sets on ASHA rungs (a set's fold lanes live and die
together; killed sets score NaN and ``rung_`` records where each died).

Everything else (an estimator without a batched fit, a host scorer, fit
params, an input that cannot be densified, an estimator that runs its
f64 host engine on the backend) takes the generic path: every (set x
fold) task fits a clone on the column-dropped X through the search's
``_fit_and_score``, fanned out by ``backend.run_tasks``.

``backend=None`` is a ``CUDABackend`` on the estimator's ``device`` with
``n_jobs`` host threads, as in the port's searches (the JAX package's
is its ``LocalBackend``). Sparse X is kept as given on the generic path
(the JAX package's ``fit`` takes dense input only).
"""

import time
import warnings
from itertools import product

import numpy as np

from ..base import BaseEstimator, clone, strip_runtime
from ..metrics import check_multimetric_scoring, resolve_rung_scorer
from ..parallel import (
    CUDABackend,
    RungController,
    iterative_chunk_size,
    iterative_fit_supported,
    parse_partitions,
    prefers_host_engine,
    resolve_backend,
)
from ..utils.cv import check_cv
from ..utils.validation import check_estimator_backend, check_is_fitted
from .adaptive import RungKilledWarning, check_adaptive, warn_not_engaged
from .search import (
    _build_cv_kernel,
    _cv_iterative_spec,
    _fit_and_score,
    _resolve_device_scoring,
)

__all__ = ["DistFeatureEliminator"]


def _take_cols(X, keep):
    """The columns ``keep`` of ``X``: a numpy array, a scipy sparse
    matrix (through CSC) or a frame with ``.iloc``."""
    if hasattr(X, "iloc"):
        return X.iloc[:, keep]
    if hasattr(X, "tocsc"):
        return X.tocsc()[:, keep].tocsr()
    return np.asarray(X)[:, keep]


def _drop_col(X, cols):
    """``X`` without the columns ``cols``."""
    if len(cols) == 0:
        return X
    return _take_cols(X, np.setdiff1d(np.arange(X.shape[1]), cols))


class DistFeatureEliminator(BaseEstimator):
    """Feature elimination over (feature set x fold) fits, batched on the
    card where the estimator's family allows; the JAX package's
    constructor arguments (``backend`` replaces the reference's ``sc``).

    ``min_features_to_select`` (default half the columns) bounds the
    removals; ``step`` removes that many of the lowest-ranked features a
    set (a fraction below 1 is a share of the columns). ``mask=False``
    hands the refit model the full-width X at predict time.

    Fitted: ``scores_`` (a set's mean CV score, NaN when its fits failed
    or a rung killed it), ``best_features_``, ``n_features_``,
    ``best_score_``, ``estimator_`` (also ``best_estimator_``), with
    ``adaptive`` ``rung_``, and ``round_stats_`` (the scheduler's counts
    of the grid: ``mode`` ``"classic"``, ``"compacted"`` or
    ``"generic"``)."""

    def __init__(self, estimator, backend=None, partitions="auto",
                 min_features_to_select=None, step=1, cv=5, scoring=None,
                 verbose=False, n_jobs=None, mask=True, adaptive=None):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.min_features_to_select = min_features_to_select
        self.step = step
        self.cv = cv
        self.scoring = scoring
        self.verbose = verbose
        self.n_jobs = n_jobs
        self.mask = mask
        self.adaptive = adaptive

    # ------------------------------------------------------------------
    def fit(self, X, y=None, groups=None, **fit_params):
        check_adaptive(self.adaptive)
        self._adaptive_engaged_ = False
        self._rung_per_set_ = None
        check_estimator_backend(self, self.verbose)
        if self.backend is None:
            backend = CUDABackend(
                device=getattr(self.estimator, "device", None),
                n_jobs=self.n_jobs)
        else:
            backend = resolve_backend(self.backend, n_jobs=self.n_jobs)
        X_arr = X if hasattr(X, "iloc") or hasattr(X, "tocsc") \
            else np.asarray(X)
        n_features = X_arr.shape[1]
        if n_features < 2:
            raise ValueError("X must have at least 2 features")
        is_classifier = (
            getattr(self.estimator, "_estimator_type", None) == "classifier"
        )
        cv = check_cv(self.cv, y, classifier=is_classifier)
        splits = list(cv.split(X_arr, y, groups))

        min_keep = (
            n_features // 2
            if self.min_features_to_select is None
            else self.min_features_to_select
        )
        step = (
            int(max(1, self.step * n_features))
            if 0.0 < self.step < 1.0
            else int(self.step)
        )
        if step <= 0:
            raise ValueError("Step must be >0")

        # the initial fit on every column ranks the features
        initial = clone(self.estimator)
        initial.fit(X_arr, y, **fit_params)
        coefs = getattr(initial, "coef_", None)
        if coefs is None:
            coefs = getattr(initial, "feature_importances_", None)
        if coefs is None:
            raise RuntimeError(
                'The estimator does not expose "coef_" or '
                '"feature_importances_" attributes'
            )
        # scikit-learn's safe_sqr, of the dense array
        sq = np.asarray(coefs) ** 2
        ranks = np.argsort(sq.sum(axis=0) if sq.ndim > 1 else sq)
        ranks = np.ravel(ranks)[: n_features - min_keep]

        features_to_remove = [np.array([], dtype=int)]
        removed = 0
        while removed < n_features - min_keep:
            removed += step
            features_to_remove.append(ranks[:removed])

        scores = self._score_feature_sets(
            backend, X_arr, y, splits, features_to_remove, fit_params
        )
        self.scores_ = scores
        if self.adaptive is not None:
            if not self._adaptive_engaged_:
                warn_not_engaged("the eliminator")
            # the rung at which each feature set died (-1: ran to the end)
            self.rung_ = (
                self._rung_per_set_
                if self._rung_per_set_ is not None
                else np.full(len(features_to_remove), -1, np.int32)
            )
        del self._adaptive_engaged_, self._rung_per_set_
        # a NaN set (failed folds, a rung kill) never wins: np.argmax
        # takes NaN for the maximum, so rank it -inf; every set NaN raises
        sel = np.asarray(scores, dtype=np.float64)
        if np.all(np.isnan(sel)):
            raise RuntimeError(
                "All feature-set fits failed (every CV score is NaN); "
                "cannot select best_features_."
            )
        sel = np.where(np.isnan(sel), -np.inf, sel)
        # ties go to the smaller set (sets are in increasing removal, so
        # the last argmax)
        best = int(len(sel) - 1 - np.argmax(sel[::-1]))
        self.best_score_ = float(scores[best])
        self.best_features_ = np.setdiff1d(
            np.arange(n_features), features_to_remove[best]
        )
        self.n_features_ = len(self.best_features_)

        final = clone(self.estimator)
        final.fit(self._apply_mask(X_arr), y, **fit_params)
        self.estimator_ = final
        self.estimator = clone(self.estimator)
        strip_runtime(self)
        return self

    def _score_feature_sets(self, backend, X, y, splits, features_to_remove,
                            fit_params):
        """The mean CV score of every feature set: batched on the
        backend's device where the estimator and scoring allow, else
        through the generic path."""
        n_sets = len(features_to_remove)
        n_splits = len(splits)
        out = None
        if not fit_params:
            out = self._try_batched(backend, X, y, splits, features_to_remove)
        if out is None:
            scorers, multimetric = check_multimetric_scoring(
                self.estimator, self.scoring
            )
            if multimetric:
                raise ValueError(
                    "DistFeatureEliminator supports single-metric scoring"
                )
            tasks = list(product(range(n_sets), range(n_splits)))

            def run_one(task):
                set_idx, split_idx = task
                train, test = splits[split_idx]
                Xs = _drop_col(X, features_to_remove[set_idx])
                return _fit_and_score(
                    self.estimator, Xs, y, scorers, train, test, {},
                    fit_params=fit_params,
                )["test_score"]

            t0 = time.perf_counter()
            flat = backend.run_tasks(run_one, tasks, verbose=self.verbose)
            self.round_stats_ = [{"mode": "generic", "tasks": len(tasks),
                                  "wall_s": time.perf_counter() - t0}]
            out = np.asarray(flat, dtype=np.float64).reshape(
                n_sets, n_splits
            )
        return out.mean(axis=1)

    def _try_batched(self, backend, X, y, splits, features_to_remove):
        """The (set x fold) scores ``(n_sets, n_splits)`` from batched
        rounds with the column masks on the task axis (``fmask``), or
        None where the batched path cannot take the grid: a family with
        no masked fit, the f64 host engine on this backend, a scorer
        with no device kernel here, an input that cannot be densified or
        that the family's data prep refuses."""
        from ..models.linear import _freeze, as_dense_f32, hyper_float

        est = self.estimator
        est_cls = type(est)
        if not hasattr(est_cls, "_build_fit_kernel") \
                or getattr(est_cls, "_mask_operand", None) is None:
            return None
        if prefers_host_engine(backend, est):
            return None
        classes = np.unique(y) if y is not None else None
        scorer_specs = _resolve_device_scoring(est, self.scoring, classes)
        if scorer_specs is None or len(scorer_specs) != 1 \
                or scorer_specs[0][0] != "score":
            return None
        if scorer_specs[0][3] == "proba" \
                and not hasattr(est_cls, "_build_proba_kernel"):
            return None
        est._check_supported()
        try:
            # a sparse input too wide to densify, or one the family's own
            # checks refuse (MultinomialNB's negative counts), fits per
            # task on the generic path, as in the JAX package
            X_arr = as_dense_f32(X)
            data, meta = est._prep_fit_data(X_arr, y, None)
        except (ValueError, TypeError, MemoryError):
            return None
        n, d = X_arr.shape
        n_splits = len(splits)
        train_masks = np.zeros((n_splits, n), dtype=np.float32)
        test_masks = np.zeros((n_splits, n), dtype=np.float32)
        for i, (train, test) in enumerate(splits):
            train_masks[i, train] = 1.0
            test_masks[i, test] = 1.0
        n_sets = len(features_to_remove)
        fmasks = np.ones((n_sets, d), dtype=np.float32)
        for i, rem in enumerate(features_to_remove):
            fmasks[i, rem] = 0.0

        static = _freeze(est._static_config(meta))
        n_tasks = n_sets * n_splits
        # the estimator's own hypers on every task: the CV kernels read
        # task["hyper"]
        task_args = {
            "fmask": np.repeat(fmasks, n_splits, axis=0),
            "split": np.tile(np.arange(n_splits, dtype=np.int64), n_sets),
            "hyper": {
                k: np.full(n_tasks, hyper_float(getattr(est, k)),
                           dtype=np.float32)
                for k in est_cls._hyper_names
            },
        }
        shared = backend.place({
            "X": data["X"], "y": data["y"], "sw": data["sw"],
            "train_masks": train_masks, "test_masks": test_masks,
        })
        shared["op"] = est_cls._fit_operand(shared["X"], meta, static)
        # a masked task holds its mask leaf and what its family's masked
        # products keep, beside an unmasked task's bytes
        sizes = dict(
            bytes_per_task=est_cls._batched_task_bytes(meta, static, n)
            + est_cls._mask_task_bytes(meta, static) + 4 * d,
            bytes_per_round=est_cls._batched_round_bytes(meta, static, n),
        )
        kernel = _build_cv_kernel(est_cls, meta, static, scorer_specs, False,
                                  mask_x=True)
        n_slice = iterative_fit_supported(
            backend, est_cls, n_tasks, dict(static).get("max_iter"))
        if n_slice is not None:
            flat = self._run_iterative(
                backend, est_cls, meta, static, scorer_specs, kernel,
                task_args, shared, sizes, n_sets, n_splits, n_slice, classes)
        else:
            scores = backend.batched_map(
                kernel, task_args, shared,
                round_size=parse_partitions(self.partitions, n_tasks),
                **sizes)
            flat = np.asarray(scores["test_score"], dtype=np.float64)
        self.round_stats_ = [dict(backend.last_round_stats,
                                  x_format=meta["x_format"])]
        return flat.reshape(n_sets, n_splits)

    def _run_iterative(self, backend, est_cls, meta, static, scorer_specs,
                       kernel, task_args, shared, sizes, n_sets, n_splits,
                       n_slice, classes):
        """The (set x fold) scores from the convergence-compacted path
        (the searches' ``_cv_iterative_spec`` under ``mask_x``),
        racing the sets on ASHA rungs under ``adaptive``: a killed set
        scores NaN, its rung lands in ``rung_`` and one
        :class:`RungKilledWarning` says how many lanes were retired."""
        n_tasks = n_sets * n_splits
        rung_ctrl = rung_spec = None
        if self.adaptive is not None:
            rung_spec = resolve_rung_scorer(
                self.adaptive.metric, scorer_specs, True, classes,
                est_cls=est_cls)
            if rung_spec is not None:
                # group = feature set: its fold lanes live and die
                # together on their mean rung score
                rung_ctrl = RungController(
                    self.adaptive.eta, self.adaptive.min_slices,
                    groups=np.repeat(np.arange(n_sets), n_splits))
        spec = _cv_iterative_spec(
            est_cls, meta, static, scorer_specs, False, n_slice,
            fallback=kernel, rung_spec=rung_spec, mask_x=True)
        round_size = (None if self.partitions in ("auto", None)
                      else parse_partitions(self.partitions, n_tasks))
        target = getattr(est_cls, "_compacted_rounds", None)
        if round_size is None and target:
            round_size = iterative_chunk_size(n_tasks, 1, target)
        scores = backend.batched_map_iterative(
            spec, task_args, shared, round_size=round_size, rung=rung_ctrl,
            **sizes)
        flat = np.asarray(scores["test_score"], dtype=np.float64)
        if rung_ctrl is not None and rung_ctrl.active:
            # a downgrade to the exhaustive path deactivates the
            # controller, and fit's could-not-engage warning fires
            self._adaptive_engaged_ = True
        if rung_ctrl is not None and rung_ctrl.killed:
            rungs = np.full(n_sets, -1, np.int32)
            for lane, r in rung_ctrl.killed.items():
                flat[lane] = np.nan
                s = int(lane) // n_splits
                rungs[s] = max(rungs[s], int(r))
            self._rung_per_set_ = rungs
            warnings.warn(
                f"{len(rung_ctrl.killed)} of {n_tasks} feature-set "
                "fits were retired early by adaptive successive "
                "halving; their sets score NaN and rung_ records "
                "where each died.",
                RungKilledWarning,
            )
        return flat

    # ------------------------------------------------------------------
    def _apply_mask(self, X):
        """``X`` cut to the best feature set (unless ``mask=False``)."""
        if not self.mask:
            return X
        return _take_cols(X, self.best_features_)

    @property
    def best_estimator_(self):
        """The refit model, under the name the reference exposes."""
        check_is_fitted(self, "estimator_")
        return self.estimator_

    def predict(self, X):
        check_is_fitted(self, "estimator_")
        return self.estimator_.predict(self._apply_mask(X))

    def predict_proba(self, X):
        check_is_fitted(self, "estimator_")
        return self.estimator_.predict_proba(self._apply_mask(X))

    def predict_log_proba(self, X):
        check_is_fitted(self, "estimator_")
        return self.estimator_.predict_log_proba(self._apply_mask(X))

    def decision_function(self, X):
        check_is_fitted(self, "estimator_")
        return self.estimator_.decision_function(self._apply_mask(X))

    def score(self, X, y=None):
        check_is_fitted(self, "estimator_")
        return self.estimator_.score(self._apply_mask(X), y)

    @property
    def classes_(self):
        check_is_fitted(self, "estimator_")
        return self.estimator_.classes_
