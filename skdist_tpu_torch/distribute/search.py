"""
Distributed hyperparameter search of the port: ``DistGridSearchCV``.

Counterpart of ``skdist_tpu/distribute/search.py``'s batched device
path. Candidates are bucketed by the params that shape the kernel;
within a bucket the numeric hyperparameters (``C``, ``tol``) are stacked
onto a task axis together with a fold id, and the backend runs the
bucket's (candidate x fold) tasks as batched fits in rounds on the card.
CV folds are 0/1 weight masks, and the scores of every task are computed
on the device in the same round as its fit.

``cv_results_`` has sklearn's schema: ``split{i}_test_*``,
``mean/std/rank_test_*`` (rank by the min method, failed fits last),
masked ``param_*`` arrays and fit/score times. The best candidate is
refit, and runtime handles are stripped after fit so the artifact
pickles clean.

Not ported yet (ROADMAP): the generic per-task host path (estimators
without a batched fit, host scorers, fit params other than
``sample_weight``), ``DistRandomizedSearchCV``/``DistMultiModelSearch``,
checkpointing, out-of-fold ``preds``, adaptive (ASHA) search and
streamed input.
"""

import time
import warnings

import numpy as np
from numpy.ma import MaskedArray
from scipy.stats import rankdata

from ..base import BaseEstimator, clone, strip_runtime
from ..metrics import (
    BINARY_ONLY_SCORERS,
    DEVICE_SCORERS,
    DeviceScorer,
    default_device_scorer,
    device_scorer_compatible,
)
from ..parallel import CUDABackend, parse_partitions
from ..utils.cv import ParameterGrid, check_cv
from ..utils.validation import (
    check_error_score,
    check_is_fitted,
    full_length_sample_weight,
    num_samples,
)

__all__ = ["DistBaseSearchCV", "DistGridSearchCV", "FitFailedWarning"]

_ROADMAP = "see ROADMAP.md, queue 1"


class FitFailedWarning(RuntimeWarning):
    """Warning for per-task fits recorded as failed."""


def _not_ported(what):
    return NotImplementedError(
        f"{what} needs the generic (non-batched) search path, which is not "
        f"ported to skdist_tpu_torch yet ({_ROADMAP})"
    )


def _nan_as_worst(scores):
    """NaN scores (failed fits) rank strictly below the finite minimum."""
    scores = np.asarray(scores, dtype=np.float64)
    nan_mask = np.isnan(scores)
    if not nan_mask.any():
        return scores
    worst = np.nanmin(scores) - 1.0 if not nan_mask.all() else 0.0
    return np.where(nan_mask, worst, scores)


def _quarantine_nonfinite(out_rows, error_score):
    """A non-finite score can only mean a numerically diverged fit lane;
    map it to sklearn ``error_score`` semantics: 'raise' raises, a
    number substitutes with a :class:`FitFailedWarning`."""
    bad = [
        i for i, row in enumerate(out_rows)
        if any(k.startswith(("test_", "train_")) and not np.isfinite(v)
               for k, v in row.items())
    ]
    if not bad:
        return
    if error_score == "raise":
        raise RuntimeError(
            f"{len(bad)} batched search fit(s) produced non-finite scores "
            f"(diverged lanes, e.g. task {bad[0]}) and error_score='raise'."
        )
    warnings.warn(
        f"{len(bad)} of {len(out_rows)} batched search fits produced "
        f"non-finite scores (diverged lanes); their scores are set to "
        f"error_score={error_score!r}.",
        FitFailedWarning,
    )
    for i in bad:
        for k in out_rows[i]:
            if k.startswith(("test_", "train_")):
                out_rows[i][k] = float(error_score)


def _candidate_buckets(estimator, candidate_params):
    """Group candidate indices by their kernel-shaping params."""
    from ..models.linear import _freeze

    hyper_names = set(getattr(type(estimator), "_hyper_names", ()))
    static_names = set(getattr(type(estimator), "_static_names", ()))
    buckets = {}
    for idx, cand in enumerate(candidate_params):
        for name in cand:
            if name not in hyper_names and name not in static_names:
                raise _not_ported(f"searching {name!r}")
        overrides = {k: v for k, v in cand.items() if k in static_names}
        buckets.setdefault(_freeze(overrides), (overrides, []))[1].append(idx)
    return buckets


def _resolve_device_scoring(estimator, scoring, classes):
    """``scoring`` -> ``([(out_name, metric, kernel, kind)], multimetric)``;
    raises for metrics with no device kernel."""
    if scoring is None:
        names, multimetric = [("score", default_device_scorer(estimator))], \
            False
    elif isinstance(scoring, str):
        names, multimetric = [("score", scoring)], False
    elif isinstance(scoring, (list, tuple, set)):
        names, multimetric = [(s, s) for s in scoring], True
    else:
        raise _not_ported(f"scoring={scoring!r}")
    specs = []
    for out_name, metric in names:
        if metric not in DEVICE_SCORERS:
            raise _not_ported(f"scoring {metric!r}")
        if metric in BINARY_ONLY_SCORERS and not device_scorer_compatible(
                metric, classes):
            raise _not_ported(f"scoring {metric!r} on this label set")
        kernel, kind = DEVICE_SCORERS[metric]
        specs.append((out_name, metric, kernel, kind))
    return specs, multimetric


def _build_cv_kernel(est_cls, meta, static, scorer_specs, return_train_score):
    """One round of (fold-masked batched fit + scores) over the tasks of
    ``task``: ``hyper`` ``{name: (T,)}`` and ``split (T,)``."""
    fit_kernel = est_cls._build_fit_kernel(meta, static)
    decision_kernel = est_cls._build_decision_kernel(meta, static)
    needs_proba = any(kind == "proba" for *_, kind in scorer_specs)
    proba_kernel = (
        est_cls._build_proba_kernel(meta, static) if needs_proba else None
    )

    def kernel(shared, task):
        X, y, sw = shared["X"], shared["y"], shared["sw"]
        # user sample_weight weights the FIT only; train/test scoring is
        # over the raw fold masks, like sklearn scorers without weights
        train_w = shared["train_masks"][task["split"]]
        test_w = shared["test_masks"][task["split"]]
        params = fit_kernel(shared["op"], y, sw * train_w, task["hyper"])
        outputs = {"decision": decision_kernel(params["W"], X)}
        outputs["predict"] = outputs["decision"]
        if proba_kernel is not None:
            outputs["proba"] = proba_kernel(params["W"], X)
        scores = {}
        for out_name, _metric, score_kernel, kind in scorer_specs:
            scores[f"test_{out_name}"] = score_kernel(
                y, outputs[kind], test_w, meta
            )
            if return_train_score:
                scores[f"train_{out_name}"] = score_kernel(
                    y, outputs[kind], train_w, meta
                )
        return scores

    return kernel


class DistBaseSearchCV(BaseEstimator):
    """Base class for distributed CV search over batched fits."""

    def __init__(self, estimator, backend=None, partitions="auto", cv=5,
                 scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, verbose=0):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.cv = cv
        self.scoring = scoring
        self.refit = refit
        self.return_train_score = return_train_score
        self.error_score = error_score
        self.verbose = verbose

    def _get_param_iterator(self):
        raise NotImplementedError

    def fit(self, X, y=None, groups=None, **fit_params):
        """Fit every (candidate x fold) task on the backend's device
        (``backend=None`` means ``CUDABackend`` on the estimator's
        ``device``), then refit the best candidate."""
        check_error_score(self.error_score)
        estimator = self.estimator
        if not hasattr(type(estimator), "_build_fit_kernel"):
            raise _not_ported(f"{type(estimator).__name__} (no batched fit)")
        if y is None:
            raise ValueError("DistGridSearchCV.fit needs y")
        backend = self.backend
        if backend is None:
            backend = CUDABackend(device=getattr(estimator, "device", None))
        is_classifier = getattr(estimator, "_estimator_type", None) == \
            "classifier"
        cv = check_cv(self.cv, y, classifier=is_classifier)
        n_splits = cv.get_n_splits(X, y, groups)
        candidate_params = list(self._get_param_iterator())
        if self.verbose:
            print(
                f"Fitting {n_splits} folds for each of "
                f"{len(candidate_params)} candidates, totalling "
                f"{len(candidate_params) * n_splits} fits"
            )
        splits = list(cv.split(X, y, groups))
        scorer_specs, multimetric = _resolve_device_scoring(
            estimator, self.scoring, np.unique(y)
        )
        self.multimetric_ = multimetric
        refit_metric = self._refit_metric(scorer_specs, multimetric)
        sw, sw_ok = full_length_sample_weight(fit_params, num_samples(X))
        if not sw_ok:
            raise _not_ported(f"fit params {sorted(fit_params)}")

        out = self._run_batched(backend, estimator, X, y, candidate_params,
                                splits, scorer_specs, sw)
        results = self._format_results(
            candidate_params, [s[0] for s in scorer_specs], n_splits, out
        )
        self.cv_results_ = results
        scorers = {name: DeviceScorer(metric)
                   for name, metric, _k, _kind in scorer_specs}
        self.scorer_ = scorers if multimetric else scorers["score"]
        self.n_splits_ = n_splits

        if self.refit or not multimetric:
            if np.all(np.isnan(results[f"mean_test_{refit_metric}"])):
                raise RuntimeError(
                    "All candidate fits failed (every "
                    f"mean_test_{refit_metric} is NaN)."
                )
            self.best_index_ = int(
                results[f"rank_test_{refit_metric}"].argmin()
            )
            self.best_params_ = candidate_params[self.best_index_]
            self.best_score_ = \
                results[f"mean_test_{refit_metric}"][self.best_index_]
        if self.refit:
            best = clone(estimator).set_params(**self.best_params_)
            refit_start = time.perf_counter()
            best.fit(X, y, **fit_params)
            self.refit_time_ = time.perf_counter() - refit_start
            self.best_estimator_ = best
        # detach from the user's template before stripping runtime handles
        self.estimator = clone(self.estimator)
        strip_runtime(self)
        return self

    def _refit_metric(self, scorer_specs, multimetric):
        if multimetric:
            names = [s[0] for s in scorer_specs]
            if not isinstance(self.refit, str) or self.refit not in names:
                if self.refit:
                    raise ValueError(
                        "For multi-metric scoring, refit must be the name "
                        "of the scorer used to find the best parameters."
                    )
            return self.refit if isinstance(self.refit, str) else None
        return "score"

    def _run_batched(self, backend, estimator, X, y, candidate_params,
                     splits, scorer_specs, sample_weight):
        """Dispatch (candidate x fold) tasks bucket by bucket; returns the
        per-task score dicts in task order (candidate-major, split
        fastest)."""
        from ..models.linear import _freeze, hyper_float, prepare_fit_X

        X_arr = prepare_fit_X(X, estimator)
        n = X_arr.shape[0]
        n_splits = len(splits)
        train_masks = np.zeros((n_splits, n), dtype=np.float32)
        test_masks = np.zeros((n_splits, n), dtype=np.float32)
        for i, (train, test) in enumerate(splits):
            train_masks[i, train] = 1.0
            test_masks[i, test] = 1.0

        out = [None] * (len(candidate_params) * n_splits)
        est_cls = type(estimator)
        hyper_names = list(est_cls._hyper_names)
        self.round_stats_ = []
        buckets = _candidate_buckets(estimator, candidate_params)
        for static_overrides, cand_indices in buckets.values():
            bucket_est = clone(estimator).set_params(**static_overrides)
            bucket_est._check_supported()
            data, meta = bucket_est._prep_fit_data(X_arr, y, sample_weight)
            static = _freeze(bucket_est._static_config(meta))
            kernel = _build_cv_kernel(est_cls, meta, static, scorer_specs,
                                      self.return_train_score)
            shared = backend.place({
                "X": data["X"], "y": data["y"], "sw": data["sw"],
                "train_masks": train_masks, "test_masks": test_masks,
            })
            shared["op"] = est_cls._linear_op(shared["X"], static)
            gids = [c * n_splits + s for c in cand_indices
                    for s in range(n_splits)]
            task_args = {
                "hyper": {
                    name: np.asarray([
                        hyper_float(candidate_params[g // n_splits].get(
                            name, getattr(bucket_est, name)))
                        for g in gids
                    ], dtype=np.float32)
                    for name in hyper_names
                },
                "split": np.asarray([g % n_splits for g in gids],
                                    dtype=np.int64),
            }
            scores, round_timings = backend.batched_map(
                kernel, task_args, shared,
                bytes_per_task=est_cls._batched_task_bytes(meta, static, n),
                round_size=parse_partitions(self.partitions, len(gids)),
                return_timings=True,
            )
            self.round_stats_.append(dict(backend.last_round_stats,
                                          x_format=meta["x_format"]))
            # per-task fit_time = its round's wall / tasks in that round
            # (fit and scoring run in one round: score_time is 0)
            per_task_time = np.concatenate([
                np.full(count, wall / max(count, 1))
                for wall, count in round_timings
            ])
            for t, gid in enumerate(gids):
                out[gid] = {k: float(v[t]) for k, v in scores.items()}
                out[gid]["fit_time"] = float(per_task_time[t])
                out[gid]["score_time"] = 0.0
            del shared
        _quarantine_nonfinite(out, self.error_score)
        return out

    def _format_results(self, candidate_params, scorer_names, n_splits, out):
        """sklearn-schema ``cv_results_``."""
        n_candidates = len(candidate_params)
        agg = {key: np.asarray([row[key] for row in out]) for key in out[0]}
        results = {}

        def _store(key_name, array, splits=False, rank=False):
            array = np.asarray(array, dtype=np.float64).reshape(
                n_candidates, n_splits
            )
            if splits:
                for i in range(n_splits):
                    results[f"split{i}_{key_name}"] = array[:, i]
            means = np.average(array, axis=1)
            results[f"mean_{key_name}"] = means
            results[f"std_{key_name}"] = np.sqrt(
                np.average((array - means[:, None]) ** 2, axis=1)
            )
            if rank:
                results[f"rank_{key_name}"] = np.asarray(
                    rankdata(-_nan_as_worst(means), method="min"),
                    dtype=np.int32,
                )

        _store("fit_time", agg["fit_time"])
        _store("score_time", agg["score_time"])

        param_results = {}
        for cand_idx, params in enumerate(candidate_params):
            for name, value in params.items():
                key = f"param_{name}"
                if key not in param_results:
                    param_results[key] = MaskedArray(
                        np.empty(n_candidates, dtype=object), mask=True
                    )
                param_results[key][cand_idx] = value
        results.update(param_results)
        results["params"] = candidate_params

        for name in scorer_names:
            _store(f"test_{name}", agg[f"test_{name}"], splits=True,
                   rank=True)
            if self.return_train_score:
                _store(f"train_{name}", agg[f"train_{name}"], splits=True)
        return results

    # post-fit delegation to the refit estimator
    def _check_refit(self, method):
        if not self.refit:
            raise AttributeError(f"{method} is not available: refit=False.")
        check_is_fitted(self, "best_estimator_")

    @property
    def classes_(self):
        self._check_refit("classes_")
        return self.best_estimator_.classes_

    def predict(self, X):
        self._check_refit("predict")
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        self._check_refit("predict_proba")
        return self.best_estimator_.predict_proba(X)

    def predict_log_proba(self, X):
        self._check_refit("predict_log_proba")
        return self.best_estimator_.predict_log_proba(X)

    def decision_function(self, X):
        self._check_refit("decision_function")
        return self.best_estimator_.decision_function(X)

    def score(self, X, y=None):
        check_is_fitted(self, "best_estimator_")
        scorer = self.scorer_[self.refit] if self.multimetric_ \
            else self.scorer_
        return scorer(self.best_estimator_, X, y)


class DistGridSearchCV(DistBaseSearchCV):
    """Exhaustive grid search with batched fits on the card; the
    contract of sklearn's GridSearchCV."""

    def __init__(self, estimator, param_grid, backend=None, partitions="auto",
                 cv=5, scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, verbose=0):
        super().__init__(
            estimator, backend=backend, partitions=partitions, cv=cv,
            scoring=scoring, refit=refit,
            return_train_score=return_train_score, error_score=error_score,
            verbose=verbose,
        )
        self.param_grid = param_grid

    def _get_param_iterator(self):
        return ParameterGrid(self.param_grid)
