"""
Distributed hyperparameter search of the port: ``DistGridSearchCV``.

Counterpart of ``skdist_tpu/distribute/search.py``'s batched device
path. Candidates are bucketed by the params that shape the kernel;
within a bucket the numeric hyperparameters (``C``, ``tol``, ``alpha``)
are stacked onto a task axis together with a fold id, and the backend
runs the bucket's (candidate x fold) tasks as batched fits in rounds on
the card.
CV folds are 0/1 weight masks, and the scores of every task are computed
on the device in the same round as its fit.

A bucket of at least ``MIN_ITER_TASKS`` tasks of a family with
iteration-sliced fits (``LogisticRegression``) takes the
convergence-compacted path (``CUDABackend.batched_map_iterative``), as
in the JAX package: its tasks are ordered by expected cost, solved in
slices, and finished lanes leave their slots; ``SKDIST_COMPACTION=0``
switches back to the classic path, and the results are the same bit for
bit. ``adaptive=HalvingSpec(...)`` adds asynchronous successive halving
on that path, where every round fits on the card at once; elsewhere the
search runs exhaustively and warns.

``cv_results_`` has sklearn's schema: ``split{i}_test_*``,
``mean/std/rank_test_*`` (rank by the min method, failed fits last),
masked ``param_*`` arrays and fit/score times. The best candidate is
refit, and runtime handles are stripped after fit so the artifact
pickles clean.

Not ported yet (ROADMAP): the generic per-task host path (estimators
without a batched fit, host scorers, fit params other than
``sample_weight``), ``DistRandomizedSearchCV``/``DistMultiModelSearch``,
checkpointing (and so the journaling of rung kills), out-of-fold
``preds``, streamed input and its streamed rungs, and fault retries of
the compacted path.
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
    resolve_rung_scorer,
    scorer_task_compatible,
)
from ..parallel import (
    CUDABackend,
    RungController,
    iterative_fit_supported,
    parse_partitions,
)
from ..utils.cv import ParameterGrid, check_cv
from ..utils.validation import (
    check_error_score,
    check_is_fitted,
    full_length_sample_weight,
    num_samples,
)
from .adaptive import (
    RungKilledWarning,
    check_adaptive,
    rung_per_candidate,
    warn_not_engaged,
)

__all__ = ["DistBaseSearchCV", "DistGridSearchCV", "FitFailedWarning",
           "RungKilledWarning"]

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


def _quarantine_nonfinite(out_rows, error_score, exempt=()):
    """A non-finite score can only mean a numerically diverged fit lane;
    map it to sklearn ``error_score`` semantics: 'raise' raises, a
    number substitutes with a :class:`FitFailedWarning`. Rows in
    ``exempt`` (rung kills, already mapped) are skipped."""
    bad = [
        i for i, row in enumerate(out_rows)
        if i not in exempt
        and any(k.startswith(("test_", "train_")) and not np.isfinite(v)
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


def _apply_rung_retirement(out_rows, killed, error_score):
    """Map rung-killed lanes (``{task id: rung}``) to sklearn rows: a
    numeric ``error_score`` substitutes for every test/train score, with
    one :class:`RungKilledWarning`. ``error_score='raise'`` maps to NaN:
    a kill is a scheduling decision, not a failed fit."""
    if not killed:
        return
    es = float("nan") if error_score == "raise" else float(error_score)
    warnings.warn(
        f"{len(killed)} of {len(out_rows)} batched search fits were "
        f"retired early by adaptive successive halving; their scores "
        f"are recorded as error_score={es!r} and the rung_ column "
        "records where each candidate died.",
        RungKilledWarning,
    )
    for gid in killed:
        row = out_rows[gid]
        for k in row:
            if k.startswith(("test_", "train_")):
                row[k] = es


def _cost_order(est_cls, task_hyper, split_ids):
    """Cost-ordered packing of the compacted path: a permutation of the
    task axis sorting by the family's convergence-cost heuristic
    (ascending), fold id fastest. None when the family has no heuristic
    or the order is already sorted."""
    cost_fn = getattr(est_cls, "_batched_task_cost", None)
    if cost_fn is None or len(split_ids) <= 1:
        return None
    cost = np.asarray(cost_fn(task_hyper), dtype=np.float64)
    if cost.shape != (len(split_ids),):
        return None
    order = np.lexsort((np.asarray(split_ids), cost))
    if np.array_equal(order, np.arange(len(order))):
        return None
    return order


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
        if not scorer_task_compatible(metric, estimator):
            raise _not_ported(
                f"scoring {metric!r} on a "
                f"{getattr(estimator, '_estimator_type', 'model')}"
            )
        if metric in BINARY_ONLY_SCORERS and not device_scorer_compatible(
                metric, classes):
            raise _not_ported(f"scoring {metric!r} on this label set")
        kernel, kind = DEVICE_SCORERS[metric]
        specs.append((out_name, metric, kernel, kind))
    return specs, multimetric


def _cv_scoring(est_cls, meta, static, scorer_specs, return_train_score,
                rung_spec=None):
    """``(scores, rung_score)``: ``scores(params, shared, task)`` scores
    fitted params on the tasks' fold masks (the classic kernel and the
    compacted finalize share it), ``rung_score(params, shared, task)``
    the rung metric on the held-out folds (None without ``rung_spec``)."""
    decision_kernel = est_cls._build_decision_kernel(meta, static)
    needs_proba = any(kind == "proba" for *_, kind in scorer_specs) or (
        rung_spec is not None and rung_spec[3] == "proba")
    proba_kernel = (
        est_cls._build_proba_kernel(meta, static) if needs_proba else None
    )

    def model_outputs(params, X):
        outputs = {"decision": decision_kernel(params["W"], X)}
        outputs["predict"] = outputs["decision"]
        if proba_kernel is not None:
            outputs["proba"] = proba_kernel(params["W"], X)
        return outputs

    def scores(params, shared, task):
        # user sample_weight weights the FIT only; train/test scoring is
        # over the raw fold masks, like sklearn scorers without weights
        y = shared["y"]
        outputs = model_outputs(params, shared["X"])
        train_w = shared["train_masks"][task["split"]]
        test_w = shared["test_masks"][task["split"]]
        out = {}
        for out_name, _metric, score_kernel, kind in scorer_specs:
            out[f"test_{out_name}"] = score_kernel(
                y, outputs[kind], test_w, meta
            )
            if return_train_score:
                out[f"train_{out_name}"] = score_kernel(
                    y, outputs[kind], train_w, meta
                )
        return out

    rung_score = None
    if rung_spec is not None:
        _out, _metric, rung_kernel, rung_kind = rung_spec

        def rung_score(params, shared, task):
            outputs = model_outputs(params, shared["X"])
            test_w = shared["test_masks"][task["split"]]
            return rung_kernel(shared["y"], outputs[rung_kind], test_w, meta)

    return scores, rung_score


def _cv_derive(shared, task):
    """A task batch's fit sub-problem: the shared operator and labels,
    the user weights times the tasks' train-fold masks, their hypers."""
    fit_w = shared["sw"] * shared["train_masks"][task["split"]]
    return shared["op"], shared["y"], fit_w, task["hyper"]


def _build_cv_kernel(est_cls, meta, static, scorer_specs, return_train_score):
    """One round of (fold-masked batched fit + scores) over the tasks of
    ``task``: ``hyper`` ``{name: (T,)}`` and ``split (T,)``."""
    fit_kernel = est_cls._build_fit_kernel(meta, static)
    scores, _ = _cv_scoring(est_cls, meta, static, scorer_specs,
                            return_train_score)

    def kernel(shared, task):
        return scores(fit_kernel(*_cv_derive(shared, task)), shared, task)

    return kernel


def _cv_iterative_spec(est_cls, meta, static, scorer_specs,
                       return_train_score, n_slice, fallback, rung_spec=None):
    """The iteration-sliced CV kernels: the family's sliced fit on the
    fold-masked weights; finalize scores as the classic kernel does;
    with ``rung_spec`` (a device scorer tuple from
    :func:`~skdist_tpu_torch.metrics.resolve_rung_scorer`), the rung
    evaluator scores live carries on the held-out folds."""
    from .multiclass import _iterative_fit_spec

    scores, rung_score = _cv_scoring(est_cls, meta, static, scorer_specs,
                                     return_train_score, rung_spec)
    return _iterative_fit_spec(est_cls, meta, static, n_slice, _cv_derive,
                               fallback, outputs=scores,
                               rung_score=rung_score)


class DistBaseSearchCV(BaseEstimator):
    """Base class for distributed CV search over batched fits."""

    def __init__(self, estimator, backend=None, partitions="auto", cv=5,
                 scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, verbose=0, adaptive=None):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.cv = cv
        self.scoring = scoring
        self.refit = refit
        self.return_train_score = return_train_score
        self.error_score = error_score
        self.verbose = verbose
        self.adaptive = adaptive

    def _get_param_iterator(self):
        raise NotImplementedError

    def fit(self, X, y=None, groups=None, **fit_params):
        """Fit every (candidate x fold) task on the backend's device
        (``backend=None`` means ``CUDABackend`` on the estimator's
        ``device``), then refit the best candidate."""
        check_error_score(self.error_score)
        check_adaptive(self.adaptive)
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
        if not is_classifier and np.ndim(y) != 1:
            raise _not_ported("a regressor's multi-target y")
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

        out, killed, engaged = self._run_batched(
            backend, estimator, X, y, candidate_params, splits, scorer_specs,
            sw)
        if self.adaptive is not None and not engaged:
            warn_not_engaged("the search")
        results = self._format_results(
            candidate_params, [s[0] for s in scorer_specs], n_splits, out
        )
        if self.adaptive is not None:
            # the rung at which each candidate died (-1: ran to the end)
            results["rung_"] = rung_per_candidate(
                len(candidate_params), n_splits, killed)
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
        """Dispatch (candidate x fold) tasks bucket by bucket. Returns the
        per-task score dicts in task order (candidate-major, split
        fastest), the rung kills ``{task id: rung}`` and whether an
        adaptive search ran its rungs."""
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
        adaptive = self.adaptive
        killed_gids = {}
        engaged = False
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
            sizes = dict(
                bytes_per_task=est_cls._batched_task_bytes(meta, static, n),
                bytes_per_round=est_cls._batched_round_bytes(meta, static, n),
                return_timings=True,
            )
            n_slice = iterative_fit_supported(
                backend, est_cls, len(gids), dict(static).get("max_iter"))
            inv = None
            if n_slice is not None:
                # the convergence-compacted path, tasks in ascending
                # expected cost (a scheduler detail, undone below)
                order = _cost_order(est_cls, task_args["hyper"],
                                    task_args["split"])
                disp_gids = np.asarray(gids)
                if order is not None:
                    task_args = {
                        "hyper": {k: v[order]
                                  for k, v in task_args["hyper"].items()},
                        "split": task_args["split"][order],
                    }
                    inv = np.argsort(order)
                    disp_gids = disp_gids[order]
                # the rung groups each candidate's fold lanes, so they
                # live and die together
                rung_ctrl = rung_spec = None
                if adaptive is not None:
                    rung_spec = resolve_rung_scorer(
                        adaptive.metric, scorer_specs, self.refit,
                        np.unique(y), est_cls=est_cls)
                    if rung_spec is not None:
                        rung_ctrl = RungController(
                            adaptive.eta, adaptive.min_slices,
                            groups=disp_gids // n_splits)
                spec = _cv_iterative_spec(
                    est_cls, meta, static, scorer_specs,
                    self.return_train_score, n_slice, fallback=kernel,
                    rung_spec=rung_spec)
                round_size = (
                    None if self.partitions in ("auto", None)
                    else parse_partitions(self.partitions, len(gids)))
                scores, round_timings = backend.batched_map_iterative(
                    spec, task_args, shared, round_size=round_size,
                    rung=rung_ctrl, **sizes)
                if rung_ctrl is not None:
                    # a downgrade to the exhaustive path deactivates it
                    engaged = engaged or rung_ctrl.active
                    for disp_idx, r in rung_ctrl.killed.items():
                        killed_gids[int(disp_gids[disp_idx])] = int(r)
            else:
                scores, round_timings = backend.batched_map(
                    kernel, task_args, shared,
                    round_size=parse_partitions(self.partitions, len(gids)),
                    **sizes)
            stats = dict(backend.last_round_stats, x_format=meta["x_format"])
            # per-task fit_time = its round's wall / tasks in that round
            # (fit and scoring run in one round: score_time is 0)
            per_task_time = np.concatenate([
                np.full(count, wall / max(count, 1))
                for wall, count in round_timings
            ])
            if inv is not None:
                # undo the cost permutation before unpacking, so rows keep
                # candidate order
                scores = {k: np.asarray(v)[inv] for k, v in scores.items()}
                per_task_time = per_task_time[inv]
                for key in ("lane_n_iter", "lane_status"):
                    if key in stats:
                        stats[key] = np.asarray(stats[key])[inv]
            self.round_stats_.append(stats)
            for t, gid in enumerate(gids):
                out[gid] = {k: float(v[t]) for k, v in scores.items()}
                out[gid]["fit_time"] = float(per_task_time[t])
                out[gid]["score_time"] = 0.0
            del shared
        # rung kills map to error_score rows (one warning); the lane
        # quarantine then handles genuinely diverged lanes only
        _apply_rung_retirement(out, killed_gids, self.error_score)
        _quarantine_nonfinite(out, self.error_score,
                              exempt=set(killed_gids))
        return out, killed_gids, engaged

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
                 error_score=np.nan, verbose=0, adaptive=None):
        super().__init__(
            estimator, backend=backend, partitions=partitions, cv=cv,
            scoring=scoring, refit=refit,
            return_train_score=return_train_score, error_score=error_score,
            verbose=verbose, adaptive=adaptive,
        )
        self.param_grid = param_grid

    def _get_param_iterator(self):
        return ParameterGrid(self.param_grid)
