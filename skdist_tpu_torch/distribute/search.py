"""
Distributed hyperparameter search of the port: ``DistGridSearchCV`` and
``DistRandomizedSearchCV``.

Counterpart of ``skdist_tpu/distribute/search.py``'s batched device
path. Candidates are bucketed by the params that shape the kernel;
within a bucket the numeric hyperparameters (``C``, ``tol``, ``alpha``)
are stacked onto a task axis together with a fold id, and the backend
runs the bucket's (candidate x fold) tasks as batched fits in rounds on
the card.
CV folds are 0/1 weight masks, and the scores of every task are computed
on the device in the same round as its fit.

A bucket of at least ``MIN_ITER_TASKS`` tasks of a family with
iteration-sliced fits (``LogisticRegression``, ``SGDClassifier``) takes
the convergence-compacted path (``CUDABackend.batched_map_iterative``),
as in the JAX package: its tasks are ordered by expected cost, solved in
slices, and finished lanes leave their slots; ``SKDIST_COMPACTION=0``
switches back to the classic path, and the results are the same bit for
bit. A family may ask for fewer rounds than the backend's default
(``_compacted_rounds``: SGD, whose step costs its launches whatever its
lanes, runs one). ``adaptive=HalvingSpec(...)`` adds asynchronous successive halving
on that path, where every round fits on the card at once; elsewhere the
search runs exhaustively and warns.

``cv_results_`` has sklearn's schema: ``split{i}_test_*``,
``mean/std/rank_test_*`` (rank by the min method, failed fits last),
masked ``param_*`` arrays and fit/score times. The best candidate is
refit, and runtime handles are stripped after fit so the artifact
pickles clean.

A search the batched path cannot take runs the generic path, as in the
JAX package: every (candidate x fold) task clones the estimator, fits it
on the fold's rows and scores it with the host scorers
(:func:`~skdist_tpu_torch.metrics.check_multimetric_scoring`), fanned
out over the backend's host threads (``run_tasks``; ``n_jobs``). That
covers an estimator with no batched fit (the forests, any duck-typed
estimator), a searched param outside the kernel's params, a scoring
with no device kernel for this estimator (a callable, a dict, a
probability metric over a tree, which has no proba kernel) and fit
params other than a full-length ``sample_weight``.

A single tree (``DecisionTree*``, ``ExtraTree*``) takes the batched
path: every tree parameter shapes the kernel, so each candidate is a
bucket whose fold lanes grow in one ``build_tree_kernel`` round over X
binned once under the edges of the whole X, as in the JAX package (so
its scores differ from the generic path's, which bins each training
fold). A fit
that raises scores ``error_score`` with a :class:`FitFailedWarning`
(``error_score="raise"`` re-raises). ``preds=True`` adds the out-of-fold
probabilities (or predictions) at the best params, ``preds_``.

An estimator that runs its f64 host engine on the backend (an explicit
``engine='host'``; ``engine='auto'`` with ``device="cpu"`` off a device
backend) leaves the batched path for the warm C path
(``_run_host_warm``): within each fold its fits run in ascending ``C``,
each started from the previous optimum.

:class:`DistMultiModelSearch` runs a randomized search over several
model families through the same scheduler, family by family.

Not ported yet (ROADMAP): checkpointing (and so the journaling of rung
kills), streamed input and its streamed rungs, and fault retries of the
compacted path.
"""

import time
import warnings

import numpy as np
from numpy.ma import MaskedArray
from scipy.stats import rankdata

from ..base import BaseEstimator, clone, strip_runtime
from ..data import is_chunked
from ..metrics import (
    BINARY_ONLY_SCORERS,
    DEVICE_SCORERS,
    aggregate_score_dicts,
    check_multimetric_scoring,
    default_device_scorer,
    device_scorer_compatible,
    resolve_rung_scorer,
    scorer_task_compatible,
)
from ..parallel import (
    CUDABackend,
    RungController,
    iterative_chunk_size,
    iterative_fit_supported,
    parse_partitions,
    prefers_host_engine,
    resolve_backend,
)
from ..utils.cv import ParameterGrid, ParameterSampler, check_cv
from ..utils.validation import (
    check_error_score,
    check_is_fitted,
    check_n_iter,
    full_length_sample_weight,
    index_fit_params,
    num_samples,
    safe_split,
)
from .adaptive import (
    RungKilledWarning,
    check_adaptive,
    rung_per_candidate,
    warn_not_engaged,
)

__all__ = ["DistBaseSearchCV", "DistGridSearchCV", "DistRandomizedSearchCV",
           "DistMultiModelSearch", "FitFailedWarning", "RungKilledWarning"]

_ROADMAP = "see ROADMAP.md, queue 1"


class FitFailedWarning(RuntimeWarning):
    """Warning for per-task fits recorded as failed."""


def _not_ported(what, where=_ROADMAP):
    return NotImplementedError(
        f"{what} is not ported to skdist_tpu_torch yet ({where})"
    )


def _refuse_chunked(X):
    """The streamed search over a ChunkedDataset is not ported yet."""
    if is_chunked(X):
        raise _not_ported("a search over a ChunkedDataset (the streamed "
                          "search)", "see ROADMAP.md, queue 1 item 9b")


def _fit_and_score(estimator, X, y, scorers, train, test, parameters,
                   fit_params=None, error_score=np.nan,
                   return_train_score=False, est_instance=None,
                   return_estimator=False):
    """One task of the generic path: a clone of ``estimator`` with
    ``parameters``, fitted on the ``train`` rows (array-valued fit
    params cut to them) and scored on the ``test`` rows by every scorer.
    A fit or a score that raises records ``error_score`` with a
    :class:`FitFailedWarning`, or re-raises under ``'raise'``.
    ``est_instance`` is an instance to fit instead of the clone (already
    given its params; the warm C path's carries its seed), and
    ``return_estimator`` adds the fitted instance as ``"estimator"``."""
    if est_instance is not None:
        est = est_instance
    else:
        est = clone(estimator)
        if parameters:
            est.set_params(**parameters)
    X_train, y_train = safe_split(est, X, y, train)
    X_test, y_test = safe_split(est, X, y, test, train)
    fit_params = index_fit_params(X, fit_params or {}, train)
    start = time.perf_counter()
    result = {}
    try:
        if y_train is None:
            est.fit(X_train, **fit_params)
        else:
            est.fit(X_train, y_train, **fit_params)
        fit_time = time.perf_counter() - start
        score_start = time.perf_counter()
        for name, scorer in scorers.items():
            result[f"test_{name}"] = scorer(est, X_test, y_test)
        score_time = time.perf_counter() - score_start
        if return_train_score:
            for name, scorer in scorers.items():
                result[f"train_{name}"] = scorer(est, X_train, y_train)
    except Exception as exc:
        fit_time = time.perf_counter() - start
        score_time = 0.0
        if error_score == "raise":
            raise
        warnings.warn(
            f"Estimator fit failed ({type(exc).__name__}: {exc}); "
            f"score set to {error_score}.",
            FitFailedWarning,
        )
        result = {}
        for name in scorers:
            result[f"test_{name}"] = float(error_score)
            if return_train_score:
                result[f"train_{name}"] = float(error_score)
    result["fit_time"] = fit_time
    result["score_time"] = score_time
    if return_estimator:
        result["estimator"] = est
    return result


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
    """Group candidate indices by their kernel-shaping params; None when
    a candidate searches a param the batched path cannot vary."""
    from ..models.linear import _freeze

    hyper_names = set(getattr(type(estimator), "_hyper_names", ()))
    static_names = set(getattr(type(estimator), "_static_names", ()))
    buckets = {}
    for idx, cand in enumerate(candidate_params):
        for name in cand:
            if name not in hyper_names and name not in static_names:
                return None
        overrides = {k: v for k, v in cand.items() if k in static_names}
        buckets.setdefault(_freeze(overrides), (overrides, []))[1].append(idx)
    return buckets


def _resolve_device_scoring(estimator, scoring, classes):
    """``scoring`` -> ``[(out_name, metric, kernel, kind)]``, or None when
    a metric has no device kernel that holds for this estimator and label
    set (a callable, a dict, a regression metric on a classifier, roc_auc
    on a multiclass target): the generic path's host scorers take those."""
    if scoring is None:
        names = [("score", default_device_scorer(estimator))]
    elif isinstance(scoring, str):
        names = [("score", scoring)]
    elif isinstance(scoring, (list, tuple, set)):
        names = [(s, s) for s in scoring]
    else:
        return None
    specs = []
    for out_name, metric in names:
        if metric not in DEVICE_SCORERS:
            return None
        if not scorer_task_compatible(metric, estimator):
            return None
        if metric in BINARY_ONLY_SCORERS and not device_scorer_compatible(
                metric, classes):
            return None
        kernel, kind = DEVICE_SCORERS[metric]
        specs.append((out_name, metric, kernel, kind))
    return specs


def _cv_scoring(est_cls, meta, static, scorer_specs, return_train_score,
                rung_spec=None, mask_x=False):
    """``(scores, rung_score)``: ``scores(params, shared, task)`` scores
    fitted params on the tasks' fold masks (the classic kernel and the
    compacted finalize share it), ``rung_score(params, shared, task)``
    the rung metric on the held-out folds (None without ``rung_spec``).
    ``mask_x``: each task sees only the columns of its ``task["fmask"]``
    row (the feature eliminator), through the family's
    ``_mask_decision_params``."""
    decision_kernel = est_cls._build_decision_kernel(meta, static)
    needs_proba = any(kind == "proba" for *_, kind in scorer_specs) or (
        rung_spec is not None and rung_spec[3] == "proba")
    proba_kernel = (
        est_cls._build_proba_kernel(meta, static) if needs_proba else None
    )

    def model_outputs(params, shared, task):
        W = est_cls._decision_params(params)
        if mask_x:
            W = est_cls._mask_decision_params(W, task["fmask"])
        X = shared["X"]
        outputs = {"decision": decision_kernel(W, X)}
        outputs["predict"] = outputs["decision"]
        if proba_kernel is not None:
            outputs["proba"] = proba_kernel(W, X)
        return outputs

    def scores(params, shared, task):
        # user sample_weight weights the FIT only; train/test scoring is
        # over the raw fold masks, like sklearn scorers without weights
        y = shared["y"]
        outputs = model_outputs(params, shared, task)
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
            outputs = model_outputs(params, shared, task)
            test_w = shared["test_masks"][task["split"]]
            return rung_kernel(shared["y"], outputs[rung_kind], test_w, meta)

    return scores, rung_score


def _cv_derive(shared, task):
    """A task batch's fit sub-problem: the shared operator and labels,
    the user weights times the tasks' train-fold masks, their hypers."""
    fit_w = shared["sw"] * shared["train_masks"][task["split"]]
    return shared["op"], shared["y"], fit_w, task["hyper"]


def _cv_derive_for(est_cls, mask_x):
    """:func:`_cv_derive`, or with ``mask_x`` its column-masked form:
    the shared operator seen through the family's ``_mask_operand``
    under the tasks' ``fmask (T, d)`` rows (the feature eliminator's
    ``X * fmask``, with no copy of X a task)."""
    if not mask_x:
        return _cv_derive

    def derive(shared, task):
        op, y, fit_w, hyper = _cv_derive(shared, task)
        return est_cls._mask_operand(op, task["fmask"]), y, fit_w, hyper

    return derive


def _build_cv_kernel(est_cls, meta, static, scorer_specs, return_train_score,
                     mask_x=False):
    """One round of (fold-masked batched fit + scores) over the tasks of
    ``task``: ``hyper`` ``{name: (T,)}`` and ``split (T,)``, and with
    ``mask_x`` the column masks ``fmask (T, d)``."""
    fit_kernel = est_cls._build_fit_kernel(meta, static)
    scores, _ = _cv_scoring(est_cls, meta, static, scorer_specs,
                            return_train_score, mask_x=mask_x)
    derive = _cv_derive_for(est_cls, mask_x)

    def kernel(shared, task):
        return scores(fit_kernel(*derive(shared, task)), shared, task)

    return kernel


def _cv_iterative_spec(est_cls, meta, static, scorer_specs,
                       return_train_score, n_slice, fallback, rung_spec=None,
                       mask_x=False):
    """The iteration-sliced CV kernels: the family's sliced fit on the
    fold-masked weights; finalize scores as the classic kernel does;
    with ``rung_spec`` (a device scorer tuple from
    :func:`~skdist_tpu_torch.metrics.resolve_rung_scorer`), the rung
    evaluator scores live carries on the held-out folds. ``mask_x``
    puts each task's ``fmask`` column mask on everything (init,
    restart, step, finalize, the scores and the rung)."""
    from .multiclass import _iterative_fit_spec

    scores, rung_score = _cv_scoring(est_cls, meta, static, scorer_specs,
                                     return_train_score, rung_spec, mask_x)
    return _iterative_fit_spec(est_cls, meta, static, n_slice,
                               _cv_derive_for(est_cls, mask_x), fallback,
                               outputs=scores, rung_score=rung_score)


class DistBaseSearchCV(BaseEstimator):
    """Base class for distributed CV search over batched fits."""

    def __init__(self, estimator, backend=None, partitions="auto", cv=5,
                 scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, n_jobs=None, preds=False, verbose=0,
                 adaptive=None):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.cv = cv
        self.scoring = scoring
        self.refit = refit
        self.return_train_score = return_train_score
        self.error_score = error_score
        self.n_jobs = n_jobs
        self.preds = preds
        self.verbose = verbose
        self.adaptive = adaptive

    def _get_param_iterator(self):
        raise NotImplementedError

    def fit(self, X, y=None, groups=None, checkpoint_dir=None, **fit_params):
        """Fit every (candidate x fold) task, batched on the backend's
        device where the batched path can take the search and through the
        generic path otherwise, then refit the best candidate.
        ``backend=None`` means ``CUDABackend`` on the estimator's
        ``device`` with ``n_jobs`` host threads; a string resolves through
        :func:`~skdist_tpu_torch.parallel.resolve_backend`."""
        check_error_score(self.error_score)
        check_adaptive(self.adaptive)
        _refuse_chunked(X)
        if checkpoint_dir is not None:
            raise _not_ported(
                "checkpoint_dir (search checkpointing)",
                "see ROADMAP.md, queue 1 item 10, with parallel/faults.py")
        estimator = self.estimator
        if y is None:
            raise ValueError(f"{type(self).__name__}.fit needs y")
        if self.backend is None:
            backend = CUDABackend(device=getattr(estimator, "device", None),
                                  n_jobs=self.n_jobs)
        else:
            backend = resolve_backend(self.backend, n_jobs=self.n_jobs)
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
        scorers, multimetric = check_multimetric_scoring(estimator,
                                                         self.scoring)
        self.multimetric_ = multimetric
        refit_metric = self._refit_metric(scorers, multimetric)

        out, killed, engaged = self._run_search_tasks(
            backend, estimator, X, y, candidate_params, splits, scorers,
            fit_params)
        if self.adaptive is not None and not engaged:
            warn_not_engaged("the search")
        results = self._format_results(candidate_params, list(scorers),
                                       n_splits, out)
        if self.adaptive is not None:
            # the rung at which each candidate died (-1: ran to the end)
            results["rung_"] = rung_per_candidate(
                len(candidate_params), n_splits, killed)
        self.cv_results_ = results
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
            if self.preds:
                self.preds_ = self._out_of_fold_preds(estimator, X, y,
                                                      splits, fit_params)
        # detach from the user's template before stripping runtime handles
        self.estimator = clone(self.estimator)
        strip_runtime(self)
        return self

    def _refit_metric(self, scorers, multimetric):
        if multimetric:
            if not isinstance(self.refit, str) or self.refit not in scorers:
                if self.refit:
                    raise ValueError(
                        "For multi-metric scoring, refit must be the name "
                        "of the scorer used to find the best parameters."
                    )
            return self.refit if isinstance(self.refit, str) else None
        return "score"

    def _run_search_tasks(self, backend, estimator, X, y, candidate_params,
                          splits, scorers, fit_params):
        """The per-task score dicts in task order (candidate-major, split
        fastest), the rung kills ``{task id: rung}`` and whether an
        adaptive search ran its rungs: from the batched path when it can
        take the search, else from the warm C path of the f64 host
        engine when the estimator runs that engine here, else from the
        generic path.

        An estimator that runs its host engine on this backend
        (:func:`~skdist_tpu_torch.parallel.prefers_host_engine`) leaves
        the batched path: under ``engine='auto'`` only when X would not
        pack (packed X has no host form and stays batched), under an
        explicit ``engine='host'`` always. So does a search over
        ``engine`` itself, whose candidates must each run their own."""
        sw, sw_ok = full_length_sample_weight(fit_params, num_samples(X))
        host = prefers_host_engine(backend, estimator, X)
        if (sw_ok and hasattr(type(estimator), "_build_fit_kernel")
                and not host
                and not any("engine" in cand for cand in candidate_params)):
            specs = _resolve_device_scoring(estimator, self.scoring,
                                            np.unique(y))
            buckets = _candidate_buckets(estimator, candidate_params)
            needs_proba = specs is not None and any(
                kind == "proba" for *_, kind in specs)
            if specs is not None and buckets is not None and not (
                    needs_proba and not hasattr(type(estimator),
                                                "_build_proba_kernel")):
                done = self._run_batched(
                    backend, estimator, X, y, candidate_params, splits,
                    specs, sw, buckets)
                if done is not None:
                    return done
        if host and getattr(estimator, "_host_warm_startable", False):
            return self._run_host_warm(
                backend, estimator, X, y, candidate_params, splits, scorers,
                fit_params), {}, False
        return self._run_generic(backend, estimator, X, y, candidate_params,
                                 splits, scorers, fit_params), {}, False

    def _run_host_warm(self, backend, estimator, X, y, candidate_params,
                       splits, scorers, fit_params):
        """The warm C path of the f64 host engine: candidates that differ
        only in ``C`` form a regularisation path, and within one fold
        its fits run in ascending ``C``, each started from the previous
        optimum (``_warm_w0`` from the last fit's ``_w_opt64``). The
        (path, fold) chains are independent tasks of ``backend.run_tasks``.

        A tol-converged optimum of a convex objective does not depend on
        its start, so the scores are the cold fits' to solver tolerance.
        A capped fit's does: the engine returns no optimum for a fit
        stopped on ``max_iter``, so the chain restarts cold after it,
        and a warm-seeded fit that stops on the cap is refit cold before
        its score is recorded, so no score depends on which other C
        values share the grid. Each task is :func:`_fit_and_score`.
        ``round_stats_`` counts the fits, the warm-seeded ones, the cold
        refits and the fits that ran the host engine."""
        from ..models.linear import hyper_float

        n_splits = len(splits)
        out = [None] * (len(candidate_params) * n_splits)
        paths = {}
        for idx, cand in enumerate(candidate_params):
            key = tuple(sorted((k, repr(v)) for k, v in cand.items()
                               if k != "C"))
            paths.setdefault(key, []).append(idx)
        for idxs in paths.values():
            idxs.sort(key=lambda i: float(hyper_float(
                candidate_params[i].get("C", estimator.C))))
        chains = [(idxs, train, test, s) for idxs in paths.values()
                  for s, (train, test) in enumerate(splits)]

        def fit_one(i, train, test, w0):
            est = clone(estimator)
            if candidate_params[i]:
                est.set_params(**candidate_params[i])
            if w0 is not None:
                est._warm_w0 = w0
            r = _fit_and_score(
                estimator, X, y, scorers, train, test, None,
                fit_params=fit_params, error_score=self.error_score,
                return_train_score=self.return_train_score,
                est_instance=est, return_estimator=True,
            )
            fitted = r.pop("estimator")
            info = {"host": hasattr(fitted, "_w_opt64"),
                    "seeded": w0 is not None,
                    "n_iter": int(np.max(getattr(fitted, "n_iter_", -1)))}
            return r, getattr(fitted, "_w_opt64", None), info

        def run_chain(chain):
            idxs, train, test, _s = chain
            results = []
            w_prev = None
            for i in idxs:
                r, w_opt, info = fit_one(i, train, test, w_prev)
                info["cold_refit"] = w_prev is not None and w_opt is None
                if info["cold_refit"]:
                    # the seeded fit stopped on max_iter: refit cold
                    r, w_opt, cold = fit_one(i, train, test, None)
                    info.update(host=cold["host"], n_iter=cold["n_iter"])
                w_prev = w_opt
                results.append((i, r, info))
            return results

        t0 = time.perf_counter()
        done = backend.run_tasks(run_chain, chains, verbose=self.verbose)
        wall = time.perf_counter() - t0
        infos = [None] * len(out)
        for chain, results in zip(chains, done):
            for i, r, info in results:
                out[i * n_splits + chain[3]] = r
                infos[i * n_splits + chain[3]] = info
        # per task (candidate-major, split fastest): whether its fit was
        # seeded (a seeded fit refit cold counts as seeded), refit cold,
        # ran the host engine, and its iterations (the recorded fit's)
        lane = {key: np.asarray([info[key] for info in infos])
                for key in ("seeded", "cold_refit", "host", "n_iter")}
        self.round_stats_ = [{
            "mode": "host_warm", "tasks": len(out), "chains": len(chains),
            "warm_seeded": int(lane["seeded"].sum()),
            "cold_refits": int(lane["cold_refit"].sum()),
            "host_fits": int(lane["host"].sum()),
            "lane_seeded": lane["seeded"], "lane_n_iter": lane["n_iter"],
            "wall_s": wall,
        }]
        return out

    def _run_generic(self, backend, estimator, X, y, candidate_params,
                     splits, scorers, fit_params):
        """Every (candidate x fold) task through :func:`_fit_and_score`,
        fanned out by ``backend.run_tasks``."""
        tasks = [(params, train, test) for params in candidate_params
                 for train, test in splits]

        def run_one(task):
            params, train, test = task
            return _fit_and_score(
                estimator, X, y, scorers, train, test, params,
                fit_params=fit_params, error_score=self.error_score,
                return_train_score=self.return_train_score,
            )

        t0 = time.perf_counter()
        out = backend.run_tasks(run_one, tasks, verbose=self.verbose)
        self.round_stats_ = [{"mode": "generic", "tasks": len(tasks),
                              "wall_s": time.perf_counter() - t0}]
        return out

    def _run_batched(self, backend, estimator, X, y, candidate_params,
                     splits, scorer_specs, sample_weight, buckets):
        """Dispatch (candidate x fold) tasks bucket by bucket. Returns the
        per-task score dicts in task order (candidate-major, split
        fastest), the rung kills ``{task id: rung}`` and whether an
        adaptive search ran its rungs; None when a bucket's data prep
        raises (the caller then runs the generic path)."""
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
        # a family that names the params its data prep reads
        # (``_prep_params``: a tree's quantile edges read ``n_bins``
        # alone) preps once for every bucket that shares them
        prep_names = getattr(est_cls, "_prep_params", None)
        preps = {}
        for static_overrides, cand_indices in buckets.values():
            bucket_est = clone(estimator).set_params(**static_overrides)
            bucket_est._check_supported()
            prep_key = None if prep_names is None else _freeze(
                {k: getattr(bucket_est, k) for k in prep_names})
            if prep_key is None or prep_key not in preps:
                try:
                    preps[prep_key] = bucket_est._prep_fit_data(
                        X_arr, y, sample_weight)
                except Exception:
                    # the estimator's own input checks (MultinomialNB's
                    # negative counts, say) fail per task on the generic
                    # path, under error_score, as in the JAX package
                    return None
            data, meta = preps[prep_key]
            static = _freeze(bucket_est._static_config(meta))
            kernel = _build_cv_kernel(est_cls, meta, static, scorer_specs,
                                      self.return_train_score)
            shared = backend.place({
                "X": data["X"], "y": data["y"], "sw": data["sw"],
                "train_masks": train_masks, "test_masks": test_masks,
            })
            shared["op"] = est_cls._fit_operand(shared["X"], meta, static)
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
                target = getattr(est_cls, "_compacted_rounds", None)
                if round_size is None and target:
                    round_size = iterative_chunk_size(len(gids), 1, target)
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
        agg = aggregate_score_dicts(out)
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

    def _out_of_fold_preds(self, estimator, X, y, splits, fit_params):
        """Out-of-fold ``predict_proba`` at the best params, or ``predict``
        for an estimator without probabilities: one fit a fold, on the
        host's thread, rows in fold order."""
        preds = []
        for train, test in splits:
            est = clone(estimator).set_params(**self.best_params_)
            X_train, y_train = safe_split(est, X, y, train)
            X_test, _ = safe_split(est, X, y, test, train)
            est.fit(X_train, y_train, **index_fit_params(X, fit_params, train))
            try:
                preds.append(est.predict_proba(X_test))
            except (AttributeError, NotImplementedError):
                preds.append(est.predict(X_test))
        if preds and np.ndim(preds[0]) == 1:
            return np.concatenate(preds)
        return np.vstack(preds)

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
    """Exhaustive grid search with batched fits on the card (the generic
    path where they cannot run); the contract of sklearn's
    GridSearchCV."""

    def __init__(self, estimator, param_grid, backend=None, partitions="auto",
                 cv=5, scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, n_jobs=None, preds=False, verbose=0,
                 adaptive=None):
        super().__init__(
            estimator, backend=backend, partitions=partitions, cv=cv,
            scoring=scoring, refit=refit,
            return_train_score=return_train_score, error_score=error_score,
            n_jobs=n_jobs, preds=preds, verbose=verbose, adaptive=adaptive,
        )
        self.param_grid = param_grid

    def _get_param_iterator(self):
        return ParameterGrid(self.param_grid)


class DistRandomizedSearchCV(DistBaseSearchCV):
    """Randomized search with batched fits on the card (the generic path
    where they cannot run); the contract of sklearn's RandomizedSearchCV. ``n_iter`` candidates are drawn by the
    port's :class:`~skdist_tpu_torch.utils.cv.ParameterSampler`, which
    gives sklearn's candidates for the same ``random_state``
    (``n_iter`` is capped at the grid's size when every distribution is
    a list)."""

    def __init__(self, estimator, param_distributions, backend=None,
                 partitions="auto", n_iter=10, random_state=None, cv=5,
                 scoring=None, refit=True, return_train_score=False,
                 error_score=np.nan, n_jobs=None, preds=False, verbose=0,
                 adaptive=None):
        super().__init__(
            estimator, backend=backend, partitions=partitions, cv=cv,
            scoring=scoring, refit=refit,
            return_train_score=return_train_score, error_score=error_score,
            n_jobs=n_jobs, preds=preds, verbose=verbose, adaptive=adaptive,
        )
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _get_param_iterator(self):
        n_iter = check_n_iter(self.n_iter, self.param_distributions)
        return ParameterSampler(self.param_distributions, n_iter,
                                random_state=self.random_state)


# ---------------------------------------------------------------------------
# DistMultiModelSearch
# ---------------------------------------------------------------------------

def _raw_sampler(models, n_params=None, n=None, random_state=None):
    """Candidates of every model: ``[{model_index, params_index,
    param_set}]``, ``n_params[i]`` (or ``n`` each) drawn from model
    ``i``'s distributions by :class:`~skdist_tpu_torch.utils.cv.
    ParameterSampler` (capped at a list-only grid's size)."""
    if n_params is None:
        if n is None:
            raise ValueError("Must supply either 'n_params' or 'n'")
        n_params = [n] * len(models)
    param_sets = []
    for index, model in enumerate(models):
        dists = model[2]
        sampler = ParameterSampler(
            dists, check_n_iter(n_params[index], dists),
            random_state=random_state)
        for sample_index, sample in enumerate(sampler):
            param_sets.append({"model_index": index,
                               "params_index": sample_index,
                               "param_set": sample})
    return param_sets


def _validate_models(models):
    """``models`` as a list of ``(name, estimator, param_dict)`` with
    unique string names, or a ``ValueError``."""
    if not models:
        raise ValueError("models must be a non-empty list of tuples")
    names = [m[0] for m in models]
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate model names: {names}")
    for m in models:
        if len(m) != 3:
            raise ValueError(
                "each model must be ('name', estimator, param_dict)")
        name, est, params = m
        if not isinstance(name, str):
            raise ValueError(f"model name must be str, got {name!r}")
        if not hasattr(est, "fit"):
            raise ValueError(f"estimator {est!r} has no fit method")
        if not isinstance(params, dict):
            raise ValueError(f"param set must be dict, got {params!r}")
    return list(models)


class DistMultiModelSearch(BaseEstimator):
    """Randomized search across model families: ``models`` is a list of
    ``(name, estimator, param_distributions)``; ``n`` candidates are
    drawn for each model (the port's ``ParameterSampler``, capped at a
    list-only grid's size), each is scored by CV, and the best (model,
    params) is refit.

    Each family runs through the grid search's own scheduler
    (``_run_search_tasks``): a family the batched path takes runs its
    candidates as batched fits on the backend's device, another runs the
    warm C path or the generic per-task path. Scoring is single-metric;
    ``adaptive`` races each family's own rungs. ``cv_results_`` stacks
    the families' results in model order, with ``model_name`` and
    ``model_index`` and ranks over every candidate; ``worst_score_`` is
    the lowest mean score (the reference's copy of ``best_score_`` is
    not kept). ``backend=None`` is a ``CUDABackend`` on the first
    model's ``device`` with ``n_jobs`` host threads."""

    def __init__(self, models, backend=None, partitions="auto", n=5, cv=5,
                 scoring=None, random_state=None, verbose=0, refit=True,
                 n_jobs=None, adaptive=None):
        self.models = models
        self.backend = backend
        self.partitions = partitions
        self.n = n
        self.cv = cv
        self.scoring = scoring
        self.random_state = random_state
        self.verbose = verbose
        self.refit = refit
        self.n_jobs = n_jobs
        self.adaptive = adaptive

    def fit(self, X, y=None, groups=None, **fit_params):
        check_adaptive(self.adaptive)
        _refuse_chunked(X)
        models = _validate_models(self.models)
        if self.backend is None:
            backend = CUDABackend(device=getattr(models[0][1], "device", None),
                                  n_jobs=self.n_jobs)
        else:
            backend = resolve_backend(self.backend, n_jobs=self.n_jobs)
        is_classifier = (
            getattr(models[0][1], "_estimator_type", None) == "classifier")
        cv = check_cv(self.cv, y, classifier=is_classifier)
        splits = list(cv.split(X, y, groups))
        n_splits = len(splits)
        param_sets = _raw_sampler(models, n=self.n,
                                  random_state=self.random_state)

        per_model = []
        engaged = False
        stats = []
        for index, (name, estimator, _dists) in enumerate(models):
            cands = [p["param_set"] for p in param_sets
                     if p["model_index"] == index]
            if not cands:
                continue
            scorers, multimetric = check_multimetric_scoring(estimator,
                                                             self.scoring)
            if multimetric:
                raise ValueError(
                    "DistMultiModelSearch supports single-metric scoring")
            shim = DistBaseSearchCV(
                estimator, partitions=self.partitions, cv=self.cv,
                scoring=self.scoring, error_score=np.nan,
                n_jobs=self.n_jobs, verbose=self.verbose,
                adaptive=self.adaptive)
            out, killed, model_engaged = shim._run_search_tasks(
                backend, estimator, X, y, cands, splits, scorers, fit_params)
            full = shim._format_results(cands, list(scorers), n_splits, out)
            if self.adaptive is not None:
                full["rung_"] = rung_per_candidate(len(cands), n_splits,
                                                   killed)
                engaged = engaged or model_engaged
            stats.append({"model_name": name,
                          "round_stats": shim.round_stats_})
            per_model.append((index, name, cands, full))

        if self.adaptive is not None and not engaged:
            warn_not_engaged("the multi-model search")
        results = self._merge_model_results(per_model, n_splits)
        scores = np.asarray(results["mean_test_score"], dtype=float)
        if scores.size == 0 or np.all(np.isnan(scores)):
            raise RuntimeError(
                "All candidate fits failed (every score is NaN).")
        if self.verbose:
            for index, name, _cands, full in per_model:
                seg = np.asarray(full["mean_test_score"], dtype=float)
                best = (float(np.nanmax(seg)) if not np.all(np.isnan(seg))
                        else float("nan"))
                print(f"model_index={index} ({name}): best score {best:.6f}")
        best_index = int(np.nanargmax(scores))
        self.best_index_ = best_index
        self.best_model_index_ = int(results["model_index"][best_index])
        self.best_model_name_ = models[self.best_model_index_][0]
        self.best_params_ = results["params"][best_index]
        self.best_score_ = float(scores[best_index])
        self.worst_score_ = float(np.nanmin(scores))
        self.cv_results_ = results
        self.n_splits_ = n_splits
        self.round_stats_ = stats

        if self.refit:
            best = clone(models[self.best_model_index_][1])
            best.set_params(**self.best_params_)
            if y is not None:
                best.fit(X, y, **fit_params)
            else:
                best.fit(X, **fit_params)
            self.best_estimator_ = best
        self.models = [(name, clone(est), dists)
                       for name, est, dists in self.models]
        strip_runtime(self)
        return self

    @staticmethod
    def _merge_model_results(per_model, n_splits):
        """One ``cv_results_`` from the families' ``_format_results``
        dicts: numeric columns concatenated in model order, ``param_*``
        masked arrays over the union of names (masked where a model lacks
        the param), ``model_name``/``model_index``, and
        ``rank_test_score`` over every candidate (the min method, failed
        fits last)."""
        n_total = sum(len(cands) for _, _, cands, _ in per_model)
        num_keys = [
            "mean_fit_time", "std_fit_time", "mean_score_time",
            "std_score_time", "mean_test_score", "std_test_score",
        ] + [f"split{i}_test_score" for i in range(n_splits)]
        results = {
            key: np.concatenate([np.asarray(full[key], dtype=np.float64)
                                 for _, _, _, full in per_model])
            if per_model else np.empty(0)
            for key in num_keys
        }
        param_cols = {}
        params_list, names, model_idx = [], [], []
        offset = 0
        for index, name, cands, full in per_model:
            m = len(cands)
            for key, arr in full.items():
                if not key.startswith("param_"):
                    continue
                col = param_cols.get(key)
                if col is None:
                    col = param_cols[key] = MaskedArray(
                        np.empty(n_total, dtype=object), mask=True)
                for j in range(m):
                    if not np.ma.getmaskarray(arr)[j]:
                        col[offset + j] = arr[j]
            params_list.extend(full["params"])
            names.extend([name] * m)
            model_idx.extend([index] * m)
            offset += m
        results.update(param_cols)
        results["params"] = params_list
        results["model_name"] = names
        results["model_index"] = model_idx
        if any("rung_" in full for _, _, _, full in per_model):
            results["rung_"] = np.concatenate([
                np.asarray(full.get("rung_", np.full(len(cands), -1)),
                           dtype=np.int32)
                for _, _, cands, full in per_model])
        results["rank_test_score"] = np.asarray(
            rankdata(-_nan_as_worst(results["mean_test_score"]),
                     method="min"), dtype=np.int32,
        ) if n_total else np.empty(0, dtype=np.int32)
        return results

    # -- post-fit delegation ---------------------------------------------
    def _check_is_fitted(self):
        if not self.refit:
            raise AttributeError(
                f"This {type(self).__name__} instance was initialized with "
                "refit=False; predict-side methods need refit=True.")
        check_is_fitted(self, "best_estimator_")

    def predict(self, X):
        self._check_is_fitted()
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        self._check_is_fitted()
        return self.best_estimator_.predict_proba(X)

    def predict_log_proba(self, X):
        self._check_is_fitted()
        return self.best_estimator_.predict_log_proba(X)

    def decision_function(self, X):
        self._check_is_fitted()
        return self.best_estimator_.decision_function(X)

    @property
    def classes_(self):
        self._check_is_fitted()
        return self.best_estimator_.classes_
