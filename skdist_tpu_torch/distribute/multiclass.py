"""
One-vs-rest and one-vs-one multiclass meta-estimators of the port, and
:func:`_iterative_fit_spec`, the one builder of
:class:`~skdist_tpu_torch.parallel.IterativeKernelSpec` for the
convergence-compacted path (the CV search uses it too). Counterpart of
``skdist_tpu/distribute/multiclass.py``.

- **Batched path** (an estimator of a family marked ``_lane_labels``:
  ``LogisticRegression``, ``LinearSVC``, ``SGDClassifier``,
  ``RidgeClassifier``, ``DecisionTreeClassifier``,
  ``ExtraTreeClassifier``): the class (or class-pair) axis is the task axis
  of one batched binary fit. Each task's label vector is derived on the
  card from the shared label matrix (``Y[:, c]``; a pair's ``y == j``);
  OvO's per-pair row subsets are 0/1 sample-weight masks, not slices.
  Negative down-sampling is exact: per-class keep masks made on the host
  with the generic path's arithmetic and ``RandomState`` draws ride the
  task axis. A task set of at least ``MIN_ITER_TASKS`` takes the
  convergence-compacted path (``SKDIST_COMPACTION=0`` switches it off),
  a smaller one the classic ``batched_map``.
- **Generic path** (any other estimator with ``fit``, a dict
  ``class_weight``, and an estimator that runs its f64 host engine on
  this backend: ``engine='host'``, or ``'auto'`` off a device backend
  where its device is the CPU, as the searches route it, so one
  estimator never runs two engines depending on its wrapper): one
  binary fit a class or pair, one after another
  in the caller's process, with the reference's ``_fit_binary``
  semantics (exact down-sampling, the constant-column fallback, nested
  search unwrapping).

Both paths leave the same artifacts: ``estimators_`` (plain picklable
binary estimators), ``classes_``, and ``predict``/``predict_proba``/
``decision_function``.

Not ported yet (ROADMAP): the streamed (out-of-core) fits of both
meta-estimators, and the backends' host fan-out (``run_tasks``; the
generic path here runs its fits in turn).
"""

import os
import warnings

import numpy as np
import torch

from ..base import BaseEstimator, ClassifierMixin, clone, strip_runtime
from ..data import is_chunked
from ..featurize.labels import MultiLabelBinarizer
from ..featurize.scale import normalize
from ..parallel import (
    CUDABackend,
    IterativeKernelSpec,
    iterative_chunk_size,
    iterative_fit_supported,
    parse_partitions,
    prefers_host_engine,
)
from ..utils.meminfo import densify_budget_bytes
from ..utils.validation import (
    check_estimator_backend,
    check_is_fitted,
    full_length_sample_weight,
    safe_indexing,
)

__all__ = ["DistOneVsRestClassifier", "DistOneVsOneClassifier"]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _n_rows(X):
    return X.shape[0] if hasattr(X, "shape") else len(X)


def _nonfinite_lanes(stacked):
    """Boolean mask over the task axis of a dict of stacked numpy outputs
    marking lanes with any non-finite float, or None when all are
    finite."""
    mask = None
    for arr in stacked.values():
        arr = np.asarray(arr)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        finite = np.isfinite(arr)
        if finite.all():
            continue
        bad = ~finite.reshape(arr.shape[0], -1).all(axis=1)
        mask = bad if mask is None else (mask | bad)
    return mask


def _warn_nonfinite_lanes(stacked, describe, what):
    """Make a diverged lane of a batched multiclass fit loud: a
    ``FitFailedWarning`` naming the classes or pairs whose stacked params
    are not finite (``describe(lane) -> str``), instead of an argmax over
    NaN columns at predict time. ``SKDIST_FAULT_GUARD=0`` disables it."""
    if os.environ.get("SKDIST_FAULT_GUARD", "").strip().lower() in (
            "0", "false", "no"):
        return
    bad = _nonfinite_lanes(stacked)
    if bad is None or not bad.any():
        return
    from .search import FitFailedWarning

    idxs = np.where(bad)[0]
    names = ", ".join(describe(int(i)) for i in idxs[:5])
    if len(idxs) > 5:
        names += ", ..."
    warnings.warn(
        f"{int(bad.sum())} batched {what} fit(s) produced non-finite "
        f"parameters (diverged lanes: {names}); their predictions "
        "will be unreliable. Check hyperparameters / data scaling.",
        FitFailedWarning,
    )


def _refuse_chunked(X, what):
    """The streamed one-vs-rest and one-vs-one fits over a ChunkedDataset
    are not ported yet."""
    if is_chunked(X):
        raise NotImplementedError(
            f"{what}.fit over a ChunkedDataset (the streamed class-lane "
            "fit) is not ported to skdist_tpu_torch yet (see ROADMAP.md, "
            "queue 1 item 9b)")


class _ConstantPredictor(BaseEstimator):
    """The fallback of a label column with a single value."""

    def fit(self, X, y):
        self.y_ = np.asarray(y).ravel()[:1]
        return self

    def predict(self, X):
        return np.repeat(self.y_, _n_rows(X))

    def decision_function(self, X):
        return np.repeat(float(2 * self.y_[0] - 1), _n_rows(X))

    def predict_proba(self, X):
        p = float(self.y_[0])
        return np.repeat([[1.0 - p, p]], _n_rows(X), axis=0)


def _cv_results_as_strings(cv_results):
    """A search's ``cv_results_`` with every value as a string, column by
    column (a masked entry reads ``"nan"``)."""
    out = {}
    for name, col in cv_results.items():
        mask = np.ma.getmaskarray(col) if np.ma.isMaskedArray(col) else None
        values = list(col) if not isinstance(col, np.ndarray) else col.tolist()
        if mask is not None:
            values = [float("nan") if m else v
                      for v, m in zip(np.ma.getdata(col).tolist(), mask)]
        out[name] = [str(v) for v in values]
    return out


def _use_best_estimator(est):
    """Unwrap a fitted nested search to its ``best_estimator_``, carrying
    its ``cv_results_`` along as strings. An estimator with
    ``best_features_`` (a feature eliminator, whose inner model was refit
    on a feature subset) stays wrapped."""
    if not hasattr(est, "best_estimator_") or hasattr(est, "best_features_"):
        return est
    inner = est.best_estimator_
    if hasattr(est, "cv_results_"):
        inner.cv_results_ = _cv_results_as_strings(est.cv_results_)
    return inner


def _negatives_target(y_bin, max_negatives, method):
    """``(negatives to keep, negatives)`` of one binary column."""
    pos_mask = np.asarray(y_bin) == 1
    n_pos = int(pos_mask.sum())
    n_neg = int((~pos_mask).sum())
    if method == "ratio":
        target = max_negatives if isinstance(max_negatives, int) else int(
            round(max_negatives * n_neg))
    elif method == "multiplier":
        target = int(max_negatives * n_pos)
    else:
        raise ValueError("Unknown method. Options are 'ratio' or 'multiplier'.")
    return target, n_neg


def _negatives_mask(X, y, max_negatives=None, random_state=None,
                    method="ratio"):
    """Exact negative down-sampling: every positive, and ``target``
    negatives drawn without replacement (``ratio``: a fraction, or an int
    count, of the negatives; ``multiplier``: a multiple of the
    positives), shuffled."""
    if max_negatives is None:
        return X, y
    target, n_neg = _negatives_target(y, max_negatives, method)
    if target >= n_neg:
        return X, y
    pos_mask = np.asarray(y) == 1
    rng = np.random.RandomState(random_state)
    keep_neg = rng.choice(np.where(~pos_mask)[0], size=target, replace=False)
    keep = np.concatenate([np.where(pos_mask)[0], keep_neg])
    rng.shuffle(keep)
    return safe_indexing(X, keep), np.asarray(y)[keep]


def _fit_binary(estimator, X, y, fit_params=None, classes=None,
                max_negatives=None, random_state=None, method="ratio"):
    """One binary fit of the generic path: a column with one value gets a
    :class:`_ConstantPredictor` (with a warning naming the class when
    ``classes`` is given), else a clone of ``estimator`` fits the
    (down-sampled) column and a nested search is unwrapped."""
    fit_params = fit_params or {}
    unique_y = np.unique(y)
    if len(unique_y) == 1:
        if classes is not None:
            c = 0 if unique_y[0] in (-1, 0) else 1
            warnings.warn(
                f"Label {classes[c]} is present in all training examples.")
        return _ConstantPredictor().fit(X, y)
    est = clone(estimator)
    Xs, ys = _negatives_mask(X, y, max_negatives=max_negatives,
                             random_state=random_state, method=method)
    est.fit(Xs, ys, **fit_params)
    return _use_best_estimator(est)


def _binarize_multilabel(y):
    """Sequences of labels -> ``(Y (n, k) int32, classes)``: classes are
    the sorted union of every row's labels (int dtype when they are all
    ints, else object), ``Y[i, j] = 1`` when row i holds class j
    (``featurize.MultiLabelBinarizer``)."""
    mlb = MultiLabelBinarizer().fit(y)
    return mlb.transform(y).astype(np.int32), mlb.classes_


def _label_matrix(y, classes=None):
    """y (labels, sequences of labels, or a binary indicator matrix) ->
    ``(Y (n, k) int32, classes, multilabel)``. Only sequences of label
    collections are multilabel; a 1-D array of scalar labels (strings
    included) is multiclass."""
    if _is_sequence_of_seqs(y):
        Y, classes = _binarize_multilabel(y)
        return Y, classes, True
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        warnings.warn("A column-vector y was passed; ravelling to 1-D labels.")
        y = y.ravel()
    if y.ndim == 2:
        if not np.isin(np.unique(y), (0, 1)).all():
            raise ValueError(
                "2-D y must be a binary indicator matrix (values 0/1); "
                "got other values. For multiclass labels pass 1-D y.")
        classes = np.arange(y.shape[1]) if classes is None else classes
        return y.astype(np.int32), np.asarray(classes), True
    classes, y_idx = np.unique(y, return_inverse=True)
    Y = np.zeros((len(y), len(classes)), dtype=np.int32)
    Y[np.arange(len(y)), y_idx.reshape(-1)] = 1
    return Y, classes, False


def _is_sequence_of_seqs(y):
    try:
        first = y[0] if not hasattr(y, "iloc") else y.iloc[0]
    except (TypeError, IndexError, KeyError):
        return False
    return isinstance(first, (list, tuple, set, frozenset))


def _normalize_rows(X, norm):
    """Rows of ``X`` scaled to unit ``"l1"``, ``"l2"`` or ``"max"`` norm,
    a copy (``featurize.normalize``)."""
    return normalize(X, norm=norm)


def _batched_family(est):
    """Whether ``est``'s binary sub-problems run as one batched fit: its
    family's fit kernels take one label vector a lane."""
    return bool(getattr(type(est), "_lane_labels", False))


def _binary_prep(est, X):
    """``(host X, meta)`` of the {0, 1} binary sub-problems: the
    estimator's own ``_prep_fit_data`` with a synthetic two-class y, so
    the data context is built as a real binary fit builds it."""
    from ..models.linear import prepare_fit_X

    X_arr = prepare_fit_X(X, est)
    n = X_arr.shape[0]
    data, meta = est._prep_fit_data(X_arr, np.arange(n, dtype=np.int64) % 2,
                                    None)
    return data["X"], meta


def _binary_confidence(est, X):
    """Signed margin of a fitted binary estimator: a 1-D decision passes
    through, a two-column decision becomes its difference, otherwise
    ``proba - 0.5``."""
    if hasattr(est, "decision_function"):
        dec = np.asarray(est.decision_function(X))
        if dec.ndim == 1:
            return dec
        if dec.ndim == 2 and dec.shape[1] == 1:
            return dec[:, 0]
        if dec.ndim == 2 and dec.shape[1] == 2:
            return dec[:, 1] - dec[:, 0]
    return np.asarray(est.predict_proba(X))[:, 1] - 0.5


def _make_fitted_binary(base, params, meta):
    """A fitted binary estimator from one lane of the batched path's
    stacked params."""
    est = clone(base)
    est._set_fitted(params, meta)
    return est


def _iterative_fit_spec(est_cls, meta, static, n_slice, derive,
                        fallback_kernel, outputs=None, rung_score=None):
    """Wrap an estimator family's iteration-sliced fit kernels
    (``_build_fit_slice_kernels``) as an
    :class:`~skdist_tpu_torch.parallel.IterativeKernelSpec`.

    ``derive(shared, task) -> (op, y, w, hyper)`` gives the lanes'
    sub-problem (the CV search: fold-masked weights; one-vs-rest: the
    class column; one-vs-one: the pair mask). ``outputs(params, shared,
    task)`` turns the finalized fit params into the spec's outputs (the
    search scores them on the fold masks); None returns the params.
    ``rung_score(params, shared, task) -> (T,)`` adds the adaptive rung
    evaluator: params shaped from the live carry through the family's
    ``score_params`` kernel, then scored. ``fallback_kernel`` is the
    classic kernel with the same outputs."""
    ks = est_cls._build_fit_slice_kernels(meta, static, n_slice)

    def init(shared, task):
        return ks["init"](*derive(shared, task))

    def restart(shared, task, carry, slots):
        return ks["restart"](*derive(shared, task), carry, slots)

    def step(shared, task, carry):
        return ks["step"](*derive(shared, task), carry)

    def finalize(shared, task, carry):
        params = ks["finalize"](*derive(shared, task), carry)
        return params if outputs is None else outputs(params, shared, task)

    score = None
    if rung_score is not None:
        live = ks.get("score_params", ks["finalize"])

        def score(shared, task, carry):
            return rung_score(live(*derive(shared, task), carry), shared,
                              task)

    converged = None
    if "converged" in ks:
        def converged(shared, task, carry):
            return ks["converged"](*derive(shared, task), carry)

    return IterativeKernelSpec(
        init, restart, step, finalize, ks["finalize_keys"],
        fallback=fallback_kernel, score=score, converged=converged,
        max_iter=ks.get("max_iter"), iter_key=ks.get("iter_key", "it"),
    )


class _BatchedBinaryFits:
    """The batched path shared by one-vs-rest and one-vs-one: the binary
    sub-problem's meta and kernels for estimator ``est`` over ``X``, the
    data placed on the backend once, and :meth:`run`, which fits a task
    set (compacted or classic) and returns the stacked params."""

    def __init__(self, est, backend, X, sample_weight, extra_shared):
        from ..models.linear import _freeze, hyper_float, prepare_sample_weight

        est._check_supported()
        self.est = est
        self.est_cls = type(est)
        self.backend = backend
        X_arr, self.meta = _binary_prep(est, X)
        self.n = X_arr.shape[0]
        self.static = _freeze(est._static_config(self.meta))
        self.hyper = {k: hyper_float(getattr(est, k))
                      for k in self.est_cls._hyper_names}
        self.shared = backend.place({
            "X": X_arr, "sw": prepare_sample_weight(sample_weight, self.n),
            **extra_shared})
        self.shared["op"] = self.est_cls._fit_operand(
            self.shared["X"], self.meta, self.static)
        self.round_stats = []

    def task_hyper(self, n_tasks):
        """Every task's hyperparameters, the estimator's own."""
        return {k: np.full(n_tasks, v, dtype=np.float32)
                for k, v in self.hyper.items()}

    def run(self, derive, task_args, partitions, round_size=None):
        """Fit the tasks of ``task_args`` (``derive(shared, task) -> (op,
        y (T, n), w (T, n), hyper)``); returns ``{name: (n_tasks, ...)
        ndarray}``. A task set the compacted path takes runs there under
        ``partitions``; a given ``round_size`` (the down-sampling spans)
        keeps the classic path at that size. The classic path, whose
        backend pads a short last round to the round size, gives the
        compacted path's bits at equal round size."""
        est_cls, meta, static, n = self.est_cls, self.meta, self.static, self.n
        fit_kernel = est_cls._build_fit_kernel(meta, static)

        def kernel(shared, task):
            return fit_kernel(*derive(shared, task))

        n_tasks = len(next(iter(task_args.values())))
        sizes = dict(
            bytes_per_task=est_cls._batched_task_bytes(meta, static, n),
            bytes_per_round=est_cls._batched_round_bytes(meta, static, n))
        n_slice = iterative_fit_supported(
            self.backend, est_cls, n_tasks, dict(static).get("max_iter"))
        if round_size is None and n_slice is not None:
            spec = _iterative_fit_spec(est_cls, meta, static, n_slice, derive,
                                       kernel)
            if partitions not in ("auto", None):
                round_size = parse_partitions(partitions, n_tasks)
            elif getattr(est_cls, "_compacted_rounds", None):
                round_size = iterative_chunk_size(n_tasks, 1,
                                                  est_cls._compacted_rounds)
            out = self.backend.batched_map_iterative(
                spec, task_args, self.shared, round_size=round_size, **sizes)
        else:
            if round_size is None:
                round_size = parse_partitions(partitions, n_tasks)
            out = self.backend.batched_map(kernel, task_args, self.shared,
                                           round_size=round_size, **sizes)
        self.round_stats.append(dict(self.backend.last_round_stats,
                                     x_format=meta["x_format"]))
        return out

    def fitted(self, stacked, t):
        """The fitted binary estimator of lane ``t``."""
        return _make_fitted_binary(
            self.est, {k: np.asarray(v)[t] for k, v in stacked.items()},
            self.meta)


def _resolve_backend(backend, est):
    """The caller's backend, else a ``CUDABackend`` on the estimator's
    ``device``."""
    if backend is not None:
        return backend
    return CUDABackend(device=getattr(est, "device", None))


# ---------------------------------------------------------------------------
# OvR
# ---------------------------------------------------------------------------

class DistOneVsRestClassifier(BaseEstimator, ClassifierMixin):
    """One-vs-rest with the class axis as the task axis of one batched
    binary fit on the card.

    ``max_negatives``/``method``/``random_state`` down-sample each binary
    problem's negatives (``"ratio"``: a fraction, or an int count, of the
    negatives; ``"multiplier"``: a multiple of the positives), exactly as
    the generic path does. ``norm`` (``"l1"``/``"l2"``/``"max"``)
    normalises the stacked probabilities of ``predict_proba``.
    ``backend`` is a ``CUDABackend`` (default: one on the estimator's
    ``device``); ``partitions`` the round policy of the batched fit.
    With two classes (and no multilabel y) one binary estimator is fitted
    on the positive column (``binary_``).
    """

    def __init__(self, estimator, backend=None, partitions="auto",
                 max_negatives=None, method="ratio", norm=None,
                 random_state=None, verbose=0):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.max_negatives = max_negatives
        self.method = method
        self.norm = norm
        self.random_state = random_state
        self.verbose = verbose

    def fit(self, X, y=None, **fit_params):
        check_estimator_backend(self, self.verbose)
        _refuse_chunked(X, type(self).__name__)
        if self.method not in ("ratio", "multiplier"):
            raise ValueError(
                "Unknown method. Options are 'ratio' or 'multiplier'.")
        if y is None:
            raise TypeError("fit requires y")
        Y, classes, multilabel = _label_matrix(y)
        self.classes_ = classes
        self.multilabel_ = multilabel
        # two classes: one binary estimator on the positive column; the
        # negative column is its complement on the predict side
        self.binary_ = (not multilabel) and Y.shape[1] == 2
        if self.binary_:
            Y = Y[:, 1:]
        done = None
        sw, sw_ok = full_length_sample_weight(fit_params, _n_rows(X))
        if sw_ok:
            done = self._try_batched(X, Y, sample_weight=sw)
        if done is None:
            self._fit_generic(X, Y, fit_params)
        self.estimator = clone(self.estimator)
        strip_runtime(self)
        return self

    # -- batched device path ---------------------------------------------
    def _try_batched(self, X, Y, sample_weight=None):
        est = self.estimator
        # a dict class_weight is keyed by the original labels, which do
        # not map onto the {0, 1} sub-problems: the generic path
        if not _batched_family(est) or isinstance(
                getattr(est, "class_weight", None), dict):
            return None
        if prefers_host_engine(_resolve_backend(self.backend, est), est, X):
            return None
        col_sums = Y.sum(axis=0)
        n = Y.shape[0]
        degenerate = (col_sums == 0) | (col_sums == n)
        live = np.where(~degenerate)[0]
        estimators = [None] * Y.shape[1]
        self.round_stats_ = []
        if live.size:
            fits = _BatchedBinaryFits(
                est, _resolve_backend(self.backend, est), X, sample_weight,
                {"Yt": np.ascontiguousarray(Y.T)})
            use_masks = self.max_negatives is not None

            def derive(shared, task):
                y_bin = shared["Yt"].index_select(0, task["cls"])
                T = y_bin.shape[0]
                if use_masks:
                    w = shared["sw"] * task["keep"].to(torch.float32)
                else:
                    w = shared["sw"].repeat(T, 1)
                return shared["op"], y_bin, w, task["hyper"]

            # the masks of one dispatch span fit in the host budget; each
            # class draws from a fresh RandomState, so spans cannot
            # change the sampled sets
            span_rows = (self._mask_span_rows(n) if use_masks
                         else int(live.size))
            round_size = None
            if span_rows < int(live.size):
                round_size = min(
                    parse_partitions(self.partitions, int(live.size)),
                    span_rows)
                span_rows -= span_rows % round_size
            parts = []
            for lo in range(0, int(live.size), span_rows):
                cls_ = live[lo:lo + span_rows]
                task_args = {"cls": cls_.astype(np.int64),
                             "hyper": fits.task_hyper(len(cls_))}
                if use_masks:
                    task_args["keep"] = self._exact_keep_masks(Y, cls_)
                parts.append(fits.run(derive, task_args, self.partitions,
                                      round_size=round_size))
            stacked = {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}
            self.round_stats_ = fits.round_stats
            _warn_nonfinite_lanes(
                stacked, lambda i: f"class {self._col_label(live[i])!r}",
                "one-vs-rest")
            for t, cls_idx in enumerate(live):
                estimators[cls_idx] = fits.fitted(stacked, t)
        for cls_idx in np.where(degenerate)[0]:
            warnings.warn(
                f"Label {self._col_label(cls_idx)} is present in "
                f"{'all' if col_sums[cls_idx] == n else 'no'} training "
                "examples.")
            cp = _ConstantPredictor()
            cp.y_ = np.array([1 if col_sums[cls_idx] == n else 0])
            estimators[cls_idx] = cp
        self.estimators_ = estimators
        return True

    def _mask_span_rows(self, n):
        """Classes a dispatch span holds, so that its ``(classes, n)``
        uint8 mask block fits in 1/8 of the host budget."""
        budget, _ = densify_budget_bytes()
        if budget is None:
            return 1 << 30
        return max(1, int(budget // 8) // max(int(n), 1))

    def _exact_keep_masks(self, Y, live):
        """``(len(live), n)`` uint8 keep weights, as the generic path's
        ``_negatives_mask`` draws them: per class every positive, plus an
        exact without-replacement draw of the target number of negatives
        from a fresh ``RandomState(random_state)``."""
        n = Y.shape[0]
        keep = np.ones((live.size, n), dtype=np.uint8)
        for i, cls_idx in enumerate(live):
            y_bin = np.asarray(Y[:, cls_idx])
            target, n_neg = _negatives_target(y_bin, self.max_negatives,
                                              self.method)
            if target >= n_neg:
                continue
            pos_mask = y_bin == 1
            rng = np.random.RandomState(self.random_state)
            keep_neg = rng.choice(np.where(~pos_mask)[0], size=target,
                                  replace=False)
            mask = np.zeros(n, dtype=np.uint8)
            mask[pos_mask] = 1
            mask[keep_neg] = 1
            keep[i] = mask
        return keep

    def _col_label(self, col_idx):
        """The class label of column ``col_idx`` of the (possibly
        binary-reduced) label matrix."""
        if getattr(self, "binary_", False):
            return self.classes_[col_idx + 1]
        return self.classes_[col_idx]

    # -- generic path ------------------------------------------------------
    def _fit_generic(self, X, Y, fit_params):
        self.estimators_ = []
        for cls_idx in range(Y.shape[1]):
            label = self._col_label(cls_idx)
            if self.verbose:
                print(f"fitting class {label!r} ({cls_idx + 1} of {Y.shape[1]})")
            self.estimators_.append(_fit_binary(
                self.estimator, X, Y[:, cls_idx], fit_params,
                classes=[f"not-{label}", label],
                max_negatives=self.max_negatives,
                random_state=self.random_state, method=self.method))

    # -- predict side ------------------------------------------------------
    def _per_class_scores(self, X, want_proba):
        check_is_fitted(self, "estimators_")
        cols = []
        for est in self.estimators_:
            if want_proba:
                cols.append(np.asarray(est.predict_proba(X))[:, 1])
            else:
                cols.append(_binary_confidence(est, X))
        return np.column_stack(cols)

    def _expanded_scores(self, X, want_proba):
        """The per-class score matrix over ``classes_``; with one binary
        estimator the negative column is its complement."""
        scores = self._per_class_scores(X, want_proba)
        if getattr(self, "binary_", False):
            col = scores[:, 0]
            scores = (np.column_stack([1.0 - col, col]) if want_proba
                      else np.column_stack([-col, col]))
        return scores

    def predict_proba(self, X):
        """Stacked per-class positive probabilities, normalised by
        ``norm`` when it is set."""
        scores = self._expanded_scores(X, want_proba=True)
        if self.norm:
            scores = _normalize_rows(scores, self.norm)
        return scores

    def decision_function(self, X):
        scores = self._per_class_scores(X, want_proba=False)
        if getattr(self, "binary_", False):
            return scores[:, 0]
        return scores

    def predict(self, X):
        if self.multilabel_:
            proba_like = self._per_class_scores(X,
                                                want_proba=self._has_proba())
            thresh = 0.5 if self._has_proba() else 0.0
            return (proba_like > thresh).astype(np.int32)
        scores = self._expanded_scores(X, want_proba=self._has_proba())
        return self.classes_[np.argmax(scores, axis=1)]

    def _has_proba(self):
        return all(hasattr(e, "predict_proba") for e in self.estimators_)

    @property
    def n_classes_(self):
        return len(self.classes_)


# ---------------------------------------------------------------------------
# OvO
# ---------------------------------------------------------------------------

class DistOneVsOneClassifier(BaseEstimator, ClassifierMixin):
    """One-vs-one with the class-pair axis as the task axis of one
    batched binary fit on the card. Pairs ``(i, j)``, ``i < j``, with
    ``j`` the positive class; a pair's rows are a 0/1 weight mask times
    the sample weights, not a slice. ``decision_function`` is
    scikit-learn's votes plus a bounded sum of confidences."""

    def __init__(self, estimator, backend=None, partitions="auto",
                 verbose=0):
        self.estimator = estimator
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose

    def fit(self, X, y=None, **fit_params):
        check_estimator_backend(self, self.verbose)
        _refuse_chunked(X, type(self).__name__)
        if y is None:
            raise ValueError("y is required")
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        self.pairs_ = [(i, j) for i in range(k) for j in range(i + 1, k)]
        done = None
        sw, sw_ok = full_length_sample_weight(fit_params, _n_rows(X))
        if sw_ok:
            done = self._try_batched(X, y, sample_weight=sw)
        if done is None:
            self._fit_generic(X, y, fit_params)
        self.estimator = clone(self.estimator)
        strip_runtime(self)
        return self

    def _describe_pair(self, t):
        i, j = self.pairs_[t]
        return f"pair ({self.classes_[i]!r}, {self.classes_[j]!r})"

    def _try_batched(self, X, y, sample_weight=None):
        est = self.estimator
        if not _batched_family(est) or isinstance(
                getattr(est, "class_weight", None), dict):
            return None
        if prefers_host_engine(_resolve_backend(self.backend, est), est, X):
            return None
        y_idx = np.searchsorted(self.classes_, y).astype(np.int32)
        fits = _BatchedBinaryFits(
            est, _resolve_backend(self.backend, est), X, sample_weight,
            {"y": y_idx})

        def derive(shared, task):
            yi = shared["y"][None, :]
            in_pair = (yi == task["i"][:, None]) | (yi == task["j"][:, None])
            y_bin = (yi == task["j"][:, None]).to(torch.int32)
            w = in_pair.to(torch.float32) * shared["sw"]
            return shared["op"], y_bin, w, task["hyper"]

        task_args = {
            "i": np.asarray([p[0] for p in self.pairs_], dtype=np.int32),
            "j": np.asarray([p[1] for p in self.pairs_], dtype=np.int32),
            "hyper": fits.task_hyper(len(self.pairs_)),
        }
        stacked = fits.run(derive, task_args, self.partitions)
        self.round_stats_ = fits.round_stats
        _warn_nonfinite_lanes(stacked, self._describe_pair, "one-vs-one")
        self.estimators_ = [fits.fitted(stacked, t)
                            for t in range(len(self.pairs_))]
        return True

    def _fit_generic(self, X, y, fit_params):
        y_idx = np.searchsorted(self.classes_, y)
        n = _n_rows(X)
        self.estimators_ = []
        for i, j in self.pairs_:
            idx = np.where((y_idx == i) | (y_idx == j))[0]
            y_bin = (y_idx[idx] == j).astype(np.int32)
            fp = fit_params
            sw = fp.get("sample_weight") if fp else None
            if sw is not None:
                sw_arr = np.asarray(sw)
                if sw_arr.ndim == 2 and sw_arr.shape[1] == 1:
                    sw_arr = sw_arr.ravel()
                if sw_arr.shape[:1] == (n,):
                    # full-length weights follow the pair's rows
                    fp = dict(fp, sample_weight=sw_arr[idx])
            self.estimators_.append(_fit_binary(
                self.estimator, safe_indexing(X, idx), y_bin, fp,
                classes=[i, j]))

    def decision_function(self, X):
        """scikit-learn's one-vs-one aggregation: votes plus a bounded
        sum of confidences as the tie-break."""
        check_is_fitted(self, "estimators_")
        n = _n_rows(X)
        k = len(self.classes_)
        votes = np.zeros((n, k))
        sum_conf = np.zeros((n, k))
        for (i, j), est in zip(self.pairs_, self.estimators_):
            conf = _binary_confidence(est, X).reshape(n)
            votes[:, i] += conf < 0
            votes[:, j] += conf >= 0
            sum_conf[:, i] -= conf
            sum_conf[:, j] += conf
        return votes + sum_conf / (3 * (np.abs(sum_conf) + 1))

    def predict(self, X):
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]

    @property
    def n_classes_(self):
        return len(self.classes_)
