"""
Linear estimator kernels of the port: logistic regression, the linear
SVM (``LinearSVC``), the mini-batch SGD classifier and the ridge family
(``Ridge``, ``LinearRegression``, ``RidgeClassifier``).

Counterpart of ``skdist_tpu/models/linear.py``. The estimator is built
around batched fit kernels: ``_build_fit_kernel(meta, static)`` returns
``kernel(op, y_idx, sw, hyper)`` that fits ``T`` tasks at once, where
``sw`` is ``(T, n)`` (fold masks times sample weights) and each
``hyper`` value is a ``(T,)`` tensor. The distributed search stacks its
(candidate x fold) tasks on that axis; a single ``fit`` is a batch of
one. Folds are selected by sample-weight masking, never by slicing rows.
The classifiers marked ``_lane_labels`` also take one label vector a
lane, ``y_idx`` of shape ``(T, n)``: the binary sub-problems of
one-vs-rest and one-vs-one (:mod:`skdist_tpu_torch.distribute.multiclass`).

The logistic objective is the JAX package's (and sklearn's):
``sum_i s_i * ce_i + 0.5 / C * ||w||^2``, intercept unpenalised. The
multinomial weights are a flat ``p * k`` vector reshaped row-major to
``(p, k)``, the JAX package's layout, so ``coef_`` and
:mod:`skdist_tpu_torch.convert` line up with it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import BaseEstimator, ClassifierMixin, RegressorMixin
from ..data import is_chunked
from ..sparse import (
    LinearOperator,
    MaskedLinearOperator,
    PackedX,
    lane_row_mask,
    matvec_any,
    pack_for_fit,
    sparse_to_dense_f32,
)
from ..utils.device import exact_matmuls, lane_sum, resolve_device
from .solvers import (
    carry_iterate,
    lbfgs_carry_init,
    lbfgs_carry_restart,
    lbfgs_minimize,
    lbfgs_resume,
    sgd_carry_init,
    sgd_carry_restart,
    sgd_minimize,
    sgd_resume,
)

__all__ = ["LogisticRegression", "LinearSVC", "SGDClassifier", "Ridge",
           "LinearRegression", "RidgeClassifier"]

#: state tensors of one task's L-BFGS solve held in memory at once, in
#: units of its flat weight vector: the 2 * history ring plus this many
#: working vectors (w, g, direction, two-loop and line-search temps,
#: gradient buffers); the round sizer bills tasks with it
_LBFGS_WORK_VECTORS = 12


# --------------------------------------------------------------------------
# data plumbing
# --------------------------------------------------------------------------

def as_dense_f32(X):
    """Convert input to a dense float32 ndarray."""
    if hasattr(X, "toarray"):  # scipy sparse
        return sparse_to_dense_f32(X)
    elif hasattr(X, "values") and not isinstance(X, np.ndarray):  # pandas
        X = X.values
    X = np.asarray(X)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    return np.ascontiguousarray(X, dtype=np.float32)


def prepare_fit_X(X, est=None):
    """A :class:`~skdist_tpu_torch.sparse.PackedX` (numpy leaves) when the
    packed plane wins for this input and the estimator consumes it, else
    a dense float32 ndarray."""
    cls = (
        est if isinstance(est, type)
        else (type(est) if est is not None else None)
    )
    if cls is None or getattr(cls, "_supports_packed_X", False):
        packed = pack_for_fit(X)
        if packed is not None:
            return packed
    return as_dense_f32(X)


def to_device_X(X, device):
    """A prepared fit input (PackedX or ndarray) as tensors on ``device``."""
    if isinstance(X, PackedX):
        return X.to(device)
    return torch.as_tensor(X, dtype=torch.float32).to(device)


def encode_labels(y):
    """y -> (int32 indices, classes array)."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    classes, y_idx = np.unique(y, return_inverse=True)
    return y_idx.reshape(-1).astype(np.int32), classes


def prepare_sample_weight(sample_weight, n):
    """Normalise user weights to a (n,) f32 vector: scalars broadcast,
    (n, 1) columns flatten, anything else is rejected."""
    if sample_weight is None:
        return np.ones(n, dtype=np.float32)
    sw = np.asarray(sample_weight, dtype=np.float32)
    if sw.ndim == 0:
        return np.full(n, float(sw), dtype=np.float32)
    if sw.ndim == 2 and sw.shape[1] == 1:
        sw = sw.ravel()
    if sw.shape != (n,):
        raise ValueError(
            f"sample_weight has shape {np.shape(sample_weight)}; expected "
            f"({n},), ({n}, 1) or a scalar"
        )
    return sw


def class_weight_vector(class_weight, classes):
    """Per-class multiplier array, or None. 'balanced' resolves on the
    device from the effective (masked) counts."""
    if class_weight is None or class_weight == "balanced":
        return None
    arr = np.ones(len(classes), dtype=np.float32)
    for i, c in enumerate(classes):
        key = c.item() if hasattr(c, "item") else c
        if c in class_weight:
            arr[i] = class_weight[c]
        elif key in class_weight:
            arr[i] = class_weight[key]
    return arr


def _apply_class_weight(sw, y_idx, n_classes, class_weight, cw_arr):
    """Class weighting of ``sw (..., n)`` on its device. 'balanced' uses
    the weighted class counts of the current (fold-masked) weights of
    each task: sklearn's n / (k * count_c). ``y_idx`` is ``(n,)``, or
    ``(T, n)`` with one label vector a lane."""
    if class_weight is None:
        return sw
    y_long = y_idx.long()
    if class_weight == "balanced":
        onehot = F.one_hot(y_long, n_classes).to(sw.dtype)
        if y_long.ndim == 1:
            counts = sw @ onehot  # (..., k)
        else:
            counts = (sw[..., None, :] @ onehot)[..., 0, :]  # (T, k)
        total = torch.sum(sw, dim=-1, keepdim=True)
        per_class = total / (n_classes * torch.clamp(counts, min=1e-12))
        per_class = torch.where(counts > 0, per_class, 0.0)
    else:
        per_class = torch.as_tensor(cw_arr, dtype=sw.dtype, device=sw.device)
    if y_long.ndim == 2 and per_class.ndim == 2:
        return sw * per_class.gather(-1, y_long)
    return sw * per_class[..., y_long]


def hyper_float(value):
    """A ``_hyper_names`` value as float32; ``tol=None`` maps to -inf."""
    return np.float32(-np.inf if value is None else value)


def _freeze(d):
    """dict -> hashable tuple (values frozen recursively)."""

    def fr(v):
        if isinstance(v, dict):
            return tuple(sorted((k, fr(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(fr(x) for x in v)
        return v

    return tuple(sorted((k, fr(v)) for k, v in d.items()))


def _linear_decision(d, fit_intercept, one_column):
    """``(W, X) -> X @ w + b`` for a linear model of ``d`` features whose
    weights are one column (``one_column``: ``W`` is ``(p,)``, or a task
    batch ``(T, p)``) or k columns (``(p, k)`` or ``(T, p, k)``); X is a
    device tensor or PackedX. Returns ``(n,)``/``(n, k)`` or
    ``(T, n)``/``(T, n, k)``."""

    def decision(W, X):
        if one_column and W.ndim == 2:
            return decision(W[:, :, None], X)[..., 0]
        w = W[..., :d, :] if W.ndim == 3 else W[:d]
        out = matvec_any(X, w)
        if not fit_intercept:
            return out
        b = W[..., d, :] if W.ndim == 3 else W[d]
        return out + (b[:, None, :] if W.ndim == 3 else b)

    return decision


# --------------------------------------------------------------------------
# shared linear-model machinery
# --------------------------------------------------------------------------

class _LinearModelBase(BaseEstimator):
    """Fitted-state handling and the batched-fit contract consumed by
    :mod:`skdist_tpu_torch.distribute.search`:

    - ``_hyper_names``: constructor params that ride the task axis
    - ``_static_names``: params that shape the kernel; candidates that
      differ here run in separate buckets
    - ``_prep_fit_data(X, y, sample_weight)`` -> (host data, meta)
    - ``_fit_operand(X, meta, static)`` -> the fit kernels' shared operand
    - ``_build_fit_kernel(meta, static)`` -> batched fit kernel
    - ``_build_decision_kernel(meta, static)`` -> (W, X) -> raw scores,
      with ``W = _decision_params(fit outputs)``
    """

    _hyper_names = ()
    _static_names = ()
    _supports_packed_X = True

    #: the family's streamed fit over a ``ChunkedDataset``
    #: (:mod:`~skdist_tpu_torch.models.streaming`): ``"lbfgs"``
    #: (block-accumulated loss and gradient passes), ``"sgd"`` and
    #: ``"gram"`` (ROADMAP Queue 1 item 9b, not ported yet), or None
    _stream_fit_kind = None

    def fit(self, X, y=None, sample_weight=None, coef_init=None,
            intercept_init=None):
        """Fit on ``device`` (the card unless ``device="cpu"``), or on the
        f64 host engine where :meth:`_resolve_host_engine` picks it.

        ``coef_init``/``intercept_init`` (scikit-learn's shapes: a
        parent fit's ``coef_``/``intercept_``) warm-start the iterative
        families: the L-BFGS and SGD solves start from the seed instead
        of zeros, the host engine takes it as its flat ``_warm_w0``. The
        closed-form ridge family accepts the seeds and ignores them (a
        direct solve has no iterate to seed), as in the JAX package.

        Packed sparse X stays on the device path under ``engine='auto'``
        (the host engine has no packed form); an explicit
        ``engine='host'`` densifies it.

        A :class:`~skdist_tpu_torch.data.ChunkedDataset` ``X`` is fitted
        out of core (:func:`~skdist_tpu_torch.models.streaming.
        stream_fit_estimator`, the ``"lbfgs"`` kind only), its labels and
        weights read from the dataset unless given."""
        self._check_supported()
        if is_chunked(X):
            from .streaming import stream_fit_estimator

            return stream_fit_estimator(self, X, y, sample_weight,
                                        coef_init=coef_init,
                                        intercept_init=intercept_init)
        if y is None:
            raise TypeError(
                f"{type(self).__name__}.fit requires y (only a "
                "ChunkedDataset carries its own labels)")
        if getattr(self, "engine", None) == "host":
            X = as_dense_f32(X)
        else:
            X = prepare_fit_X(X, type(self))
        warm = coef_init is not None or intercept_init is not None
        if not isinstance(X, PackedX) and self._resolve_host_engine():
            if not warm:
                return self._host_fit(X, y, sample_weight)
            # scoped to this fit, so a later cold fit never inherits it
            self._warm_w0 = self._warm_w0_flat(
                X.shape[1], self._warm_n_out(y), coef_init, intercept_init,
            ).astype(np.float64)
            try:
                return self._host_fit(X, y, sample_weight)
            finally:
                del self._warm_w0
        device = resolve_device(self.device)
        data, meta = self._prep_fit_data(X, y, sample_weight)
        static = _freeze(self._static_config(meta))
        kernel = self._build_fit_kernel(meta, static)
        hyper = {
            k: torch.tensor([hyper_float(getattr(self, k))], device=device)
            for k in self._hyper_names
        }
        w0 = None
        if warm:
            k = meta.get("n_classes", 2)
            w0 = torch.as_tensor(self._warm_w0_flat(
                meta["n_features"], 1 if k <= 2 else k, coef_init,
                intercept_init))[None].to(device)
        with exact_matmuls():
            op = self._linear_op(to_device_X(data["X"], device), static)
            params = kernel(
                op,
                torch.as_tensor(data["y"]).to(device),
                torch.as_tensor(data["sw"]).to(device)[None],
                hyper, w0=w0,
            )
        self._set_fitted(
            {k: v[0].detach().cpu().numpy() for k, v in params.items()}, meta
        )
        return self

    def _warm_n_out(self, y):
        """Solver output columns for shaping a warm seed before the fit's
        meta exists: a classifier folds two classes to one column, a
        regressor has one."""
        if isinstance(self, ClassifierMixin):
            k = int(np.unique(np.asarray(y)).size)
            return 1 if k <= 2 else k
        return 1

    def _warm_w0_flat(self, d, n_out, coef_init, intercept_init):
        """Warm-start seeds in scikit-learn's shapes as the family's flat
        solver layout: ``W`` ``(p, n_out)``, rows ``[:d]`` the
        coefficients and row ``d`` the intercept (when fitted), flattened
        row-major to ``(p * n_out,)``, or ``(p,)`` for one column: the
        layout ``unpack`` reshapes and the host engine's ``x0`` takes.
        The JAX package's shape checks and messages."""
        fit_intercept = self.fit_intercept
        d, n_out = int(d), int(n_out)
        p = d + (1 if fit_intercept else 0)
        W = np.zeros((p, n_out), np.float32)
        if coef_init is not None:
            coef = np.asarray(coef_init, np.float32)
            if n_out == 1:
                coef = coef.reshape(-1)
                if coef.shape[0] != d:
                    raise ValueError(
                        f"coef_init has {coef.shape[0]} features; the "
                        f"fit data has {d}"
                    )
                W[:d, 0] = coef
            elif coef.shape == (n_out, d):
                W[:d] = coef.T
            elif coef.shape == (d, n_out):
                W[:d] = coef
            else:
                raise ValueError(
                    f"coef_init shape {coef.shape} does not match "
                    f"({n_out}, {d}) (classes x features)"
                )
        if intercept_init is not None:
            b = np.asarray(intercept_init, np.float32).reshape(-1)
            if not fit_intercept:
                if np.any(b != 0):
                    raise ValueError(
                        "intercept_init is nonzero but "
                        "fit_intercept=False — this family fits no "
                        "intercept to seed"
                    )
            else:
                if b.shape[0] == 1 and n_out > 1:
                    b = np.repeat(b, n_out)
                if b.shape[0] != n_out:
                    raise ValueError(
                        f"intercept_init has {b.shape[0]} entries; "
                        f"expected {n_out}"
                    )
                W[d] = b
        return W.reshape(-1) if n_out > 1 else W[:, 0]

    #: the f64 host engine's fit, ``(X, y, sample_weight) -> self``; None
    #: for a family without one
    _host_fit = None

    def _resolve_host_engine(self):
        """Whether this fit runs the f64 host engine
        (:mod:`~skdist_tpu_torch.models.host_linear`) instead of the
        batched torch kernel. Never for a family without one. With one:
        ``engine='xla'`` pins the torch kernel, ``'host'`` the host
        engine, and ``'auto'`` picks the host engine exactly where the
        estimator's device is the CPU and scipy imports (the JAX
        package's ``jax.default_backend() == "cpu"``): on the card
        (``device`` None or ``"cuda"``) ``'auto'`` never does.
        ``matmul_dtype='bfloat16'`` opts out of ``'auto'``. Nothing here
        touches the card."""
        if self._host_fit is None:
            return False
        engine = getattr(self, "engine", "xla")
        if engine not in ("auto", "host", "xla"):
            raise ValueError(
                f"engine must be 'auto', 'host' or 'xla'; got {engine!r}"
            )
        if engine != "auto":
            return engine == "host"
        if getattr(self, "matmul_dtype", None) == "bfloat16":
            return False
        from .host_linear import host_engine_available

        device = torch.device("cuda" if self.device is None else self.device)
        return device.type == "cpu" and host_engine_available()

    def _run_host_engine(self, engine_fit, C, X, y, sample_weight):
        """One fit of a classifier's host engine ``engine_fit``
        (:mod:`~skdist_tpu_torch.models.host_linear`) at ``C``. A caller's
        ``_warm_w0`` (the warm C path's previous optimum, or a
        ``coef_init`` seed) starts the solve when its shape fits this
        problem; the fitted instance keeps its own float64 optimum as
        ``_w_opt64`` (None when the solve stopped on ``max_iter``) for
        the next fit of a warm C path."""
        data, meta = self._prep_fit_data(as_dense_f32(X), y, sample_weight)
        k = meta["n_classes"]
        p = meta["n_features"] + (1 if self.fit_intercept else 0)
        w0 = getattr(self, "_warm_w0", None)
        if w0 is not None and np.shape(w0) != ((p if k <= 2 else p * k),):
            w0 = None
        params, w_opt = engine_fit(
            data["X"], data["y"], data["sw"],
            C=C, tol=hyper_float(self.tol),
            max_iter=self.max_iter, fit_intercept=self.fit_intercept,
            n_classes=k, history=self.history,
            class_weight=self.class_weight, cw_arr=meta.get("cw_arr"),
            w0=w0,
        )
        self._set_fitted(params, meta)
        self._w_opt64 = w_opt
        return self

    def __getstate__(self):
        """Pickle without the warm-start scratch: the float64 optimum
        ``_w_opt64`` only seeds the next fit of a warm C path in a live
        search, and would triple a big model's pickle."""
        state = self.__dict__.copy()
        state.pop("_w_opt64", None)
        state.pop("_warm_w0", None)
        return state

    def _check_supported(self):
        """Raise for invalid settings (also those set through
        ``set_params``)."""

    @classmethod
    def _linear_op(cls, X, static):
        """The fit problems' matvec interface over device ``X``."""
        return LinearOperator(X, dict(static)["fit_intercept"])

    @classmethod
    def _fit_operand(cls, X, meta, static):
        """The batched fit kernels' shared operand over device ``X``, as
        the searches and the multiclass meta-estimators build it once:
        the :meth:`_linear_op`."""
        return cls._linear_op(X, static)

    @classmethod
    def _decision_params(cls, params):
        """What the decision and proba kernels read of a batched fit's
        outputs: the weights ``W``."""
        return params["W"]

    @classmethod
    def _mask_operand(cls, op, fmask):
        """The fit operand of lanes that each see only the columns of
        their row of ``fmask (T, d)`` (the feature eliminator's task
        axis): a :class:`~skdist_tpu_torch.sparse.MaskedLinearOperator`
        view of ``op``, which copies no X."""
        return MaskedLinearOperator(op, fmask)

    @classmethod
    def _mask_decision_params(cls, W, fmask):
        """The lanes' decision weights ``W (T, p[, k])`` with each lane's
        masked feature rows zeroed (the intercept row is kept), so a
        masked column adds 0 to the decision, as ``X * fmask`` does."""
        m = lane_row_mask(fmask, W.shape[1], W.dtype)
        return W * (m[..., None] if W.ndim == 3 else m)

    @classmethod
    def _mask_task_bytes(cls, meta, static):
        """Device bytes a masked lane holds beside an unmasked one: its
        ``(p,)`` row mask and the masked copies of its weights that a
        product keeps (the forward's, the gradient's, the decision's)."""
        p = meta["n_features"] + 1
        k = meta.get("n_classes", meta.get("n_targets", 1))
        return 4 * p * (1 + 3 * max(k, 1))

    def _static_config(self, meta):
        return {k: getattr(self, k) for k in self._static_names}

    def _set_fitted(self, params, meta):
        """Fitted state as host numpy: ``_params`` (``W`` and
        ``n_iter``) and ``_meta``, the JAX package's layout."""
        self._params = params
        self._meta = meta
        self.n_features_in_ = meta["n_features"]
        if "classes" in meta:
            self.classes_ = meta["classes"]
        if "n_iter" in params:
            self.n_iter_ = np.asarray(params["n_iter"])

    def _check_fitted(self):
        if not hasattr(self, "_params"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet."
            )

    def _device_outputs(self, X, which):
        self._check_fitted()
        device = resolve_device(self.device)
        X = prepare_fit_X(X, type(self))
        static = _freeze(self._static_config(self._meta))
        kernel = getattr(type(self), f"_build_{which}_kernel")(
            self._meta, static
        )
        params = self._kernel_params()
        W = ({k: torch.as_tensor(v).to(device) for k, v in params.items()}
             if isinstance(params, dict)
             else torch.as_tensor(params).to(device))
        with exact_matmuls(), torch.no_grad():
            out = kernel(W, to_device_X(X, device))
        return out.cpu().numpy()

    def _kernel_params(self):
        """The fitted array the decision and proba kernels read, ``W``, as
        a float32 copy."""
        return np.array(self._params["W"], dtype=np.float32)

    def decision_function(self, X):
        if is_chunked(X):
            raise TypeError(
                "decision_function does not take a ChunkedDataset; use "
                "skdist_tpu_torch.batch_predict(model, dataset) (or "
                "predict/predict_proba, which route there) to stream "
                "inference block by block")
        return self._device_outputs(X, "decision")

    def _predict_chunked(self, dataset, method):
        """``method`` over a ChunkedDataset, block by block
        (:func:`~skdist_tpu_torch.distribute.predict.batch_predict`)."""
        from ..distribute.predict import batch_predict

        return batch_predict(self, dataset, method=method)

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """Device bytes a round holds once, whatever its task count."""
        return 0

    def _sklearn_2d_coef(self):
        """Whether a one-column model's ``coef_`` is ``(1, d)`` (a
        classifier) rather than ``(d,)``."""
        return isinstance(self, ClassifierMixin)

    def _linear_W(self):
        """The fitted linear weights ``W``; an ``AttributeError`` for a
        model whose decision is not linear (the JAX package's)."""
        self._check_fitted()
        if "W" not in self._params:
            raise AttributeError(
                f"{type(self).__name__} has no linear coefficients")
        return np.asarray(self._params["W"])

    @property
    def coef_(self):
        W = self._linear_W()  # (d[+1], k) or (d[+1],)
        w = W[: self.n_features_in_]
        if w.ndim == 1:
            return w.reshape(1, -1) if self._sklearn_2d_coef() else w
        return w.T

    @property
    def intercept_(self):
        W = self._linear_W()
        if not self.fit_intercept:
            k = 1 if W.ndim == 1 else W.shape[1]
            return np.zeros(k, dtype=W.dtype)
        return np.atleast_1d(W[self.n_features_in_])


class _LinearClassifierBase(_LinearModelBase, ClassifierMixin):
    def _prep_stream_fit(self, dataset, y, sample_weight=None):
        """The streamed fit's host prep: labels encoded once over the
        whole dataset (a block that lacks a class still builds the whole
        problem), weights and ``meta`` from O(n) vectors and the
        dataset's shape, no X read. Returns ``(y_idx (n,), sw (n,),
        meta)``."""
        if y is None:
            raise ValueError(
                f"{type(self).__name__} needs labels: the ChunkedDataset "
                "carries none and no y was passed")
        y_idx, classes = encode_labels(y)
        if y_idx.shape[0] != dataset.n_rows:
            raise ValueError(
                f"y has {y_idx.shape[0]} labels; the dataset has "
                f"{dataset.n_rows} rows")
        sw = prepare_sample_weight(sample_weight, dataset.n_rows)
        if getattr(self, "class_weight", None) == "balanced":
            raise ValueError(
                "class_weight='balanced' needs a global pass over the "
                "masked weights and is not supported on the streamed fit "
                "path yet; pass an explicit class_weight dict")
        meta = {
            "n_features": dataset.n_features,
            "classes": classes,
            "n_classes": len(classes),
            "cw_arr": class_weight_vector(
                getattr(self, "class_weight", None), classes),
            "x_format": dataset.x_format,
        }
        if dataset.x_format == "packed":
            meta["packed_m"] = dataset.packed_m
        return y_idx, sw, meta

    def _prep_fit_data(self, X, y, sample_weight=None):
        y_idx, classes = encode_labels(y)
        sw = prepare_sample_weight(sample_weight, X.shape[0])
        meta = {
            "n_features": X.shape[1],
            "classes": classes,
            "n_classes": len(classes),
            "cw_arr": class_weight_vector(
                getattr(self, "class_weight", None), classes
            ),
            "x_format": "packed" if isinstance(X, PackedX) else "dense",
        }
        if isinstance(X, PackedX):
            meta["packed_m"] = X.m
        return {"X": X, "y": y_idx, "sw": sw}, meta

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        return _linear_decision(meta["n_features"],
                                dict(static)["fit_intercept"],
                                meta["n_classes"] <= 2)

    def predict(self, X):
        if is_chunked(X):
            return self._predict_chunked(X, "predict")
        scores = self.decision_function(X)
        if scores.ndim == 1:
            idx = (scores > 0).astype(np.int64)
        else:
            idx = np.argmax(scores, axis=1)
        return self.classes_[idx]


# --------------------------------------------------------------------------
# LogisticRegression
# --------------------------------------------------------------------------

class _LbfgsFitMixin:
    """Fit kernels for the L-BFGS family, all built from the one
    ``_build_fit_problem(meta, static)`` definition of the objective:
    ``problem(op, y_idx, sw, hyper) -> (loss, w0, unpack)``, where
    ``unpack(w, n_iter)`` shapes the fitted params. The plain fit kernel
    and the iteration-sliced kernels (:meth:`_build_fit_slice_kernels`,
    the contract of the convergence-compacted scheduler) minimise the
    same objective, so a sliced solve is bitwise the unsliced one."""

    #: the scheduler gates' marker (``parallel.iterative_fit_supported``)
    _supports_sliced_fit = True

    #: out of core: block-accumulated loss and gradient passes through
    #: the resident solver's L-BFGS step (``models/streaming.py``)
    _stream_fit_kind = "lbfgs"

    @classmethod
    def _batched_task_cost(cls, hyper):
        """Per-task convergence-cost heuristic for ordering the task axis
        (``hyper``: dict of per-task arrays). Weak regularisation (large
        C) and a tight tolerance both mean more iterations, log-additive
        so neither axis drowns the other; ``tol <= 0`` (``tol=None``)
        never converges and sorts last."""
        C = np.asarray(hyper.get("C", 1.0), dtype=np.float64)
        tol = np.asarray(hyper.get("tol", 1e-4), dtype=np.float64)
        cost = np.log(np.maximum(C, 1e-30)) - np.where(
            tol > 0, np.log(np.where(tol > 0, tol, 1.0)), -np.inf
        )
        return np.broadcast_to(cost, np.broadcast_shapes(C.shape, tol.shape))

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        problem = cls._build_fit_problem(meta, static)
        st = dict(static)
        max_iter, hist = st["max_iter"], st["history"]

        def kernel(op, y_idx, sw, hyper, w0=None):
            loss, zeros, unpack = problem(op, y_idx, sw, hyper)
            # a warm start begins at the caller's seed (flat layout)
            start = zeros if w0 is None else w0.to(zeros).expand_as(zeros)
            w, n_iter = lbfgs_minimize(loss, start, tol=hyper["tol"],
                                       max_iter=max_iter, history=hist)
            return unpack(w.detach(), n_iter)

        return kernel

    @classmethod
    def _build_fit_slice_kernels(cls, meta, static, n_slice):
        """The iteration-sliced fit, each kernel over a batch of ``T``
        lanes ``(op, y_idx, sw, hyper, ...)`` as the plain kernel:

        - ``init(...) -> carry``: start every lane's solve (no iteration);
        - ``restart(..., carry, slots)``: start the lanes at ``slots``
          afresh in place, from the batch's rows at ``slots``;
        - ``step(..., carry) -> carry``: advance by ``n_slice`` iterations;
        - ``finalize(..., carry)``: the fitted params from the
          ``finalize_keys`` leaves (``w``, ``it``) only, so retired lanes'
          history never needs keeping; ``score_params`` is the same
          function on a live carry (its iterate is a valid model);
        - ``converged(..., carry) -> (T,) bool``: ``max|g| <= tol``, the
          solver's own test, to tell converged lanes from stalled ones.

        Unlike the JAX package's ``init``, this one runs no iteration:
        the scheduler's first slice steps it, so a lane started by
        ``restart`` runs exactly the iterations of one started by
        ``init``."""
        problem = cls._build_fit_problem(meta, static)
        st = dict(static)
        max_iter, hist = st["max_iter"], st["history"]
        n_slice = int(n_slice)

        def init(op, y_idx, sw, hyper):
            loss, w0, _ = problem(op, y_idx, sw, hyper)
            return lbfgs_carry_init(loss, w0, hyper["tol"],
                                    max_iter=max_iter, history=hist)

        def restart(op, y_idx, sw, hyper, carry, slots):
            loss, w0, _ = problem(op, y_idx, sw, hyper)
            return lbfgs_carry_restart(loss, carry, slots,
                                       w0.index_select(0, slots),
                                       hyper["tol"], max_iter=max_iter)

        def step(op, y_idx, sw, hyper, carry):
            loss, _, _ = problem(op, y_idx, sw, hyper)
            return lbfgs_resume(loss, carry, n_slice, hyper["tol"],
                                max_iter=max_iter, history=hist)

        def finalize(op, y_idx, sw, hyper, carry):
            _, _, unpack = problem(op, y_idx, sw, hyper)
            return unpack(carry_iterate(carry), carry["it"])

        def converged(op, y_idx, sw, hyper, carry):
            return carry["g"].abs().amax(dim=1) <= hyper["tol"]

        return {
            "init": init, "restart": restart, "step": step,
            "finalize": finalize, "finalize_keys": ("w", "it"),
            "score_params": finalize, "converged": converged,
            "max_iter": max_iter,
        }


class _ProbaMixin:
    """Probabilities from the decision: the sigmoid of a binary model's
    one column, the softmax of a multiclass model's k columns (the JAX
    package's ``_build_proba_kernel``)."""

    @classmethod
    def _build_proba_kernel(cls, meta, static):
        decision = cls._build_decision_kernel(meta, static)
        binary = meta["n_classes"] <= 2

        def proba(W, X):
            z = decision(W, X)
            if binary:
                p1 = torch.sigmoid(z)
                return torch.stack([1.0 - p1, p1], dim=-1)
            return torch.softmax(z, dim=-1)

        return proba

    def predict_proba(self, X):
        if is_chunked(X):
            return self._predict_chunked(X, "predict_proba")
        return self._device_outputs(X, "proba")

    def predict_log_proba(self, X):
        return np.log(np.clip(self.predict_proba(X), 1e-15, None))


class LogisticRegression(_ProbaMixin, _LbfgsFitMixin, _LinearClassifierBase):
    """L2 multinomial / binary logistic regression via batched L-BFGS.

    The JAX package's constructor arguments, plus ``device`` (the card
    unless ``"cpu"``). ``C`` and ``tol`` ride the task axis of a grid;
    the others shape the kernel.

    ``engine`` picks the engine: ``'xla'`` this batched torch engine,
    ``'host'`` the f64 host engine (scipy's L-BFGS-B,
    :mod:`~skdist_tpu_torch.models.host_linear`), and ``'auto'`` the
    host engine where ``device="cpu"`` (the JAX package's default on a
    CPU platform) and this engine on the card. Both minimise the same
    objective and agree at the optimum to solver tolerance; they stop
    differently at one ``tol``.

    ``matmul_dtype="bfloat16"`` runs the fit's loss products with bf16
    operands and float32 accumulation (the JAX package's opt-in
    screening precision; the solver state, reductions and regulariser
    stay float32, and so does prediction): over dense X a float32
    product of the bf16-rounded operands (exact products, float32 sums,
    TF32 off under ``exact_matmuls``), over packed X the JAX package's
    gather expression ``(v_bf16 * W_bf16[idx]).float().sum(1)``
    (:class:`~skdist_tpu_torch.sparse.LinearOperator`), not the packed
    kernels.
    """

    _hyper_names = ("C", "tol")
    _static_names = (
        "max_iter", "fit_intercept", "class_weight", "history",
        "matmul_dtype", "engine", "penalty",
    )

    #: the binary fit takes one label vector a lane (one-vs-rest/-one)
    _lane_labels = True

    def __init__(self, C=1.0, tol=1e-4, max_iter=100, fit_intercept=True,
                 class_weight=None, penalty="l2", random_state=None,
                 history=10, matmul_dtype=None, engine="auto", device=None):
        self.C = C
        self.tol = tol
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        self.class_weight = class_weight
        self.penalty = penalty
        self.random_state = random_state
        self.history = history
        self.matmul_dtype = matmul_dtype
        self.engine = engine
        self.device = device
        if penalty not in ("l2", None, "none"):
            raise ValueError(
                "LogisticRegression supports penalty='l2' (or None)"
            )
        if matmul_dtype not in (None, "float32", "bfloat16"):
            raise ValueError("matmul_dtype must be None/'float32'/'bfloat16'")
        if engine not in ("auto", "host", "xla"):
            raise ValueError("engine must be 'auto', 'host' or 'xla'")

    def _check_supported(self):
        _check_static(self._static_config({}))

    #: the warm C-path runner (``distribute/search.py``) may chain fits
    _host_warm_startable = True

    def _host_fit(self, X, y, sample_weight=None):
        """The f64 host engine on this objective
        (:func:`~skdist_tpu_torch.models.host_linear.logreg_host_fit`);
        ``penalty=None`` is C = inf, scikit-learn's convention."""
        from .host_linear import logreg_host_fit

        _check_static(self._static_config({}))
        C = (np.inf if self.penalty in (None, "none")
             else hyper_float(self.C))
        return self._run_host_engine(logreg_host_fit, C, X, y, sample_weight)

    @classmethod
    def _linear_op(cls, X, static):
        """The fit problems' operator, with ``matmul_dtype``'s precision."""
        st = dict(static)
        return LinearOperator(X, st["fit_intercept"],
                              matmul_dtype=st.get("matmul_dtype"))

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """Device bytes one task of a batched fit holds at its peak: the
        L-BFGS state (history ring plus working vectors) over its flat
        weights, and the per-row loss and scoring intermediates."""
        st = dict(static)
        k = meta["n_classes"]
        k_out = 1 if k <= 2 else k
        p = meta["n_features"] + (1 if st["fit_intercept"] else 0)
        flat = p * k_out * 4
        return (2 * st["history"] + _LBFGS_WORK_VECTORS) * flat \
            + 10 * n * max(k, 2) * 4

    @classmethod
    def _build_fit_problem(cls, meta, static):
        st = dict(static)
        _check_static(st)
        k = meta["n_classes"]
        fit_intercept = st["fit_intercept"]
        class_weight, cw_arr = st["class_weight"], meta.get("cw_arr")
        binary = k <= 2
        unpenalized = st.get("penalty", "l2") in (None, "none")
        d = meta["n_features"]

        def problem(op, y_idx, sw, hyper, parts=False):
            # ``parts=True`` adds the data term and the regulariser as
            # closures of their own: the streamed fit sums the data term
            # over blocks (it is row-additive) and adds the regulariser
            # once; ``loss`` is their sum, as it always was
            C = hyper["C"]
            T = sw.shape[0]
            p = op.p
            sw = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if binary:
                ypm = (y_idx == (k - 1)).to(op.dtype)  # {0,1}

                def data_loss(w):
                    z = op.matvec(w[:, :, None])[..., 0]  # (T, n)
                    return lane_sum(
                        sw * (torch.logaddexp(z, torch.zeros_like(z))
                              - ypm * z))

                def reg_loss(w):
                    if unpenalized:
                        return torch.zeros_like(w[:, 0])
                    wd = w[:, :d]
                    return 0.5 / C * lane_sum(wd * wd)

                w0 = torch.zeros((T, p), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w, "n_iter": n_iter}
            else:
                onehot = F.one_hot(y_idx.long(), k).to(op.dtype)

                def data_loss(wflat):
                    logits = op.matvec(wflat.reshape(T, p, k))  # (T, n, k)
                    lse = torch.logsumexp(logits, dim=2)
                    return lane_sum(
                        sw * (lse - torch.sum(onehot * logits, dim=2)))

                def reg_loss(wflat):
                    if unpenalized:
                        return torch.zeros_like(wflat[:, 0])
                    Wd = wflat.reshape(T, p, k)[:, :d]
                    return 0.5 / C * lane_sum(Wd * Wd)

                w0 = torch.zeros((T, p * k), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w.reshape(T, p, k), "n_iter": n_iter}

            def loss(w):
                ce = data_loss(w)
                if unpenalized:
                    return ce
                return ce + reg_loss(w)

            if parts:
                return loss, w0, unpack, data_loss, reg_loss
            return loss, w0, unpack

        return problem

def _check_static(st):
    """Reject invalid ``LogisticRegression`` settings (also those set
    through ``set_params``, which bypasses ``__init__``)."""
    if st.get("penalty", "l2") not in ("l2", None, "none"):
        raise ValueError("LogisticRegression supports penalty='l2' (or None)")
    if st.get("matmul_dtype") not in (None, "float32", "bfloat16"):
        raise ValueError("matmul_dtype must be None/'float32'/'bfloat16'")
    if st.get("engine", "auto") not in ("auto", "host", "xla"):
        raise ValueError("engine must be 'auto', 'host' or 'xla'")


# --------------------------------------------------------------------------
# LinearSVC (squared hinge, primal, batched L-BFGS)
# --------------------------------------------------------------------------

class LinearSVC(_LbfgsFitMixin, _LinearClassifierBase):
    """L2-regularised squared-hinge linear SVM, primal, by batched L-BFGS:
    ``0.5 * ||w||^2 + C * sum_i s_i * max(0, 1 - y_i z_i)^2`` with ``y``
    in {-1, +1}, the intercept unpenalised. Multiclass is one-vs-all
    with every class column solved jointly as one flattened ``(p, k)``
    problem (the column objectives are separable, so the joint minimiser
    is the per-class one). The JAX package's constructor arguments and
    defaults (``max_iter=1000``), plus ``device`` (the card unless
    ``"cpu"``). ``C`` and ``tol`` ride the task axis; ``engine`` chooses
    the engine as ``LogisticRegression``'s does (the f64 host engine
    under ``'host'``, and under ``'auto'`` where ``device="cpu"``). Over
    packed X the loss runs K1 forward and K2 backward, like
    ``LogisticRegression``'s."""

    _hyper_names = ("C", "tol")
    _static_names = (
        "max_iter", "fit_intercept", "class_weight", "history", "engine",
        "loss",
    )

    #: the binary fit takes one label vector a lane (one-vs-rest/-one)
    _lane_labels = True

    def __init__(self, C=1.0, tol=1e-4, max_iter=1000, fit_intercept=True,
                 class_weight=None, loss="squared_hinge", random_state=None,
                 history=10, engine="auto", device=None):
        self.C = C
        self.tol = tol
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        self.class_weight = class_weight
        self.loss = loss
        self.random_state = random_state
        self.history = history
        self.engine = engine
        self.device = device
        if loss != "squared_hinge":
            raise ValueError("LinearSVC supports loss='squared_hinge'")
        if engine not in ("auto", "host", "xla"):
            raise ValueError("engine must be 'auto', 'host' or 'xla'")

    def _check_supported(self):
        _check_svc_static(self._static_config({}))

    #: the warm C-path runner (``distribute/search.py``) may chain fits
    _host_warm_startable = True

    def _host_fit(self, X, y, sample_weight=None):
        """The f64 host engine on this squared-hinge objective
        (:func:`~skdist_tpu_torch.models.host_linear.svc_host_fit`)."""
        from .host_linear import svc_host_fit

        _check_svc_static(self._static_config({}))
        return self._run_host_engine(svc_host_fit, hyper_float(self.C), X, y,
                                     sample_weight)

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """Device bytes one task of a batched fit holds at its peak: the
        L-BFGS state over its flat weights, and the per-row margins, loss
        and gradient terms and scoring intermediates over ``(n, k)``."""
        st = dict(static)
        k = meta["n_classes"]
        k_out = 1 if k <= 2 else k
        p = meta["n_features"] + (1 if st["fit_intercept"] else 0)
        return (2 * st["history"] + _LBFGS_WORK_VECTORS) * p * k_out * 4 \
            + 10 * n * max(k, 2) * 4

    @classmethod
    def _build_fit_problem(cls, meta, static):
        st = dict(static)
        _check_svc_static(st)
        k = meta["n_classes"]
        d = meta["n_features"]
        class_weight, cw_arr = st["class_weight"], meta.get("cw_arr")

        def problem(op, y_idx, sw, hyper, parts=False):
            # ``parts=True``: the data term and the regulariser apart, as
            # in LogisticRegression's problem
            C = hyper["C"]
            T = sw.shape[0]
            p = op.p
            sw = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if k <= 2:
                ypm = torch.where(y_idx == (k - 1), 1.0, -1.0).to(op.dtype)

                def data_loss(w):
                    z = op.matvec(w[:, :, None])[..., 0]  # (T, n)
                    margin = torch.clamp(1.0 - ypm * z, min=0.0)
                    return C * lane_sum(sw * (margin * margin))

                def reg_loss(w):
                    wd = w[:, :d]
                    return 0.5 * lane_sum(wd * wd)

                w0 = torch.zeros((T, p), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w, "n_iter": n_iter}
            else:
                Ypm = torch.where(F.one_hot(y_idx.long(), k) > 0, 1.0,
                                  -1.0).to(op.dtype)

                def data_loss(wflat):
                    margins = torch.clamp(
                        1.0 - Ypm * op.matvec(wflat.reshape(T, p, k)),
                        min=0.0)
                    return C * lane_sum(sw[..., None] * (margins * margins))

                def reg_loss(wflat):
                    Wd = wflat.reshape(T, p, k)[:, :d]
                    return 0.5 * lane_sum(Wd * Wd)

                w0 = torch.zeros((T, p * k), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w.reshape(T, p, k), "n_iter": n_iter}

            def loss(w):
                data = data_loss(w)
                return reg_loss(w) + data

            if parts:
                return loss, w0, unpack, data_loss, reg_loss
            return loss, w0, unpack

        return problem


def _check_svc_static(st):
    """Reject invalid ``LinearSVC`` settings (also those set through
    ``set_params``)."""
    if st.get("loss", "squared_hinge") != "squared_hinge":
        raise ValueError("LinearSVC supports loss='squared_hinge'")
    if st.get("engine", "auto") not in ("auto", "host", "xla"):
        raise ValueError("engine must be 'auto', 'host' or 'xla'")


# --------------------------------------------------------------------------
# SGDClassifier (mini-batch SGD, epoch-sliced)
# --------------------------------------------------------------------------

#: float32 vectors of a dataset's length one SGD lane holds at its peak,
#: beside its scoring pass: the fold-masked and class-weighted fit weights,
#: the epoch's gathered weights, and its own row order (int64, two) when
#: lanes read different epochs
_SGD_ROW_VECTORS = 5

#: how the losses' derivative in z and their value read, per element, with
#: the targets ``ypm`` in {-1, +1}
_SGD_LOSSES = {
    "hinge": (
        lambda z, ypm: torch.where(ypm * z < 1.0, -ypm, 0.0),
        lambda z, ypm: torch.clamp(1.0 - ypm * z, min=0.0),
    ),
    "log_loss": (
        lambda z, ypm: -ypm * torch.sigmoid(-ypm * z),
        lambda z, ypm: F.softplus(-ypm * z),
    ),
    "squared_hinge": (
        lambda z, ypm: torch.where(ypm * z < 1.0,
                                   -2.0 * ypm * (1.0 - ypm * z), 0.0),
        lambda z, ypm: torch.clamp(1.0 - ypm * z, min=0.0) ** 2,
    ),
}


class SGDClassifier(_ProbaMixin, _LinearClassifierBase):
    """Mini-batch SGD linear classifier (hinge, log_loss, squared_hinge):
    the JAX package's fixed-shape redesign of sklearn's sample-at-a-time
    SGD, with its constructor arguments and defaults plus ``device`` (the
    card unless ``"cpu"``).

    ``alpha``, ``eta0``, ``l1_ratio`` and ``tol`` ride the task axis, so
    a randomized search over them runs as one batch of lanes. Each epoch
    visits ``ceil(n / batch_size)`` batches of ``batch_size`` rows (the
    last wraps around to the first rows); a step is the weighted mean
    gradient of its batch (a fold's held-out rows weigh 0 and keep their
    slots; the mean divides by the batch's live weight, at least
    1e-12), plus ``alpha * (1 - l1_ratio)`` (``alpha`` for ``"l2"``)
    times the coefficients, at the schedule's rate:

    - ``"optimal"``: ``1 / (1 + alpha * batch_size * (t + 1))`` after t
      steps, in float32 from the integer step count;
    - ``"invscaling"``: ``eta0 / sqrt(t + 1)``; otherwise ``eta0``.

    L1 and elastic-net apply the truncated-gradient cumulative penalty
    after each step (exact zeros stay zero). Early stopping follows the
    JAX package: the epoch's mean batch loss, each read *after* its
    batch's update, must beat ``best - tol`` within ``n_iter_no_change``
    epochs or the lane stops; ``tol=None`` runs every epoch. ``n_iter_``
    is the epochs run. The rows' order is drawn from the port's counter
    hash (``utils/draws.py epoch_permutation``), not ``jax.random``, so
    shuffled fits agree with the JAX package's statistically; with
    ``shuffle=False`` (or the JAX permutation injected there) they agree
    to float32 rounding. ``predict_proba`` (``loss="log_loss"`` only) is
    the sigmoid, or for k > 2 classes the softmax of the k one-vs-all
    decisions, as in the JAX package. Over packed sparse X a step's
    products run K1 and K2 in per-lane row form on the lanes' gathered
    rows (``LinearOperator.row_batch``), and its gradient is a dense
    ``(p, k)`` plane a lane, as in the JAX package.
    """

    #: out of core: epochs as block streams (ROADMAP Queue 1 item 9b,
    #: not ported yet)
    _stream_fit_kind = "sgd"

    _hyper_names = ("alpha", "eta0", "l1_ratio", "tol")
    _static_names = (
        "max_iter", "fit_intercept", "class_weight", "loss", "penalty",
        "learning_rate", "batch_size", "random_state",
        "n_iter_no_change", "shuffle",
    )

    #: the scheduler gates' marker (``parallel.iterative_fit_supported``)
    _supports_sliced_fit = True

    #: rounds the compacted path aims at: one. A step's cost is its
    #: ~20 launches whatever the lanes, so the fewest rounds take the
    #: least time
    _compacted_rounds = 1

    #: the binary fit takes one label vector a lane (one-vs-rest/-one)
    _lane_labels = True

    def __init__(self, loss="hinge", penalty="l2", alpha=1e-4, l1_ratio=0.15,
                 max_iter=20, tol=1e-3, fit_intercept=True, eta0=0.01,
                 learning_rate="optimal", class_weight=None, random_state=0,
                 batch_size=64, n_iter_no_change=5, shuffle=True,
                 device=None):
        self.loss = loss
        self.penalty = penalty
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.eta0 = eta0
        self.learning_rate = learning_rate
        self.class_weight = class_weight
        self.random_state = random_state
        self.batch_size = batch_size
        self.n_iter_no_change = n_iter_no_change
        self.shuffle = shuffle
        self.device = device

    def _check_supported(self):
        _check_sgd_static(self._static_config({}))

    @classmethod
    def _flat_w_width(cls, meta, static):
        st = dict(static)
        p = meta["n_features"] + (1 if st["fit_intercept"] else 0)
        k = meta.get("n_classes", 2)
        return p if k <= 2 else p * k

    @classmethod
    def _batched_task_cost(cls, hyper):
        """Per-task cost heuristic for ordering the task axis: weak
        regularisation (small ``alpha``) and a tight ``tol`` both mean
        more epochs before the no-improvement rule fires; ``tol <= 0``
        (``tol=None``) never stops early and sorts last."""
        alpha = np.asarray(hyper.get("alpha", 1e-4), dtype=np.float64)
        tol = np.asarray(hyper.get("tol", 1e-3), dtype=np.float64)
        cost = -np.log(np.maximum(alpha, 1e-30)) - np.where(
            tol > 0, np.log(np.where(tol > 0, tol, 1.0)), -np.inf
        )
        return np.broadcast_to(
            cost, np.broadcast_shapes(alpha.shape, tol.shape))

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """Device bytes one lane of a round holds at its peak: its
        dataset-length weight and order vectors, its flat weights and
        penalty state, the ``(batch, k)`` step temporaries, its gathered
        rows (dense: ``(batch, p)``; packed: the ``(batch, m)`` int32
        and float32 pair, and the dense ``(p, k)`` gradient plane that
        the row rmatvec returns, beside its scaled and decayed copies),
        and the ``(n, k)`` scoring pass."""
        st = dict(static)
        k = meta["n_classes"]
        p = meta["n_features"] + (1 if st["fit_intercept"] else 0)
        bs = int(st["batch_size"])
        flat = cls._flat_w_width(meta, static) * 4
        if meta.get("x_format") == "packed":
            m = meta["packed_m"] + (1 if st["fit_intercept"] else 0)
            rows = bs * m * 8 + 3 * flat
        else:
            rows = bs * p * 4
        return (_SGD_ROW_VECTORS * n * 4 + 8 * flat + rows
                + bs * 8 * max(k, 2) * 4 + 10 * n * max(k, 2) * 4)

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """Device bytes a round holds once: an epoch's row order and the
        hash keys and sort it is drawn from (int64 over the padded
        rows), and on packed X the one gathered ``(batch, m)`` pair that
        lanes reading one epoch share."""
        st = dict(static)
        bs = int(st["batch_size"])
        shared = 0
        if meta.get("x_format") == "packed":
            m = meta["packed_m"] + (1 if st["fit_intercept"] else 0)
            shared = bs * m * 8
        return 4 * (-(-n // bs) * bs) * 8 + shared

    @classmethod
    def _build_fit_problem(cls, meta, static):
        """The SGD problem of a lane batch, built once per ``(meta,
        static)``: ``problem(op, y_idx, sw, hyper)`` returns the dict
        :func:`~skdist_tpu_torch.models.solvers.sgd_resume` reads (the
        batches, gradient, loss, schedule and post-step of the lanes),
        with ``W0`` and ``unpack``; the plain and the epoch-sliced
        kernels consume the same one."""
        st = dict(static)
        _check_sgd_static(st)
        k = meta["n_classes"]
        d = meta["n_features"]
        fit_intercept = st["fit_intercept"]
        penalty = st["penalty"]
        lr_kind = st["learning_rate"]
        bs = int(st["batch_size"])
        class_weight, cw_arr = st["class_weight"], meta.get("cw_arr")
        n_out = 1 if k <= 2 else k
        dloss, ploss = _SGD_LOSSES[st["loss"]]

        def problem(op, y_idx, sw, hyper):
            alpha, eta0, l1_ratio = (hyper["alpha"], hyper["eta0"],
                                     hyper["l1_ratio"])
            T, p, n = sw.shape[0], op.p, op.n
            n_batches = -(-n // bs)
            sw_full = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if n_out == 1:
                Ypm = torch.where(y_idx == (k - 1), 1.0, -1.0)[..., None]
            else:
                Ypm = torch.where(F.one_hot(y_idx.long(), k) > 0, 1.0, -1.0)
            Ypm = Ypm.to(op.dtype)
            # one label vector a lane (y_idx (T, n)): each lane reads its own
            lanes = (torch.arange(T, device=sw.device)[:, None]
                     if Ypm.ndim == 3 else None)

            def batches(rows):
                # the epoch's gathered weights and each batch's live
                # weight (a sum over one contiguous 64-float row)
                rows = rows.reshape(T, n_batches, bs)
                wts = sw_full.gather(1, rows.reshape(T, -1)).view(
                    T, n_batches, bs)
                denom = torch.clamp(wts.sum(2), min=1e-12)

                def batch(b):
                    idx = rows[:, b]
                    yb = Ypm[idx] if lanes is None else Ypm[lanes, idx]
                    return op.row_batch(idx), yb, wts[:, b], denom[:, b]

                return n_batches, batch

            def loss_fn(wflat, xb):
                # weighted mean DATA loss of one batch (penalty
                # excluded, as sklearn's no-validation early stopping
                # tracks it); multiclass sums its k binary columns
                rows, yb, wb, denom = xb
                z = op.row_matvec(rows, wflat.view(T, p, n_out))
                per = ploss(z, yb).sum(2) * wb
                return per.sum(1) / denom

            if penalty in ("l2", "elasticnet"):
                l2 = alpha * (1.0 if penalty == "l2" else 1.0 - l1_ratio)
            else:
                l2 = None

            def grad_fn(wflat, xb):
                rows, yb, wb, denom = xb
                W = wflat.view(T, p, n_out)
                g_z = dloss(op.row_matvec(rows, W), yb) * wb[:, :, None]
                g = op.row_rmatvec(rows, g_z) / denom[:, None, None]
                if l2 is not None:
                    g[:, :d] += l2[:, None, None] * W[:, :d]
                return g.view(T, -1)

            if lr_kind == "optimal":
                # the JAX package's batch-adapted Bottou schedule: the
                # step starts near 1 and decays in sample time
                rate = alpha * bs

                def lr_fn(t):
                    return 1.0 / (1.0 + rate[:, None] * (t + 1.0))
            elif lr_kind == "invscaling":
                def lr_fn(t):
                    return eta0[:, None] / (t + 1.0) ** 0.5
            else:  # constant
                def lr_fn(t):
                    return eta0[:, None] * torch.ones_like(t, dtype=op.dtype)

            post_step = None
            if penalty in ("l1", "elasticnet"):
                l1_mul = 1.0 if penalty == "l1" else l1_ratio

                def post_step(wflat, state, lr):
                    # truncated-gradient L1 (Tsuruoka et al.'s cumulative
                    # penalty): u is the penalty rate accrued, q what each
                    # weight has absorbed; weights are clipped toward zero
                    # by the deficit, and exact zeros stay put (the
                    # intercept row is not penalised)
                    u, q = state
                    u = u + lr * alpha * l1_mul
                    W = wflat.view(T, p, n_out)
                    Q = q.view(T, p, n_out).clone()
                    z, uu, qd = W[:, :d], u[:, None, None], Q[:, :d]
                    w_trunc = torch.where(
                        z > 0, torch.clamp(z - (uu + qd), min=0.0),
                        torch.where(z < 0,
                                    torch.clamp(z + (uu - qd), max=0.0), z))
                    qd += w_trunc - z
                    z.copy_(w_trunc)
                    return wflat, (u, Q.view(T, -1))

            def unpack(w, n_epochs):
                W = w.view(T, p, n_out)
                return {"W": W[..., 0] if n_out == 1 else W,
                        "n_iter": n_epochs}

            return {
                "n": n, "batches": batches, "grad_fn": grad_fn,
                "loss_fn": loss_fn, "lr_fn": lr_fn, "post_step": post_step,
                "W0": torch.zeros((T, p * n_out), dtype=op.dtype,
                                  device=sw.device),
                "unpack": unpack,
            }

        return problem

    @classmethod
    def _solve_args(cls, static):
        st = dict(static)
        return dict(max_epochs=st["max_iter"], batch_size=int(st["batch_size"]),
                    seed=st["random_state"] or 0,
                    shuffle=bool(st["shuffle"]),
                    n_iter_no_change=int(st["n_iter_no_change"]))

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        problem = cls._build_fit_problem(meta, static)
        args = cls._solve_args(static)

        def kernel(op, y_idx, sw, hyper, w0=None):
            pb = problem(op, y_idx, sw, hyper)
            # a warm start begins at the caller's seed (flat layout)
            start = (pb["W0"] if w0 is None
                     else w0.to(pb["W0"]).expand_as(pb["W0"]).clone())
            w, n_epochs = sgd_minimize(pb, start, hyper["tol"], **args)
            return pb["unpack"](w, n_epochs)

        return kernel

    @classmethod
    def _build_fit_slice_kernels(cls, meta, static, n_slice):
        """The epoch-sliced fit (slice unit: one epoch), each kernel over
        a batch of ``T`` lanes ``(op, y_idx, sw, hyper, ...)`` as the
        plain kernel; the same contract as
        :meth:`_LbfgsFitMixin._build_fit_slice_kernels`. ``init`` runs no
        epoch, so a lane started by ``restart`` runs exactly the epochs
        of one started by ``init``; chained ``step`` calls are bitwise
        the unsliced solve. ``converged`` means the lane stopped by
        ``tol`` before ``max_iter`` epochs, and the scheduler counts a
        lane's epochs in ``n_done`` (``iter_key``): the epoch clock
        ``it`` runs on in frozen lanes."""
        problem = cls._build_fit_problem(meta, static)
        args = cls._solve_args(static)
        max_iter = args["max_epochs"]
        n_slice = int(n_slice)

        def init(op, y_idx, sw, hyper):
            return sgd_carry_init(problem(op, y_idx, sw, hyper)["W0"])

        def restart(op, y_idx, sw, hyper, carry, slots):
            w0 = problem(op, y_idx, sw, hyper)["W0"]
            return sgd_carry_restart(carry, slots, w0.index_select(0, slots))

        def step(op, y_idx, sw, hyper, carry):
            pb = problem(op, y_idx, sw, hyper)
            return sgd_resume(pb, carry, n_slice, hyper["tol"], **args)

        def finalize(op, y_idx, sw, hyper, carry):
            pb = problem(op, y_idx, sw, hyper)
            return pb["unpack"](carry_iterate(carry), carry["n_done"])

        def converged(op, y_idx, sw, hyper, carry):
            return carry["n_done"] < max_iter

        return {
            "init": init, "restart": restart, "step": step,
            "finalize": finalize, "finalize_keys": ("w", "n_done"),
            "score_params": finalize, "converged": converged,
            "max_iter": max_iter, "iter_key": "n_done",
        }

    @property
    def predict_proba(self):
        """Probabilities, with ``loss="log_loss"`` only: for another loss
        the attribute does not exist (``hasattr`` is False, as with
        scikit-learn's SGD), so a meta-estimator ranks by the decision."""
        if self.loss != "log_loss":
            raise AttributeError(
                "predict_proba is only available with loss='log_loss'")
        return super().predict_proba


def _check_sgd_static(st):
    """Reject invalid SGD settings (also those set through
    ``set_params``)."""
    if st.get("loss", "hinge") not in _SGD_LOSSES:
        raise ValueError(f"unsupported loss {st.get('loss')!r}")
    if int(st.get("n_iter_no_change", 5)) < 1:
        # sklearn raises for this too; freezing after the first epoch
        # would under-train the model
        raise ValueError(
            "n_iter_no_change must be >= 1; got "
            f"{st.get('n_iter_no_change')}")


# --------------------------------------------------------------------------
# the ridge family (closed form: one Cholesky solve per task)
# --------------------------------------------------------------------------

class _RidgeKernelMixin:
    """The closed-form solve shared by ``Ridge``, ``LinearRegression``
    and ``RidgeClassifier``, and what a round of them holds."""

    #: out of core: block-accumulated normal equations (ROADMAP Queue 1
    #: item 9b, not ported yet)
    _stream_fit_kind = "gram"

    @staticmethod
    def _solve(op, T, sw, alpha, d):
        """Weighted ridge for a lane batch: solve ``(X~.T S X~ + alpha
        I0 + 1e-8 I) W = (S X~).T T`` for each lane of ``sw (L, n)`` and
        ``alpha (L,)``; ``I0`` has a zero at the intercept, which stays
        unpenalised, and the jitter keeps a singular gram (alpha = 0)
        solvable. Returns ``W (L, p, k)``.

        The lanes' grams come from one call (K3 on packed X); the
        regulariser is added in place, in the JAX package's order. Each
        lane is then factored and solved on its own, so a round holds
        one lane's Cholesky factor (and the copy ``cholesky_solve``
        takes) beside the grams, not one per lane. A lane whose
        factorisation fails (``info > 0``: not positive definite in
        float32) gets NaN weights, as ``jax.scipy.linalg.solve(...,
        assume_a="pos")`` gives, and the search maps its scores to
        ``error_score``; nothing raises."""
        G, b = op.weighted_gram_rhs(sw, T)  # (L, p, p), (L, p, k)
        diag = torch.diagonal(G, dim1=-2, dim2=-1)
        diag[:, :d] += alpha[:, None].to(G.dtype)
        diag += 1e-8
        W = torch.empty_like(b)
        for t in range(G.shape[0]):
            factor, info = torch.linalg.cholesky_ex(G[t])
            W[t] = torch.where(info > 0, float("nan"),
                               torch.cholesky_solve(b[t], factor))
            del factor
        return W

    @classmethod
    def _linear_op(cls, X, static):
        """The operator, with K3's pair table built up front on the
        card, so the round sizer sees its memory as taken."""
        op = super()._linear_op(X, static)
        op.gram_pairs()
        return op

    @classmethod
    def _n_outputs(cls, meta):
        return meta.get("n_targets", 1)

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """Device bytes one lane of a round holds at its peak: its
        ``(p, p)`` gram, the right-hand side, solution and solve
        temporaries over ``(p, k)``, the weighted targets, decision and
        K1 temporaries over ``(n, k)``, the scoring intermediates, and on
        dense X the weighted copy ``Xw`` (billed twice: the batched
        gram product may expand ``Xa.T`` to the lane batch)."""
        p = meta["n_features"] + (1 if dict(static)["fit_intercept"] else 0)
        k = cls._n_outputs(meta)
        per = p * p * 4 + 3 * p * k * 4 + 4 * n * k * 4 \
            + 10 * n * max(k, 2) * 4
        if meta.get("x_format") == "dense":
            per += 2 * n * p * 4
        return per

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """Device bytes a round holds once: the Cholesky factor of the
        lane being solved and the copy of it ``cholesky_solve`` takes."""
        p = meta["n_features"] + (1 if dict(static)["fit_intercept"] else 0)
        return 2 * p * p * 4


class Ridge(_RidgeKernelMixin, _LinearModelBase, RegressorMixin):
    """Closed-form weighted ridge regression. ``alpha`` rides the task
    axis, so a CV sweep over alphas x folds is one batched solve a
    round. The JAX package's constructor arguments, plus ``device`` (the
    card unless ``"cpu"``)."""

    _hyper_names = ("alpha",)
    _static_names = ("fit_intercept",)

    def __init__(self, alpha=1.0, fit_intercept=True, device=None):
        self.alpha = alpha
        self.fit_intercept = fit_intercept
        self.device = device

    def _prep_fit_data(self, X, y, sample_weight=None):
        y = np.asarray(y, dtype=np.float32)
        if y.ndim not in (1, 2) or y.shape[0] != X.shape[0]:
            raise ValueError(
                f"y of shape {y.shape} does not fit {X.shape[0]} samples"
            )
        sw = prepare_sample_weight(sample_weight, X.shape[0])
        meta = {
            "n_features": X.shape[1],
            "y_ndim": y.ndim,
            "n_targets": 1 if y.ndim == 1 else y.shape[1],
            "x_format": "packed" if isinstance(X, PackedX) else "dense",
        }
        return {"X": X, "y": y, "sw": sw}, meta

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        d = meta["n_features"]
        one_column = meta.get("y_ndim", 1) == 1

        def kernel(op, y, sw, hyper, w0=None):
            # a warm seed is accepted and ignored: a direct solve has no
            # iterate to start from
            T = y.reshape(y.shape[0], -1).to(op.dtype)
            alpha = hyper.get("alpha")
            if alpha is None:  # LinearRegression: no alpha on the task axis
                alpha = torch.zeros(sw.shape[0], dtype=sw.dtype,
                                    device=sw.device)
            W = cls._solve(op, T, sw, alpha, d)
            return {"W": W[..., 0] if one_column else W}

        return kernel

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        return _linear_decision(meta["n_features"],
                                dict(static)["fit_intercept"],
                                meta.get("y_ndim", 1) == 1)

    def predict(self, X):
        if is_chunked(X):
            return self._predict_chunked(X, "predict")
        return self.decision_function(X)


class LinearRegression(Ridge):
    """Ordinary least squares as ridge with ``alpha=0`` (the ``1e-8``
    jitter keeps a rank-deficient gram solvable)."""

    _hyper_names = ()

    def __init__(self, fit_intercept=True, device=None):
        self.fit_intercept = fit_intercept
        self.device = device
        self.alpha = 0.0


class RidgeClassifier(_RidgeKernelMixin, _LinearClassifierBase):
    """Ridge on +-1 targets (one column when there are at most two
    classes, else one a class); predicts by the sign or the argmax of
    the decision. ``class_weight`` scales the sample weights, as in
    ``LogisticRegression``."""

    _hyper_names = ("alpha",)
    _static_names = ("fit_intercept", "class_weight")

    #: the binary fit takes one label vector a lane (one-vs-rest/-one)
    _lane_labels = True

    def __init__(self, alpha=1.0, fit_intercept=True, class_weight=None,
                 device=None):
        self.alpha = alpha
        self.fit_intercept = fit_intercept
        self.class_weight = class_weight
        self.device = device

    @classmethod
    def _n_outputs(cls, meta):
        k = meta["n_classes"]
        return 1 if k <= 2 else k

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        st = dict(static)
        class_weight, cw_arr = st["class_weight"], meta.get("cw_arr")
        d = meta["n_features"]
        k = meta["n_classes"]

        def kernel(op, y_idx, sw, hyper, w0=None):
            # a warm seed is accepted and ignored (the direct solve)
            sw = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if k <= 2:
                T = torch.where(y_idx == (k - 1), 1.0, -1.0)[..., None]
            else:
                T = torch.where(F.one_hot(y_idx.long(), k) > 0, 1.0, -1.0)
            W = cls._solve(op, T.to(op.dtype), sw, hyper["alpha"], d)
            return {"W": W[..., 0] if k <= 2 else W}

        return kernel
