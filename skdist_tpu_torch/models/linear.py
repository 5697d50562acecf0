"""
Linear estimator kernels of the port: logistic regression.

Counterpart of ``skdist_tpu/models/linear.py``. The estimator is built
around batched fit kernels: ``_build_fit_kernel(meta, static)`` returns
``kernel(op, y_idx, sw, hyper)`` that fits ``T`` tasks at once, where
``sw`` is ``(T, n)`` (fold masks times sample weights) and each
``hyper`` value is a ``(T,)`` tensor. The distributed search stacks its
(candidate x fold) tasks on that axis; a single ``fit`` is a batch of
one. Folds are selected by sample-weight masking, never by slicing rows.

The objective is the JAX package's (and sklearn's):
``sum_i s_i * ce_i + 0.5 / C * ||w||^2``, intercept unpenalised. The
multinomial weights are a flat ``p * k`` vector reshaped row-major to
``(p, k)``, the JAX package's layout, so ``coef_`` and
:mod:`skdist_tpu_torch.convert` line up with it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import BaseEstimator, ClassifierMixin
from ..sparse import (
    LinearOperator,
    PackedX,
    matvec_any,
    pack_for_fit,
    sparse_to_dense_f32,
)
from ..utils.device import exact_matmuls, resolve_device
from .solvers import lbfgs_minimize

__all__ = ["LogisticRegression"]

_ROADMAP = "see ROADMAP.md, queue 1"

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
    each task: sklearn's n / (k * count_c)."""
    if class_weight is None:
        return sw
    y_long = y_idx.long()
    if class_weight == "balanced":
        onehot = F.one_hot(y_long, n_classes).to(sw.dtype)
        counts = sw @ onehot  # (..., k)
        total = torch.sum(sw, dim=-1, keepdim=True)
        per_class = total / (n_classes * torch.clamp(counts, min=1e-12))
        per_class = torch.where(counts > 0, per_class, 0.0)
    else:
        per_class = torch.as_tensor(cw_arr, dtype=sw.dtype, device=sw.device)
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
    - ``_build_fit_kernel(meta, static)`` -> batched fit kernel
    - ``_build_decision_kernel(meta, static)`` -> (W, X) -> raw scores
    """

    _hyper_names = ()
    _static_names = ()
    _supports_packed_X = True

    def fit(self, X, y, sample_weight=None):
        """Fit on ``device`` (the card unless ``device="cpu"``)."""
        device = resolve_device(self.device)
        self._check_supported()
        X = prepare_fit_X(X, type(self))
        data, meta = self._prep_fit_data(X, y, sample_weight)
        static = _freeze(self._static_config(meta))
        kernel = self._build_fit_kernel(meta, static)
        hyper = {
            k: torch.tensor([hyper_float(getattr(self, k))], device=device)
            for k in self._hyper_names
        }
        with exact_matmuls():
            op = self._linear_op(to_device_X(data["X"], device), static)
            params = kernel(
                op,
                torch.as_tensor(data["y"]).to(device),
                torch.as_tensor(data["sw"]).to(device)[None],
                hyper,
            )
        self._set_fitted(
            {k: v[0].detach().cpu().numpy() for k, v in params.items()}, meta
        )
        return self

    def _check_supported(self):
        """Raise for the options whose engines are not ported yet."""

    @classmethod
    def _linear_op(cls, X, static):
        """The fit problems' matvec interface over device ``X``."""
        return LinearOperator(X, dict(static)["fit_intercept"])

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
        W = torch.as_tensor(
            np.array(self._params["W"], dtype=np.float32)).to(device)
        with exact_matmuls(), torch.no_grad():
            out = kernel(W, to_device_X(X, device))
        return out.cpu().numpy()

    def decision_function(self, X):
        return self._device_outputs(X, "decision")

    @property
    def coef_(self):
        self._check_fitted()
        W = np.asarray(self._params["W"])  # (d[+1], k) or (d[+1],)
        w = W[: self.n_features_in_]
        if w.ndim == 1:
            return w.reshape(1, -1)
        return w.T

    @property
    def intercept_(self):
        self._check_fitted()
        W = np.asarray(self._params["W"])
        if not self.fit_intercept:
            k = 1 if W.ndim == 1 else W.shape[1]
            return np.zeros(k, dtype=W.dtype)
        return np.atleast_1d(W[self.n_features_in_])


class _LinearClassifierBase(_LinearModelBase, ClassifierMixin):
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
        return {"X": X, "y": y_idx, "sw": sw}, meta

    def predict(self, X):
        scores = self.decision_function(X)
        if scores.ndim == 1:
            idx = (scores > 0).astype(np.int64)
        else:
            idx = np.argmax(scores, axis=1)
        return self.classes_[idx]


# --------------------------------------------------------------------------
# LogisticRegression
# --------------------------------------------------------------------------

class LogisticRegression(_LinearClassifierBase):
    """L2 multinomial / binary logistic regression via batched L-BFGS.

    The JAX package's constructor arguments, plus ``device`` (the card
    unless ``"cpu"``). ``C`` and ``tol`` ride the task axis of a grid;
    the others shape the kernel. ``engine`` is accepted for parity with
    the JAX package: ``'auto'`` and ``'xla'`` both run this engine,
    ``'host'`` (the f64 host engine) raises ``NotImplementedError``, as
    does ``matmul_dtype='bfloat16'``; both are in ROADMAP.md.
    """

    _hyper_names = ("C", "tol")
    _static_names = (
        "max_iter", "fit_intercept", "class_weight", "history",
        "matmul_dtype", "engine", "penalty",
    )

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

        def problem(op, y_idx, sw, hyper):
            C = hyper["C"]
            T = sw.shape[0]
            p = op.p
            sw = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if binary:
                ypm = (y_idx == (k - 1)).to(op.dtype)  # {0,1}

                def loss(w):
                    z = op.matvec(w[:, :, None])[..., 0]  # (T, n)
                    ce = torch.sum(
                        sw * (torch.logaddexp(z, torch.zeros_like(z))
                              - ypm * z),
                        dim=1,
                    )
                    if unpenalized:
                        return ce
                    wd = w[:, :d]
                    return ce + 0.5 / C * torch.sum(wd * wd, dim=1)

                w0 = torch.zeros((T, p), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w, "n_iter": n_iter}

                return loss, w0, unpack

            onehot = F.one_hot(y_idx.long(), k).to(op.dtype)

            def loss(wflat):
                W = wflat.reshape(T, p, k)
                logits = op.matvec(W)  # (T, n, k)
                lse = torch.logsumexp(logits, dim=2)
                ce = torch.sum(
                    sw * (lse - torch.sum(onehot * logits, dim=2)), dim=1
                )
                if unpenalized:
                    return ce
                Wd = W[:, :d]
                return ce + 0.5 / C * torch.sum(Wd * Wd, dim=(1, 2))

            w0 = torch.zeros((T, p * k), dtype=op.dtype, device=sw.device)

            def unpack(w, n_iter):
                return {"W": w.reshape(T, p, k), "n_iter": n_iter}

            return loss, w0, unpack

        return problem

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        problem = cls._build_fit_problem(meta, static)
        st = dict(static)
        max_iter, hist = st["max_iter"], st["history"]

        def kernel(op, y_idx, sw, hyper):
            loss, w0, unpack = problem(op, y_idx, sw, hyper)
            w, n_iter = lbfgs_minimize(loss, w0, tol=hyper["tol"],
                                       max_iter=max_iter, history=hist)
            return unpack(w.detach(), n_iter)

        return kernel

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        fit_intercept = dict(static)["fit_intercept"]
        d = meta["n_features"]
        binary = meta["n_classes"] <= 2

        def decision(W, X):
            """``W`` is one model (``(p,)`` binary, ``(p, k)``) or a task
            batch (``(T, p)``, ``(T, p, k)``); X a device tensor or
            PackedX. Returns ``(n,)``/``(n, k)`` or ``(T, n)``/
            ``(T, n, k)``."""
            batched = W.ndim == (2 if binary else 3)
            if binary and batched:
                return decision(W[:, :, None], X)[..., 0]
            w = W[..., :d, :] if W.ndim == 3 else W[:d]
            out = matvec_any(X, w)
            if not fit_intercept:
                return out
            b = W[..., d, :] if W.ndim == 3 else W[d]
            return out + (b[:, None, :] if W.ndim == 3 else b)

        return decision

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
        return self._device_outputs(X, "proba")

    def predict_log_proba(self, X):
        return np.log(np.clip(self.predict_proba(X), 1e-15, None))


def _check_static(st):
    """Reject the static settings whose engines are not ported yet (and
    invalid ones set through ``set_params``)."""
    if st.get("penalty", "l2") not in ("l2", None, "none"):
        raise ValueError("LogisticRegression supports penalty='l2' (or None)")
    md = st.get("matmul_dtype")
    if md not in (None, "float32", "bfloat16"):
        raise ValueError("matmul_dtype must be None/'float32'/'bfloat16'")
    if md == "bfloat16":
        raise NotImplementedError(
            "matmul_dtype='bfloat16' is not ported to skdist_tpu_torch yet "
            f"({_ROADMAP})"
        )
    engine = st.get("engine", "auto")
    if engine not in ("auto", "host", "xla"):
        raise ValueError("engine must be 'auto', 'host' or 'xla'")
    if engine == "host":
        raise NotImplementedError(
            "engine='host' (the f64 host engine) is not ported to "
            f"skdist_tpu_torch yet ({_ROADMAP})"
        )
