"""
Linear estimator kernels of the port: logistic regression and the ridge
family (``Ridge``, ``LinearRegression``, ``RidgeClassifier``).

Counterpart of ``skdist_tpu/models/linear.py``. The estimator is built
around batched fit kernels: ``_build_fit_kernel(meta, static)`` returns
``kernel(op, y_idx, sw, hyper)`` that fits ``T`` tasks at once, where
``sw`` is ``(T, n)`` (fold masks times sample weights) and each
``hyper`` value is a ``(T,)`` tensor. The distributed search stacks its
(candidate x fold) tasks on that axis; a single ``fit`` is a batch of
one. Folds are selected by sample-weight masking, never by slicing rows.

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
from ..sparse import (
    LinearOperator,
    PackedX,
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
)

__all__ = ["LogisticRegression", "Ridge", "LinearRegression",
           "RidgeClassifier"]

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

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """Device bytes a round holds once, whatever its task count."""
        return 0

    def _sklearn_2d_coef(self):
        """Whether a one-column model's ``coef_`` is ``(1, d)`` (a
        classifier) rather than ``(d,)``."""
        return isinstance(self, ClassifierMixin)

    @property
    def coef_(self):
        self._check_fitted()
        W = np.asarray(self._params["W"])  # (d[+1], k) or (d[+1],)
        w = W[: self.n_features_in_]
        if w.ndim == 1:
            return w.reshape(1, -1) if self._sklearn_2d_coef() else w
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

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        return _linear_decision(meta["n_features"],
                                dict(static)["fit_intercept"],
                                meta["n_classes"] <= 2)

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

        def kernel(op, y_idx, sw, hyper):
            loss, w0, unpack = problem(op, y_idx, sw, hyper)
            w, n_iter = lbfgs_minimize(loss, w0, tol=hyper["tol"],
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


class LogisticRegression(_LbfgsFitMixin, _LinearClassifierBase):
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
                    ce = lane_sum(
                        sw * (torch.logaddexp(z, torch.zeros_like(z))
                              - ypm * z))
                    if unpenalized:
                        return ce
                    wd = w[:, :d]
                    return ce + 0.5 / C * lane_sum(wd * wd)

                w0 = torch.zeros((T, p), dtype=op.dtype, device=sw.device)

                def unpack(w, n_iter):
                    return {"W": w, "n_iter": n_iter}

                return loss, w0, unpack

            onehot = F.one_hot(y_idx.long(), k).to(op.dtype)

            def loss(wflat):
                W = wflat.reshape(T, p, k)
                logits = op.matvec(W)  # (T, n, k)
                lse = torch.logsumexp(logits, dim=2)
                ce = lane_sum(sw * (lse - torch.sum(onehot * logits, dim=2)))
                if unpenalized:
                    return ce
                Wd = W[:, :d]
                return ce + 0.5 / C * lane_sum(Wd * Wd)

            w0 = torch.zeros((T, p * k), dtype=op.dtype, device=sw.device)

            def unpack(w, n_iter):
                return {"W": w.reshape(T, p, k), "n_iter": n_iter}

            return loss, w0, unpack

        return problem

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


# --------------------------------------------------------------------------
# the ridge family (closed form: one Cholesky solve per task)
# --------------------------------------------------------------------------

class _RidgeKernelMixin:
    """The closed-form solve shared by ``Ridge``, ``LinearRegression``
    and ``RidgeClassifier``, and what a round of them holds."""

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

        def kernel(op, y, sw, hyper):
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

        def kernel(op, y_idx, sw, hyper):
            sw = _apply_class_weight(sw, y_idx, k, class_weight, cw_arr)
            if k <= 2:
                T = torch.where(y_idx == (k - 1), 1.0, -1.0)[:, None]
            else:
                T = torch.where(F.one_hot(y_idx.long(), k) > 0, 1.0, -1.0)
            W = cls._solve(op, T.to(op.dtype), sw, hyper["alpha"], d)
            return {"W": W[..., 0] if k <= 2 else W}

        return kernel
