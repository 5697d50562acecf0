"""
Naive Bayes of the port: ``GaussianNB`` and ``MultinomialNB``.

Counterpart of ``skdist_tpu/models/naive_bayes.py``. Closed-form fits
(per-class weighted moments or counts: a few matmuls), on the batched
contract of :mod:`~skdist_tpu_torch.models.linear`: a fit kernel takes
``sw (T, n)`` and ``(T,)`` hypers (``var_smoothing``, ``alpha``), so a
search's (candidate x fold) tasks are one batch, and
``DistMultiModelSearch`` takes them beside the linear families. The
products run in true float32 (``exact_matmuls``), as on the main path;
no hand-written kernel is on this path.

As in the JAX package, the Gaussian moments are taken on globally
centred data (each lane's weighted mean), so ``E[x**2] - mean**2`` does
not cancel catastrophically in float32, and the Gaussian decision is
three matmuls, never an ``(n, k, d)`` intermediate.

Sparse input to a fit: a CSR matrix that the packed plane would take
(``sparse.pack_for_fit``) raises a ``TypeError``; the JAX package's
kernels fail on it too (ROADMAP Queue 3). One that it would not is
densified, as there. Sparse rows to predict are packed, as for the
linear models: ``MultinomialNB``'s decision runs K1 on them and
``GaussianNB``'s rebuilds each block dense on the device.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse import MaskedColumns, PackedX, packed_to_dense
from .linear import _LinearClassifierBase, _linear_decision

__all__ = ["GaussianNB", "MultinomialNB"]


class _NaiveBayesBase(_LinearClassifierBase):
    """The batched contract shared by the two: the fit operand is the
    dense device X itself, nothing shapes the kernel but the data, and
    the probabilities are the softmax of the ``(n, k)`` decision (two
    columns for two classes, as in the JAX package)."""

    _static_names = ()

    def _prep_fit_data(self, X, y, sample_weight=None):
        if isinstance(X, PackedX):
            raise TypeError(
                f"{type(self).__name__} takes dense X: this sparse input "
                "would be packed, and naive Bayes has no packed form (the "
                "JAX package's kernels fail on it too; see ROADMAP.md, "
                "queue 3); pass X.toarray()"
            )
        return super()._prep_fit_data(X, y, sample_weight)

    @classmethod
    def _linear_op(cls, X, static):
        return X

    @classmethod
    def _build_proba_kernel(cls, meta, static):
        decision = cls._build_decision_kernel(meta, static)

        def proba(params, X):
            return torch.softmax(decision(params, X), dim=-1)

        return proba

    def predict_proba(self, X):
        return self._device_outputs(X, "proba")

    def predict_log_proba(self, X):
        return np.log(np.clip(self.predict_proba(X), 1e-15, None))


def _weighted_onehot(y_idx, sw, k):
    """``(T, n, k)``: each lane's sample weights on its labels' columns;
    ``y_idx`` is ``(n,)`` or one vector a lane."""
    return F.one_hot(y_idx.long(), k).to(sw.dtype) * sw[..., None]


class GaussianNB(_NaiveBayesBase):
    """Gaussian naive Bayes with weighted per-class moments.

    ``var_smoothing`` (scikit-learn's: ``var_smoothing`` times the
    largest feature variance is added to every variance) rides the task
    axis. The fitted arrays are ``gmean`` (the weighted mean the moments
    are centred on), ``means_c`` and ``var`` ``(k, d)`` and ``log_prior``
    ``(k,)``. There is no ``coef_``: the decision is not linear in X.
    """

    _hyper_names = ("var_smoothing",)

    #: no masked fit: without ``coef_`` the feature eliminator cannot
    #: rank its features (it raises, as the JAX package's does)
    _mask_operand = None

    def __init__(self, var_smoothing=1e-9, device=None):
        self.var_smoothing = var_smoothing
        self.device = device

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        k = meta["n_classes"]

        def kernel(X, y_idx, sw, hyper, w0=None):
            vs = hyper["var_smoothing"]
            tot_w = torch.clamp(torch.sum(sw, dim=-1), min=1e-12)  # (T,)
            gmean = (sw @ X) / tot_w[:, None]  # (T, d)
            Xc = X - gmean[:, None, :]  # (T, n, d), centred per lane
            oh = _weighted_onehot(y_idx, sw, k)  # (T, n, k)
            cw = torch.sum(oh, dim=1)  # (T, k)
            ohT = oh.transpose(1, 2)
            means_c = (ohT @ Xc) / torch.clamp(cw[..., None], min=1e-12)
            sq2 = Xc * Xc
            var = (ohT @ sq2) / torch.clamp(cw[..., None], min=1e-12) \
                - means_c ** 2
            gvar = (sw[:, None, :] @ sq2)[:, 0] / tot_w[:, None]  # (T, d)
            var = torch.clamp(var, min=0.0) + (
                vs * torch.amax(gvar, dim=-1))[:, None, None]
            priors = cw / tot_w[:, None]
            return {
                "gmean": gmean,
                "means_c": means_c,
                "var": var,
                "log_prior": torch.log(torch.clamp(priors, min=1e-12)),
            }

        return kernel

    @classmethod
    def _decision_params(cls, params):
        return params

    def _kernel_params(self):
        return {key: np.array(self._params[key], dtype=np.float32)
                for key in ("gmean", "means_c", "var", "log_prior")}

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        def decision(params, X):
            """``(n, k)`` joint log-likelihoods of one model, or ``(T, n,
            k)`` of a lane stack (``means_c (T, k, d)``)."""
            if isinstance(X, PackedX):  # sparse rows to predict
                X = packed_to_dense(X.idx, X.val, X.n_cols)
            m, var = params["means_c"], params["var"]
            Xc = X - params["gmean"][..., None, :]
            # -(1/2)[sum log 2 pi var + sum (x - m)**2 / var] as matmuls
            const = -0.5 * (
                torch.sum(torch.log(2.0 * math.pi * var), dim=-1)
                + torch.sum(m * m / var, dim=-1)
            )  # (..., k)
            lin = Xc @ (m / var).transpose(-1, -2)
            quad = -0.5 * ((Xc * Xc) @ (1.0 / var).transpose(-1, -2))
            return quad + lin + const[..., None, :] \
                + params["log_prior"][..., None, :]

        return decision

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """A lane's centred X and its square, and its decision over X."""
        d, k = meta["n_features"], meta["n_classes"]
        return int(4 * n * d * 4 + 4 * n * k * 4 + 4 * k * d * 6)


class MultinomialNB(_NaiveBayesBase):
    """Multinomial naive Bayes over count features (hashed text, say).

    ``alpha`` (Lidstone smoothing, clamped to at least 1e-10 as
    scikit-learn does) rides the task axis. The decision is linear in X:
    ``W (d + 1, k)`` holds the per-class feature log-probabilities and,
    in its last row, the log-priors, so ``coef_``/``intercept_`` are
    those. Negative input raises, as there.

    Under the feature eliminator's column masks (the fit operand a
    :class:`~skdist_tpu_torch.sparse.MaskedColumns`) a lane's counts of
    its masked columns are 0, as over ``X * fmask``: their smoothed
    probability is ``alpha`` over a denominator that still counts all
    ``d`` columns' smoothing, and its decision weights them by 0.
    """

    _hyper_names = ("alpha",)
    #: the linear decision's intercept row (``coef_``/``intercept_``)
    fit_intercept = True

    def __init__(self, alpha=1.0, device=None):
        self.alpha = alpha
        self.device = device

    def _prep_fit_data(self, X, y, sample_weight=None):
        if not isinstance(X, PackedX) and np.asarray(X).min() < 0:
            raise ValueError(
                "Negative values in data passed to MultinomialNB "
                "(input X must be non-negative counts)"
            )
        return super()._prep_fit_data(X, y, sample_weight)

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        k = meta["n_classes"]

        def kernel(X, y_idx, sw, hyper, w0=None):
            fmask = None
            if isinstance(X, MaskedColumns):
                X, fmask = X.base, X.mask
            alpha = torch.clamp(hyper["alpha"], min=1e-10)  # (T,)
            oh = _weighted_onehot(y_idx, sw, k)  # (T, n, k)
            counts = oh.transpose(1, 2) @ X  # (T, k, d)
            if fmask is not None:
                counts = counts * fmask[:, None, :].to(counts.dtype)
            smoothed = counts + alpha[:, None, None]
            log_p = torch.log(smoothed) - torch.log(
                torch.sum(smoothed, dim=-1, keepdim=True))
            cw = torch.sum(oh, dim=1)  # (T, k)
            tot = torch.clamp(torch.sum(sw, dim=-1), min=1e-12)
            log_prior = torch.log(torch.clamp(cw / tot[:, None], min=1e-12))
            # the linear form: decision = X @ log_p.T + log_prior
            return {"W": torch.cat([log_p.transpose(1, 2),
                                    log_prior[:, None, :]], dim=1)}

        return kernel

    @classmethod
    def _mask_operand(cls, X, fmask):
        """The fit operand under the lanes' column masks ``fmask (T,
        d)``: X itself beside the masks, which mask the counts."""
        return MaskedColumns(X, fmask)

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        return _linear_decision(meta["n_features"], True, False)

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """A lane's weighted one-hot and decision, and its count table."""
        d, k = meta["n_features"], meta["n_classes"]
        return int(4 * n * k * 4 + 4 * k * d * 6)
