"""
Packed-CSR shared-data plane for the port: sparse X as a first-class fit
and predict representation.

Counterpart of ``skdist_tpu/sparse.py``. A hashed-text matrix at 2**18
columns and ~1% density stays packed end to end: :class:`PackedX` holds
``idx (n, m) int32`` / ``val (n, m) float32`` (one padded row per
sample, ``m`` = max nnz per row, padding ``(0, 0.0)``), and the linear
fit problems reach it through :class:`LinearOperator`, whose packed form
runs the CUDA kernels of :mod:`skdist_tpu_torch.ops.packed_sparse` (K1
forward, K2 as its backward, K3 for the ridge family's gram) and whose
dense form is ``Xa @ W``. Its mini-batch row forms (the SGD steps) run
K1 and K2 in per-lane row form on packed X. :class:`MaskedLinearOperator`
is a view of one with a column mask a lane (the feature eliminator's
task axis), and :class:`MaskedColumns` pairs a shared operand that a
family reads whole (a tree's bins, naive Bayes' X) with those masks.

The host-side routing (:func:`pack_decision`, :func:`would_pack`,
:func:`pack_for_fit`) is the JAX package's, copied: pack exactly when
the packed pair saves at least :data:`PACK_MIN_SAVINGS` device bytes
and the nnz distribution has no outlier rows.

Not yet ported (ROADMAP): ``mode='dense'`` (the rebuild-then-matmul
operator; :func:`packed_to_dense` itself is here) and the matvec-mode
calibration table.
"""

import os

import numpy as np
import torch

from .ops.packed_sparse import (
    PackedMatvec,
    build_columns,
    build_pairs,
    packed_matvec,
    packed_rmatvec,
    packed_row_matvec,
    packed_row_rmatvec,
    packed_weighted_gram,
)
from .utils.meminfo import BUDGET_ENV, densify_budget_bytes

__all__ = [
    "PackedX",
    "is_sparse_2d",
    "max_nnz_per_row",
    "pack_csr_rows",
    "pack_decision",
    "would_pack",
    "pack_for_fit",
    "sparse_to_dense_f32",
    "check_densify_budget",
    "packed_to_dense",
    "matvec_any",
    "packed_matvec_bf16",
    "LinearOperator",
    "MaskedLinearOperator",
    "MaskedColumns",
    "lane_row_mask",
]

#: kill switch / force switch for the packed fit plane: "0" keeps every
#: sparse input dense, "1"/"force" packs any 2-D sparse input
SPARSE_FIT_ENV = "SKDIST_SPARSE_FIT"

#: how many times smaller (bytes) the packed pair must be than the dense
#: f32 matrix before the fit path packs
PACK_MIN_SAVINGS = 4.0
PACK_SAVINGS_ENV = "SKDIST_SPARSE_PACK_SAVINGS"

#: nnz-outlier guard: when the max row nnz exceeds this multiple of the
#: 95th percentile AND padding inflates the pair past the same multiple
#: of the true nnz, max-row padding would bill every row for a few
OUTLIER_FACTOR = 4.0


class PackedX:
    """Padded-row packed CSR: ``idx (n, m) int32``, ``val (n, m) f32``,
    as numpy arrays or as tensors on one device, and the logical width
    ``n_cols``. Every ``idx`` entry must lie in ``[0, n_cols)``; the
    constructor checks it once, since the kernels index with it
    unchecked."""

    __slots__ = ("idx", "val", "n_cols")

    def __init__(self, idx, val, n_cols):
        self._set(idx, val, n_cols)
        if tuple(idx.shape) != tuple(val.shape) or len(idx.shape) != 2:
            raise ValueError(
                f"idx and val must be (n, m) of one shape; got "
                f"{tuple(idx.shape)} and {tuple(val.shape)}"
            )
        if idx.shape[0] * idx.shape[1]:
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi >= self.n_cols:
                raise ValueError(
                    f"packed idx spans [{lo}, {hi}]; it must lie in "
                    f"[0, {self.n_cols})"
                )

    def _set(self, idx, val, n_cols):
        self.idx = idx
        self.val = val
        self.n_cols = int(n_cols)

    @classmethod
    def checked_copy(cls, idx, val, n_cols):
        """A pair whose leaves are copies of a pair already checked (the
        block feeder's device copy of a host block): no second range
        check, which on device tensors would wait for the card."""
        out = cls.__new__(cls)
        out._set(idx, val, n_cols)
        return out

    @property
    def shape(self):
        """Logical (n, d)."""
        return (int(self.idx.shape[0]), self.n_cols)

    @property
    def m(self):
        """Packed width: max nnz per row (plus padding)."""
        return int(self.idx.shape[1])

    def to(self, device):
        """Both leaves as tensors on ``device``."""
        return PackedX(
            torch.as_tensor(self.idx, dtype=torch.int32).to(device),
            torch.as_tensor(self.val, dtype=torch.float32).to(device),
            self.n_cols,
        )

    def __repr__(self):  # pragma: no cover - debugging nicety
        n, d = self.shape
        return f"PackedX(n={n}, d={d}, m={self.m})"


# ---------------------------------------------------------------------------
# host-side packing + routing
# ---------------------------------------------------------------------------

def is_sparse_2d(X):
    """scipy-sparse duck test, 2-D only."""
    return (hasattr(X, "toarray") and hasattr(X, "tocsr")
            and len(X.shape) == 2)


def max_nnz_per_row(X):
    """Packed width m from ``indptr`` alone."""
    nnz = np.diff(np.asarray(X.indptr))
    return max(1, int(nnz.max()) if nnz.size else 1)


def pack_csr_rows(X):
    """CSR -> ``(idx (n, m) int32, val (n, m) f32)``, m = max nnz per
    row, padded with ``(0, 0.0)``."""
    indptr = np.asarray(X.indptr)
    nnz = np.diff(indptr)
    m = max_nnz_per_row(X)
    n = X.shape[0]
    pos = indptr[:-1, None] + np.arange(m)[None, :]
    mask = np.arange(m)[None, :] < nnz[:, None]
    idx = np.zeros((n, m), np.int32)
    val = np.zeros((n, m), np.float32)
    idx[mask] = np.asarray(X.indices)[pos[mask]]
    val[mask] = np.asarray(X.data)[pos[mask]]
    return idx, val


def _pack_savings():
    env = os.environ.get(PACK_SAVINGS_ENV, "").strip()
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    return PACK_MIN_SAVINGS


def pack_decision(X):
    """Routing decision for a 2-D CSR input: ``(pack, reason, m)``, from
    ``indptr`` alone."""
    env = os.environ.get(SPARSE_FIT_ENV, "").strip().lower()
    if env in ("0", "false", "no", "off"):
        return False, "disabled via " + SPARSE_FIT_ENV, None
    nnz = np.diff(np.asarray(X.indptr))
    m = max(1, int(nnz.max()) if nnz.size else 1)
    if env in ("1", "true", "force", "on"):
        return True, "forced via " + SPARSE_FIT_ENV, m
    n, d = X.shape
    if n == 0:
        return False, "empty input", m
    if m * 8 * _pack_savings() > d * 4:
        return False, (
            f"dense-competitive density (m={m} of d={d}: the packed "
            f"pair saves < {_pack_savings()}x device bytes)"
        ), m
    p95 = float(np.percentile(nnz, 95)) if nnz.size else 0.0
    total = max(1, int(nnz.sum()))
    if (m > OUTLIER_FACTOR * max(p95, 1.0)
            and n * m > OUTLIER_FACTOR * total):
        return False, (
            f"nnz outlier (max row nnz {m} vs p95 {p95:.0f}: padding "
            f"would inflate {total} nnz to {n * m} slots)"
        ), m
    return True, "packed", m


def would_pack(X):
    """Whether :func:`pack_for_fit` would return a ``PackedX`` for ``X``,
    decided from shape and ``indptr`` alone."""
    if not is_sparse_2d(X):
        return False
    X = X.tocsr()
    pack, _reason, m = pack_decision(X)
    if not pack:
        return False
    budget, _ = densify_budget_bytes()
    n, _d = X.shape
    if budget is not None and n * max(1, m) * 8 * 3 > budget:
        return False
    return True


def pack_for_fit(X):
    """``PackedX`` (numpy leaves) when the fit plane should consume ``X``
    packed, else None (callers densify)."""
    if not would_pack(X):
        return None
    X = X.tocsr()
    idx, val = pack_csr_rows(X)
    return PackedX(idx, val, X.shape[1])


def sparse_to_dense_f32(X):
    """Densify a scipy-sparse input to float32, refusing a size that
    cannot fit host memory. A 1-D sparse input is a column vector. From
    2**22 elements on, the multithreaded C densifier
    (``native.csr_to_dense_f32``) fills it, as the JAX package's does;
    its result equals scipy's ``toarray`` cast to float32 where no entry
    is duplicated."""
    if len(X.shape) == 1:
        out = np.asarray(X.toarray(), dtype=np.float32)
        return np.ascontiguousarray(out.reshape(-1, 1))
    check_densify_budget(*X.shape)
    if hasattr(X, "tocsr") and X.shape[0] * X.shape[1] >= (1 << 22):
        from . import native

        return native.csr_to_dense_f32(X)
    out = np.asarray(X.toarray())
    if out.ndim == 1:
        out = out.reshape(-1, 1)
    return np.ascontiguousarray(out, dtype=np.float32)


def check_densify_budget(n_rows, n_cols):
    """Refuse a dense float32 ``(n_rows, n_cols)`` allocation that the
    host's memory cannot hold, before anything is allocated."""
    est = int(n_rows) * int(n_cols) * 4
    budget, source = densify_budget_bytes()
    if budget is not None and est > budget:
        raise ValueError(
            f"densifying this {(int(n_rows), int(n_cols))} input needs "
            f"{est / 1e9:.2f} GB as float32, but only {budget / 1e9:.2f} "
            f"GB is available ({source}); fit it packed (force with "
            f"{SPARSE_FIT_ENV}=1) or raise the limit via {BUDGET_ENV}"
        )


def packed_to_dense(idx, val, n_cols):
    """Scatter-rebuild the dense ``(n, n_cols)`` block of a packed pair
    on its device; duplicate (row, col) entries accumulate, as in CSR."""
    n = idx.shape[0]
    out = torch.zeros((n, int(n_cols)), dtype=val.dtype, device=val.device)
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    return out.index_put_((rows, idx.long()), val, accumulate=True)


def _bf16_round(x):
    """``x`` rounded to bfloat16 and held as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def packed_matvec_bf16(idx, val, W):
    """The JAX package's bf16 packed matvec, ``sum_j (v_bf16 *
    W_bf16[idx]).float()`` over each row's ``m`` entries
    (``skdist_tpu/sparse.py``'s ``LinearOperator.matvec`` under
    ``matmul_dtype='bfloat16'``): each product rounds to bf16, the row
    sums in float32. ``W`` is ``(p,)``, ``(p, k)`` or ``(T, p, k)``; the
    result ``(n,)``, ``(n, k)`` or ``(T, n, k)``. Plain PyTorch on either
    device, differentiable in ``W``."""
    v = val.to(torch.bfloat16)
    g = W.to(torch.bfloat16)[..., idx.long(), :] if W.ndim == 3 else \
        W.to(torch.bfloat16)[idx.long()]
    if W.ndim == 1:
        return (v * g).to(torch.float32).sum(dim=-1)
    return (v[..., None] * g).to(torch.float32).sum(dim=-2)


def matvec_any(X, W):
    """``X @ W`` for either representation (tensors on one device)."""
    if isinstance(X, PackedX):
        return packed_matvec(X.idx, X.val, W)
    return X @ W


# ---------------------------------------------------------------------------
# the matvec interface the fit problems consume
# ---------------------------------------------------------------------------

class LinearOperator:
    """The augmented design matrix ``X~ = [X | 1]`` behind one matvec
    interface, for a dense tensor and a :class:`PackedX` (tensor leaves)
    alike.

    Dense input is ``Xa @ W``. Packed input appends the intercept as one
    extra packed column (``idx=d, val=1``) and runs ``matvec`` through
    :class:`~skdist_tpu_torch.ops.packed_sparse.PackedMatvec` (K1
    forward, K2 backward), so the solvers differentiate through it.

    ``W`` is ``(p,)``, ``(p, k)`` or a task batch ``(T, p, k)``; the
    result is ``(n,)``, ``(n, k)`` or ``(T, n, k)``.

    :meth:`weighted_gram_rhs` gives the ridge family's normal equations;
    on packed X its gram is K3 over a pair table built at the first
    call (:meth:`gram_pairs`), so operators that never ask for a gram
    never build one.

    ``matmul_dtype='bfloat16'`` is the JAX package's bf16 contract for
    :meth:`matvec`: bf16 operands, float32 accumulation and result.
    Dense X: a float32 product of the bf16-rounded operands (a product
    of two bf16 values is exact in float32, so this is the contract's
    arithmetic; it runs on the CPU as on the card and differentiates
    like any product). Packed X: the JAX package defines the contract
    on its gather expression, ``(v_bf16 * W_bf16[idx]).float()`` summed
    over the row's entries (:func:`packed_matvec_bf16`), and keeps it
    off its Pallas kernels; so does this operator, which then runs no
    K1 and no K2. Its gradient is that expression's autograd (a
    scatter-add of bf16 products), as in the JAX package.
    """

    __slots__ = ("d", "p", "n", "Xa", "pidx", "pval", "dtype", "columns",
                 "pairs", "bf16", "_Xmm")

    def __init__(self, X, fit_intercept, matmul_dtype=None,
                 sort_columns=True):
        self.bf16 = matmul_dtype == "bfloat16"
        self._Xmm = None
        if isinstance(X, PackedX):
            d = X.n_cols
            idx, val = X.idx, X.val
            n = idx.shape[0]
            if fit_intercept:
                idx = torch.cat(
                    [idx, torch.full((n, 1), d, dtype=idx.dtype,
                                     device=idx.device)], dim=1,
                ).contiguous()
                val = torch.cat(
                    [val, torch.ones((n, 1), dtype=val.dtype,
                                     device=val.device)], dim=1,
                ).contiguous()
            self.d, self.p, self.n = d, d + int(bool(fit_intercept)), n
            self.pairs = None
            self.Xa = None
            self.pidx, self.pval = idx, val
            self.dtype = val.dtype
            # the column-sorted copy K2 reads, built once per operator;
            # ``sort_columns=False`` (a streamed value pass's operator,
            # which never runs K2) builds none
            self.columns = (
                build_columns(idx, val, self.p)
                if idx.is_cuda and not self.bf16 and sort_columns else None
            )
        else:
            if fit_intercept:
                ones = torch.ones((X.shape[0], 1), dtype=X.dtype,
                                  device=X.device)
                Xa = torch.cat([X, ones], dim=1)
            else:
                Xa = X
            self.Xa = Xa
            self.pidx = self.pval = self.columns = self.pairs = None
            self.d = X.shape[1]
            self.p = Xa.shape[1]
            self.n = X.shape[0]
            self.dtype = X.dtype

    def matvec(self, W):
        """``X~ @ W`` (under bf16, the contract of the class docstring)."""
        if self.Xa is not None:
            if self.bf16:
                if self._Xmm is None:
                    self._Xmm = _bf16_round(self.Xa)
                return self._Xmm @ _bf16_round(W)
            return self.Xa @ W
        if self.bf16:
            return packed_matvec_bf16(self.pidx, self.pval, W)
        return PackedMatvec.apply(W, self.pidx, self.pval, self.columns)

    def rmatvec(self, r):
        """``X~.T @ r``."""
        if self.Xa is not None:
            return self.Xa.T @ r
        return packed_rmatvec(self.pidx, self.pval, r, self.p,
                              columns=self.columns)

    def row_batch(self, idx):
        """The rows ``idx`` of ``X~`` (an index tensor of any shape, such
        as one ``(T, B)`` mini-batch a lane) as one gathered block, which
        :meth:`row_matvec` and :meth:`row_rmatvec` take: the SGD step
        gathers its batch once for its three products. Dense X gives the
        ``(..., p)`` rows; packed X the pair ``(pidx[idx], pval[idx])``,
        ``(..., m)`` each. A ``(T, B)`` index whose lanes share one
        batch (an expanded view, lane stride 0) gathers that batch once
        and expands it, which the row kernels read in place."""
        if self.Xa is not None:
            return self.Xa[idx]
        if idx.ndim == 2 and idx.shape[0] > 1 and idx.stride(0) == 0:
            one = idx[0]
            return (self.pidx[one].expand(idx.shape[0], -1, -1),
                    self.pval[one].expand(idx.shape[0], -1, -1))
        return self.pidx[idx], self.pval[idx]

    def row_matvec(self, rows, W):
        """``X~[idx] @ W`` of a :meth:`row_batch` block; ``(T, B, p)``
        rows (or a packed ``(T, B, m)`` pair, through K1's row form) take
        ``(T, p, k)`` weights and give ``(T, B, k)``."""
        if isinstance(rows, tuple):
            return packed_row_matvec(rows[0], rows[1], W)
        return rows @ W

    def row_rmatvec(self, rows, g):
        """``X~[idx].T @ g`` of a :meth:`row_batch` block: ``(T, B, k)``
        gives the lanes' dense ``(T, p, k)`` (K2's row form on packed
        rows)."""
        if isinstance(rows, tuple):
            return packed_row_rmatvec(rows[0], rows[1], g, self.p)
        return rows.mT @ g

    def gram_pairs(self):
        """The pair table K3 reads (packed X on the card), built once per
        operator at the first call; None for dense X or on the CPU."""
        if self.pairs is None and self.pidx is not None and self.pidx.is_cuda:
            self.pairs = build_pairs(self.pidx, self.pval, self.p)
        return self.pairs

    def weighted_gram_rhs(self, sw, T):
        """``(X~.T S X~, (S X~).T T)``, the ridge normal equations, for
        sample weights ``sw`` ``(n,)`` or a lane batch ``(L, n)`` and
        targets ``T (n, k)``; returns ``(p, p)``/``(p, k)`` or
        ``(L, p, p)``/``(L, p, k)``. Dense X keeps the JAX package's
        expressions (``Xw = Xa * sw``, ``Xa.T @ Xw``, ``Xw.T @ T``);
        packed X builds the gram with K3 and the right-hand side with
        K2."""
        if self.Xa is not None:
            Xw = self.Xa * sw[..., None]
            return self.Xa.T @ Xw, Xw.mT @ T
        G = packed_weighted_gram(self.pidx, self.pval, sw, self.p,
                                 pairs=self.gram_pairs())
        return G, self.rmatvec(sw[..., None] * T)


def lane_row_mask(fmask, p, dtype):
    """The ``(T, p)`` 0/1 mask of a linear model's weight rows from the
    lanes' column masks ``fmask (T, d)``: the rows past ``d`` (the
    intercept) are kept."""
    m = fmask.to(dtype)
    if p > m.shape[1]:
        m = torch.cat([m, m.new_ones((m.shape[0], p - m.shape[1]))], dim=1)
    return m


class MaskedLinearOperator:
    """A view of a :class:`LinearOperator` in which lane ``t`` sees only
    the columns ``fmask[t]`` keeps: the feature eliminator's ``X * fmask``
    with no copy of X a lane.

    ``fmask`` is ``(T, d)`` (0/1 or bool); the intercept column is never
    masked. The view masks the weights and the column-indexed results,
    never X: :meth:`matvec` is ``X~ @ (m * W)``, :meth:`rmatvec`
    ``m * (X~.T @ r)``, the row forms the same on a mini-batch, and the
    ridge normal equations are ``(m m.T) * G`` and ``m * b``. A masked
    weight so gets a zero data gradient (autograd through ``m * W``
    gives ``m * (X~.T @ g)``) and, from a zero start, stays zero, as
    under a zeroed column. Each product runs the wrapped operator's own
    (dense, packed kernels, bf16), on weights with the masked entries
    zeroed. ``W`` carries the lane axis: ``(T, p)`` or ``(T, p, k)``."""

    __slots__ = ("op", "m", "d", "p", "n", "dtype")

    def __init__(self, op, fmask):
        self.op = op
        self.m = lane_row_mask(fmask, op.p, op.dtype)  # (T, p)
        self.d, self.p, self.n, self.dtype = op.d, op.p, op.n, op.dtype

    def mask_weights(self, W):
        """``W`` (``(T, p)`` or ``(T, p, k)``) with each lane's masked
        rows zeroed."""
        return W * (self.m[..., None] if W.ndim == 3 else self.m)

    def matvec(self, W):
        return self.op.matvec(self.mask_weights(W))

    def rmatvec(self, r):
        return self.mask_weights(self.op.rmatvec(r))

    def row_batch(self, idx):
        return self.op.row_batch(idx)

    def row_matvec(self, rows, W):
        return self.op.row_matvec(rows, self.mask_weights(W))

    def row_rmatvec(self, rows, g):
        return self.mask_weights(self.op.row_rmatvec(rows, g))

    def gram_pairs(self):
        return self.op.gram_pairs()

    def weighted_gram_rhs(self, sw, T):
        """The wrapped operator's normal equations for the lanes of ``sw
        (T, n)``, each lane's masked rows and columns zeroed."""
        G, b = self.op.weighted_gram_rhs(sw, T)
        return (G * (self.m[:, :, None] * self.m[:, None, :]),
                self.mask_weights(b))


class MaskedColumns:
    """A shared operand read whole by its family's kernel (a tree's bins
    ``Xb (n, d)``, naive Bayes' ``X``) beside a column mask a lane,
    ``mask (T, d)`` bool: the family applies the mask where it reduces
    over columns (a tree's split search, naive Bayes' counts)."""

    __slots__ = ("base", "mask")

    def __init__(self, base, mask):
        self.base = base
        self.mask = mask.to(torch.bool)
