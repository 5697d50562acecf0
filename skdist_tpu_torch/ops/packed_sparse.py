"""The packed-CSR contractions on the card, beside their plain versions.

Counterpart of ``skdist_tpu/ops/pallas_sparse.py``. Two hand-written
CUDA kernels (``csrc/packed_sparse.cu``) replace its two Pallas kernels:

- :func:`packed_matvec` (K1, ``X @ W``) replaces ``_matvec_2d``;
- :func:`packed_rmatvec` (K2, ``X.T @ r``) replaces ``_rmatvec_2d``;
- :class:`PackedMatvec` ties them together as the counterpart of
  ``matvec_with_vjp``: its forward is K1 and its backward is K2.

X is the padded-row packed pair ``idx (n, m) int32`` / ``val (n, m)
float32`` whose padding entries ``(0, 0.0)`` add exactly 0. The operand
is ``(p,)``, ``(p, k)`` or a batch ``(T, p, k)`` of T tasks; a batch is
one launch with ``K = T * k`` output columns, read through strides.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
version (:func:`packed_matvec_ref`, :func:`packed_rmatvec_ref`: gather +
row-dot and ``index_add_``, the expressions of ``skdist_tpu/sparse.py``'s
``packed_matvec``/``packed_rmatvec``), a CUDA tensor to the kernel. There
is no fallback: a build or launch failure raises.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "packed_matvec",
    "packed_rmatvec",
    "packed_matvec_ref",
    "packed_rmatvec_ref",
    "PackedColumns",
    "build_columns",
    "PackedMatvec",
    "matvec_with_vjp",
]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("packed_sparse")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.skdist_packed_matvec_f32.argtypes = [
        P, P, I64, I32, P, I64, I64, P, I64, I64, I32, I32, P,
    ]
    lib.skdist_packed_matvec_f32.restype = ctypes.c_int
    lib.skdist_packed_rmatvec_f32.argtypes = [
        P, P, P, I64, P, I64, I64, P, I64, I64, I32, I32, P,
    ]
    lib.skdist_packed_rmatvec_f32.restype = ctypes.c_int
    lib.skdist_cuda_error_string.argtypes = [ctypes.c_int]
    lib.skdist_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, code, what):
    if code != 0:
        msg = lib.skdist_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


# ---------------------------------------------------------------------------
# argument checks shared by both wrappers
# ---------------------------------------------------------------------------

def _check_packed(idx, val):
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(
            f"packed pair must be int32/float32; got {idx.dtype}/{val.dtype}"
        )
    if idx.ndim != 2 or idx.shape != val.shape:
        raise ValueError(
            f"idx and val must be (n, m) of one shape; got "
            f"{tuple(idx.shape)} and {tuple(val.shape)}"
        )
    if idx.device != val.device:
        raise ValueError("idx and val must be on one device")


def _as_batch(x, name, device):
    """``(p,)``/``(p, k)``/``(T, p, k)`` float32 -> a ``(T, p, k)`` view."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32; got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the packed pair on {device}")
    if x.ndim == 1:
        return x[None, :, None]
    if x.ndim == 2:
        return x[None]
    if x.ndim == 3:
        return x
    raise ValueError(f"{name} must be 1-, 2- or 3-D; got shape {tuple(x.shape)}")


def _from_batch(out, ndim):
    if ndim == 1:
        return out[0, :, 0]
    if ndim == 2:
        return out[0]
    return out


def _kernel_strides(x3, name):
    """(row stride, batch stride) of a ``(T, rows, k)`` view the kernels
    read with unit column stride; raises on layouts they do not take."""
    T, _, k = x3.shape
    if k > 1 and x3.stride(2) != 1:
        raise ValueError(f"{name} must have unit stride along its last axis")
    if min(x3.stride()) < 0:
        raise ValueError(f"{name} has a negative stride")
    if T * k >= 2**31:
        raise ValueError(f"{name} has {T * k} output columns; at most 2**31-1")
    return x3.stride(1), (x3.stride(0) if T > 1 else 0)


# ---------------------------------------------------------------------------
# K1: X @ W
# ---------------------------------------------------------------------------

def packed_matvec_ref(idx, val, W):
    """Plain ``X @ W``: gather the rows of W, then a row dot. ``W`` is
    ``(p,)``, ``(p, k)`` or ``(T, p, k)``; returns ``(n,)``, ``(n, k)`` or
    ``(T, n, k)``."""
    if W.ndim == 1:
        return torch.sum(val * W[idx], dim=1)
    if W.ndim == 2:
        return torch.einsum("nm,nmk->nk", val, W[idx])
    return torch.einsum("nm,tnmk->tnk", val, W[:, idx])


def packed_matvec(idx, val, W):
    """``X @ W`` on the packed pair. ``W`` is ``(p,)``, ``(p, k)`` or a
    batch ``(T, p, k)``; returns ``(n,)``, ``(n, k)`` or ``(T, n, k)``
    float32. Every ``idx`` entry must lie in ``[0, p)``
    (:class:`~skdist_tpu_torch.sparse.PackedX` checks that once). CPU
    tensors take :func:`packed_matvec_ref`; CUDA tensors launch K1."""
    _check_packed(idx, val)
    W3 = _as_batch(W, "W", idx.device)
    if idx.device.type != "cuda":
        return packed_matvec_ref(idx, val, W)
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("idx and val must be contiguous")
    n, m = idx.shape
    T, _p, k = W3.shape
    w_rs, w_bs = _kernel_strides(W3, "W")
    out = torch.empty((T, n, k), dtype=torch.float32, device=idx.device)
    lib = _lib()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skdist_packed_matvec_f32(
            idx.data_ptr(), val.data_ptr(), n, m,
            W3.data_ptr(), w_rs, w_bs,
            out.data_ptr(), k, n * k, T, k, stream,
        )
    _check_launch(lib, code, "packed_matvec")
    packed_matvec.launches += 1
    return _from_batch(out, W.ndim)


packed_matvec.launches = 0


# ---------------------------------------------------------------------------
# K2: X.T @ r
# ---------------------------------------------------------------------------

def packed_rmatvec_ref(idx, val, r, n_cols):
    """Plain ``X.T @ r``: ``index_add_`` of ``val * r`` over the packed
    columns. ``r`` is ``(n,)``, ``(n, k)`` or ``(T, n, k)``; returns
    ``(n_cols,)``, ``(n_cols, k)`` or ``(T, n_cols, k)``."""
    flat = idx.reshape(-1)
    if r.ndim == 1:
        out = torch.zeros(n_cols, dtype=r.dtype, device=r.device)
        return out.index_add_(0, flat, (val * r[:, None]).reshape(-1))
    if r.ndim == 2:
        k = r.shape[1]
        out = torch.zeros((n_cols, k), dtype=r.dtype, device=r.device)
        contrib = val[:, :, None] * r[:, None, :]
        return out.index_add_(0, flat, contrib.reshape(-1, k))
    T, _, k = r.shape
    out = torch.zeros((T, n_cols, k), dtype=r.dtype, device=r.device)
    contrib = val[None, :, :, None] * r[:, :, None, :]
    return out.index_add_(1, flat, contrib.reshape(T, -1, k))


class PackedColumns:
    """The column-sorted copy of a packed pair that K2 reads: entries
    with ``val != 0`` (padding and explicit zeros dropped, which is
    exact), stably sorted by column, so each column's entries keep their
    row-major order. ``col_ptr (n_cols + 1,) int64``, ``rows (nnz,)
    int32``, ``vals (nnz,) float32``."""

    __slots__ = ("col_ptr", "rows", "vals", "n_cols")

    def __init__(self, col_ptr, rows, vals, n_cols):
        self.col_ptr = col_ptr
        self.rows = rows
        self.vals = vals
        self.n_cols = int(n_cols)

    @property
    def nnz(self):
        return int(self.vals.shape[0])


def build_columns(idx, val, n_cols):
    """Build the :class:`PackedColumns` of a packed pair on its device:
    layout preparation (a stable sort by column), done once per operator,
    not part of the contraction."""
    _check_packed(idx, val)
    m = idx.shape[1]
    flat_val = val.reshape(-1)
    keep = torch.nonzero(flat_val != 0).squeeze(1)
    cols = idx.reshape(-1)[keep].long()
    order = torch.argsort(cols, stable=True)
    counts = torch.bincount(cols, minlength=n_cols)
    if counts.shape[0] != n_cols or (cols.numel() and int(cols.min()) < 0):
        raise ValueError(f"packed idx holds a column outside [0, {n_cols})")
    col_ptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum(counts, 0, out=col_ptr[1:])
    rows = (keep // m)[order].to(torch.int32).contiguous()
    vals = flat_val[keep][order].contiguous()
    return PackedColumns(col_ptr, rows, vals, n_cols)


def packed_rmatvec(idx, val, r, n_cols, columns=None):
    """``X.T @ r`` on the packed pair. ``r`` is ``(n,)``, ``(n, k)`` or a
    batch ``(T, n, k)``; returns ``(n_cols,)``, ``(n_cols, k)`` or
    ``(T, n_cols, k)`` float32. CPU tensors take
    :func:`packed_rmatvec_ref`; CUDA tensors launch K2 over ``columns``
    (a :class:`PackedColumns`, built here when not given). Deterministic:
    two launches on the same inputs are bitwise equal."""
    _check_packed(idx, val)
    r3 = _as_batch(r, "r", idx.device)
    n_cols = int(n_cols)
    if r3.shape[1] != idx.shape[0]:
        raise ValueError(
            f"r has {r3.shape[1]} rows; the packed pair has {idx.shape[0]}"
        )
    if idx.device.type != "cuda":
        return packed_rmatvec_ref(idx, val, r, n_cols)
    if columns is None:
        columns = build_columns(idx, val, n_cols)
    if columns.n_cols != n_cols:
        raise ValueError(
            f"columns were built for {columns.n_cols} columns, not {n_cols}"
        )
    T, _n, k = r3.shape
    r_rs, r_bs = _kernel_strides(r3, "r")
    out = torch.empty((T, n_cols, k), dtype=torch.float32, device=idx.device)
    lib = _lib()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skdist_packed_rmatvec_f32(
            columns.col_ptr.data_ptr(), columns.rows.data_ptr(),
            columns.vals.data_ptr(), n_cols,
            r3.data_ptr(), r_rs, r_bs,
            out.data_ptr(), k, n_cols * k, T, k, stream,
        )
    _check_launch(lib, code, "packed_rmatvec")
    packed_rmatvec.launches += 1
    return _from_batch(out, r.ndim)


packed_rmatvec.launches = 0


# ---------------------------------------------------------------------------
# the pair as one differentiable function
# ---------------------------------------------------------------------------

class PackedMatvec(torch.autograd.Function):
    """``W -> X @ W`` for a fixed packed pair: forward is K1, backward is
    K2 (the true transpose), on CPU their plain versions. The
    counterpart of ``matvec_with_vjp`` in the JAX package; ``W`` may be
    a batch ``(T, p, k)``, whose tasks get independent gradients."""

    @staticmethod
    def forward(ctx, W, idx, val, columns):
        ctx.packed = (idx, val, columns, W.shape[-2] if W.ndim > 1 else W.shape[0])
        return packed_matvec(idx, val, W)

    @staticmethod
    def backward(ctx, g):
        idx, val, columns, p = ctx.packed
        grad = packed_rmatvec(idx, val, g.contiguous(), p, columns=columns)
        return grad, None, None, None


def matvec_with_vjp(idx, val, n_cols):
    """``W -> X @ W`` with K2 as its backward, for a FIXED packed pair
    (the column-sorted copy K2 reads is built once, here, on CUDA)."""
    columns = build_columns(idx, val, n_cols) if idx.is_cuda else None

    def mv(W):
        return PackedMatvec.apply(W, idx, val, columns)

    return mv
