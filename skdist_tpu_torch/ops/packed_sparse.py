"""The packed-CSR contractions on the card, beside their plain versions.

Counterpart of ``skdist_tpu/ops/pallas_sparse.py``. Three hand-written
CUDA kernels replace its three Pallas kernels:

- :func:`packed_matvec` (K1, ``X @ W``, ``csrc/packed_sparse.cu``)
  replaces ``_matvec_2d``;
- :func:`packed_rmatvec` (K2, ``X.T @ r``, same file) replaces
  ``_rmatvec_2d``;
- :func:`packed_weighted_gram` (K3, ``X.T S X``, ``csrc/packed_gram.cu``)
  replaces ``_gram_2d``;
- :class:`PackedMatvec` ties K1 and K2 together as the counterpart of
  ``matvec_with_vjp``: its forward is K1 and its backward is K2;
- :func:`packed_row_matvec` and :func:`packed_row_rmatvec` are K1 and K2
  in per-lane row form (``csrc/packed_sparse.cu``): each lane of a task
  batch multiplies its own gathered rows ``(T, B, m)``, the SGD
  mini-batch contractions that the JAX package runs through
  ``_matvec_2d``/``_rmatvec_2d`` under its lane ``vmap``.

X is the padded-row packed pair ``idx (n, m) int32`` / ``val (n, m)
float32`` whose padding entries ``(0, 0.0)`` add exactly 0. The operand
is ``(p,)``, ``(p, k)`` or a batch ``(T, p, k)`` of T tasks; a batch is
one launch with ``K = T * k`` output columns, read through strides.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
version (:func:`packed_matvec_ref`, :func:`packed_rmatvec_ref`,
:func:`packed_weighted_gram_ref`: gather + row-dot, ``index_add_`` and
the m**2 ``index_put_`` scatter, the expressions of
``skdist_tpu/sparse.py``'s ``packed_matvec``/``packed_rmatvec``/
``packed_weighted_gram``), a CUDA tensor to the kernel. There is no
fallback: a build or launch failure raises.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, exactly
even when threads launch at once (:func:`~._build.count_launch`).
"""

import ctypes
import functools
import os

import torch

from ..utils.meminfo import densify_budget_bytes
from . import _build

__all__ = [
    "packed_matvec",
    "packed_rmatvec",
    "packed_matvec_ref",
    "packed_rmatvec_ref",
    "packed_weighted_gram",
    "packed_weighted_gram_ref",
    "PackedColumns",
    "build_columns",
    "PackedPairs",
    "build_pairs",
    "PackedMatvec",
    "matvec_with_vjp",
    "packed_row_matvec",
    "packed_row_rmatvec",
    "packed_row_matvec_ref",
    "packed_row_rmatvec_ref",
]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("packed_sparse")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.skdist_packed_matvec_f32.argtypes = [
        P, P, I64, I32, P, I64, I64, P, I64, I64, I32, I32, I32, P,
    ]
    lib.skdist_packed_matvec_f32.restype = ctypes.c_int
    lib.skdist_packed_rmatvec_f32.argtypes = [
        P, P, P, P, P, P, I64, I64, P, I64, I64, P, P, I64, I64, I32, I32,
        I32, P,
    ]
    lib.skdist_packed_rmatvec_f32.restype = ctypes.c_int
    lib.skdist_packed_row_matvec_f32.argtypes = [
        P, I64, I64, P, I64, I64, I32, I32, I32, P, I64, I64, P, I32, I32, P,
    ]
    lib.skdist_packed_row_matvec_f32.restype = ctypes.c_int
    lib.skdist_packed_row_rmatvec_f32.argtypes = [
        P, I64, I64, P, I64, I64, I32, I32, I32, P, I64, I64, P, I64, I32, P,
    ]
    lib.skdist_packed_row_rmatvec_f32.restype = ctypes.c_int
    lib.skdist_cuda_error_string.argtypes = [ctypes.c_int]
    lib.skdist_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(error_string, code, what):
    if code != 0:
        msg = error_string(code).decode()
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


def _vector_width(x3):
    """4 when K1/K2 may read the ``(T, rows, k)`` operand ``x3`` as
    16-byte vectors: ``k % 4 == 0``, unit stride along k, and its base,
    row stride and batch stride (when ``T > 1``) 16-byte aligned; else 1
    (the kernels' scalar form)."""
    T, _, k = x3.shape
    aligned = (k % 4 == 0 and x3.stride(2) == 1 and x3.data_ptr() % 16 == 0
               and x3.stride(1) % 4 == 0 and (T == 1 or x3.stride(0) % 4 == 0))
    return 4 if aligned else 1


# ---------------------------------------------------------------------------
# K1: X @ W
# ---------------------------------------------------------------------------

#: PyTorch's CPU ``bmm`` sums a product of fewer multiply-adds than this
#: (contraction x rows x columns) in plain loops, larger ones through BLAS
_BMM_LOOP_LIMIT = 400

#: columns of BLAS's full column blocks on the CPU: a trailing partial
#: block is computed another way, with other bits
_BLAS_COLUMN_BLOCK = 16


def packed_matvec_ref(idx, val, W):
    """Plain ``X @ W``: gather the rows of W, then a row dot. ``W`` is
    ``(p,)``, ``(p, k)`` or ``(T, p, k)``; returns ``(n,)``, ``(n, k)`` or
    ``(T, n, k)``.

    A task batch must give every task the bits it gets in any other slot
    of the batch (as K1 does), which the compacted scheduler relies on.
    Where the batched product goes through the CPU's BLAS, each task's
    ``k`` columns are padded to whole column blocks, so no task falls in
    the trailing partial block that BLAS sums another way; the padding
    leaves the other tasks' bits as an unpadded batch gives them."""
    if W.ndim == 1:
        return torch.sum(val * W[idx], dim=1)
    if W.ndim == 2:
        return torch.einsum("nm,nmk->nk", val, W[idx])
    k = W.shape[2]
    if not W.is_cuda and val.shape[1] * W.shape[0] * k >= _BMM_LOOP_LIMIT:
        kb = -(-k // _BLAS_COLUMN_BLOCK) * _BLAS_COLUMN_BLOCK
        W = torch.nn.functional.pad(W, (0, kb - k))
    return torch.einsum("nm,tnmk->tnk", val, W[:, idx])[..., :k]


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
            out.data_ptr(), k, n * k, T, k, _vector_width(W3), stream,
        )
    _check_launch(lib.skdist_cuda_error_string, code, "packed_matvec")
    _build.count_launch(packed_matvec)
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


#: entries of a K2 column segment: a longer column is cut into segments
#: of at most this many entries, summed apart and then combined
SEGMENT_ENTRIES = 64


class PackedColumns:
    """The column-sorted copy of a packed pair that K2 reads: entries
    with ``val != 0`` (padding and explicit zeros dropped, which is
    exact), stably sorted by column, so each column's entries keep their
    row-major order. ``col_ptr (n_cols + 1,) int64``, ``rows (nnz,)
    int32``, ``vals (nnz,) float32``.

    Beside it, the segment table: each column of more than
    :data:`SEGMENT_ENTRIES` entries is cut into consecutive segments of
    at most that many. Column c owns segments ``col_seg[c]:col_seg[c + 1]``
    (``(n_cols + 1,) int32``; none for a column that is not cut), and
    segment s holds the entries ``seg_lo[s]:seg_hi[s]`` (``int64``)."""

    __slots__ = ("col_ptr", "rows", "vals", "n_cols", "col_seg", "seg_lo",
                 "seg_hi")

    def __init__(self, col_ptr, rows, vals, n_cols, col_seg, seg_lo, seg_hi):
        self.col_ptr = col_ptr
        self.rows = rows
        self.vals = vals
        self.n_cols = int(n_cols)
        self.col_seg = col_seg
        self.seg_lo = seg_lo
        self.seg_hi = seg_hi

    @property
    def nnz(self):
        return int(self.vals.shape[0])

    @property
    def n_segs(self):
        return int(self.seg_lo.shape[0])


def build_columns(idx, val, n_cols):
    """Build the :class:`PackedColumns` of a packed pair on its device:
    layout preparation (a stable sort by column, then the segment table),
    done once per operator, not part of the contraction."""
    _check_packed(idx, val)
    m = idx.shape[1]
    dev = idx.device
    flat_val = val.reshape(-1)
    keep = torch.nonzero(flat_val != 0).squeeze(1)
    cols = idx.reshape(-1)[keep].long()
    order = torch.argsort(cols, stable=True)
    counts = torch.bincount(cols, minlength=n_cols)
    if counts.shape[0] != n_cols or (cols.numel() and int(cols.min()) < 0):
        raise ValueError(f"packed idx holds a column outside [0, {n_cols})")
    col_ptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=col_ptr[1:])
    rows = (keep // m)[order].to(torch.int32).contiguous()
    vals = flat_val[keep][order].contiguous()

    L = SEGMENT_ENTRIES
    n_seg = torch.where(counts > L, (counts + L - 1) // L, 0)
    seg_ptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_seg, 0, out=seg_ptr[1:])
    n_segs = int(seg_ptr[-1])
    if n_segs >= 2**31:
        raise ValueError(f"{n_segs} column segments; at most 2**31-1")
    seg_col = torch.repeat_interleave(
        torch.arange(n_cols, device=dev), n_seg, output_size=n_segs)
    first = torch.arange(n_segs, device=dev) - seg_ptr[seg_col]
    seg_lo = (col_ptr[seg_col] + first * L).contiguous()
    seg_hi = torch.minimum(seg_lo + L, col_ptr[seg_col + 1]).contiguous()
    return PackedColumns(col_ptr, rows, vals, n_cols,
                         seg_ptr.to(torch.int32).contiguous(), seg_lo, seg_hi)


def packed_rmatvec(idx, val, r, n_cols, columns=None):
    """``X.T @ r`` on the packed pair. ``r`` is ``(n,)``, ``(n, k)`` or a
    batch ``(T, n, k)``; returns ``(n_cols,)``, ``(n_cols, k)`` or
    ``(T, n_cols, k)`` float32. CPU tensors take
    :func:`packed_rmatvec_ref`; CUDA tensors launch K2 over ``columns``
    (a :class:`PackedColumns`, built here when not given): its segment
    pass when the columns have segments, then its tile pass (one count
    in ``launches`` a call). Deterministic: two calls on the same inputs
    are bitwise equal."""
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
    partial = torch.empty((columns.n_segs, T * k), dtype=torch.float32,
                          device=idx.device)
    lib = _lib()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skdist_packed_rmatvec_f32(
            columns.col_ptr.data_ptr(), columns.col_seg.data_ptr(),
            columns.seg_lo.data_ptr(), columns.seg_hi.data_ptr(),
            columns.rows.data_ptr(), columns.vals.data_ptr(), n_cols,
            columns.n_segs, r3.data_ptr(), r_rs, r_bs, partial.data_ptr(),
            out.data_ptr(), k, n_cols * k, T, k, _vector_width(r3), stream,
        )
    _check_launch(lib.skdist_cuda_error_string, code, "packed_rmatvec")
    _build.count_launch(packed_rmatvec)
    return _from_batch(out, r.ndim)


packed_rmatvec.launches = 0


# ---------------------------------------------------------------------------
# K1 and K2 in per-lane row form: the SGD mini-batch contractions
# ---------------------------------------------------------------------------

def _check_rows(idx, val):
    """Gathered rows ``(T, B, m)``: int32/float32 of one shape and device."""
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(
            f"packed rows must be int32/float32; got {idx.dtype}/{val.dtype}"
        )
    if idx.ndim != 3 or idx.shape != val.shape:
        raise ValueError(
            f"idx and val must be (T, B, m) of one shape; got "
            f"{tuple(idx.shape)} and {tuple(val.shape)}"
        )
    if idx.device != val.device:
        raise ValueError("idx and val must be on one device")


def _check_lane_operand(x, name, T, rows, device):
    """A float32 ``(T, rows, k)`` operand on ``device``."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32; got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the packed rows on {device}")
    if x.ndim != 3 or x.shape[0] != T or (rows is not None
                                          and x.shape[1] != rows):
        raise ValueError(
            f"{name} must be ({T}, {rows if rows is not None else 'p'}, k); "
            f"got {tuple(x.shape)}"
        )


def _lane_strides(x, name, unit_last):
    """(lane stride, row stride) of a ``(T, rows, n)`` block the row
    kernels read with unit stride along its last axis (when
    ``unit_last``, i.e. that axis is longer than 1); a lane stride of 0
    (an expanded block, one batch shared by every lane) is read as it
    is, and an axis of length 1 gets stride 0."""
    T, rows, _ = x.shape
    ls, rs, cs = x.stride()
    if unit_last and cs != 1:
        raise ValueError(f"{name} must have unit stride along its last axis")
    if ls < 0 or rs < 0 or cs < 0:
        raise ValueError(f"{name} has a negative stride")
    return (ls if T > 1 else 0), (rs if rows > 1 else 0)


def _row_pair_strides(idx, val):
    """``(i_ls, i_rs, v_ls, v_rs)``: the lane and row strides of the
    gathered pair, read with unit stride along m."""
    _T, B, m = idx.shape
    if B * m >= 2**31:
        raise ValueError(f"the rows have {B * m} entries a lane; at most "
                         "2**31-1")
    return (*_lane_strides(idx, "idx", m > 1), *_lane_strides(val, "val",
                                                               m > 1))


def _launch(fn, device, *args):
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``device``, which is made the current device for the launch only when
    it is not already; raises when the launch failed. The row kernels
    take microseconds on the card, so their host path is kept short: no
    ``torch.cuda.device`` context on the usual path, and the stream's
    handle read directly (``torch.cuda.current_stream()`` builds a
    Python stream object a call)."""
    index = device.index
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code:
        _check_launch(_lib().skdist_cuda_error_string, code, fn.__name__)


def packed_row_matvec_ref(idx, val, W):
    """Plain per-lane ``X[rows] @ W``: lane t's rows ``(idx[t], val[t])``
    ``(B, m)`` times its own ``W[t]`` ``(p, k)``, a gather of W's rows and
    a row dot; returns ``(T, B, k)``. The JAX package's ``packed_matvec``
    on one lane's gathered rows."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return torch.sum(val[..., None] * W[lanes, idx.long()], dim=2)


def packed_row_matvec(idx, val, W):
    """``X[rows] @ W`` for every lane of a batch: ``idx``/``val`` ``(T, B,
    m)`` (each lane's B gathered packed rows, read through their lane
    and row strides, so an expanded block shared by every lane is not
    copied) and ``W`` ``(T, p, k)``; returns ``(T, B, k)`` float32. Every
    ``idx`` entry must lie in ``[0, p)``. CPU tensors take
    :func:`packed_row_matvec_ref`; CUDA tensors launch K1's row form. Up
    to four j vectors (k <= 4, or k <= 16 read as 16-byte vectors) a
    group of warp lanes owns each (lane, row): each issues its strided
    share of the row's gathers at once and a fixed shuffle tree adds the
    partial sums; wider k, one thread per (lane, row, j vector) sums the
    row in stored order. Either way the order depends on m alone, so a
    lane's bits do not depend on its slot and repeat bitwise."""
    _check_rows(idx, val)
    T, B, m = idx.shape
    _check_lane_operand(W, "W", T, None, idx.device)
    if idx.device.type != "cuda":
        return packed_row_matvec_ref(idx, val, W)
    k = W.shape[2]
    strides = _row_pair_strides(idx, val)
    w_bs, w_rs = _lane_strides(W, "W", k > 1)
    if T * k >= 2**31:
        raise ValueError(f"W has {T * k} output columns; at most 2**31-1")
    out = W.new_empty((T, B, k))
    _launch(_lib().skdist_packed_row_matvec_f32, idx.device, idx.data_ptr(),
            strides[0], strides[1], val.data_ptr(), strides[2], strides[3],
            T, B, m, W.data_ptr(), w_rs, w_bs, out.data_ptr(), k,
            _vector_width(W))
    _build.count_launch(packed_row_matvec)
    return out


packed_row_matvec.launches = 0


def packed_row_rmatvec_ref(idx, val, g, n_cols):
    """Plain per-lane ``X[rows].T @ g``: lane t's rows ``(B, m)`` against
    its own ``g[t]`` ``(B, k)``, one ``index_add_`` of the products
    ``val * g`` into the lanes' dense ``(n_cols, k)`` planes, entries in
    row-major (row, slot) order; returns ``(T, n_cols, k)``. The JAX
    package's ``packed_rmatvec`` on one lane's gathered rows."""
    T, B, m = idx.shape
    k = g.shape[2]
    n_cols = int(n_cols)
    out = torch.zeros((T * n_cols, k), dtype=g.dtype, device=g.device)
    lane0 = torch.arange(T, device=idx.device)[:, None, None] * n_cols
    contrib = val[..., None] * g[:, :, None, :]
    out.index_add_(0, (lane0 + idx.long()).reshape(-1),
                   contrib.reshape(-1, k))
    return out.view(T, n_cols, k)


def packed_row_rmatvec(idx, val, g, n_cols):
    """``X[rows].T @ g`` for every lane of a batch: ``idx``/``val`` ``(T,
    B, m)`` as in :func:`packed_row_matvec`, ``g`` ``(T, B, k)``; returns
    the lanes' dense ``(T, n_cols, k)`` float32 planes. CPU tensors take
    :func:`packed_row_rmatvec_ref`; CUDA tensors launch K2's row form,
    one launch and no zeroing pass: a block owns a slice of columns of
    a lane (of up to 32 lanes when every lane reads one shared batch),
    picks the lane's entries on its columns in position order, groups
    them by column, writes zeros over the whole slice and then each
    touched column's sum, its run added in position order from +0.0
    (entries of value 0 add exact zeros and are left out unless g holds
    an inf or a NaN). No float atomics: each output is the plain
    version's sum in the plain version's order, so it is deterministic,
    bitwise repeatable and independent of the lane's slot."""
    _check_rows(idx, val)
    T, B, m = idx.shape
    _check_lane_operand(g, "g", T, B, idx.device)
    n_cols = int(n_cols)
    if idx.device.type != "cuda":
        return packed_row_rmatvec_ref(idx, val, g, n_cols)
    k = g.shape[2]
    strides = _row_pair_strides(idx, val)
    g_ls, g_rs = _lane_strides(g, "g", k > 1)
    out = g.new_empty((T, n_cols, k))
    _launch(_lib().skdist_packed_row_rmatvec_f32, idx.device, idx.data_ptr(),
            strides[0], strides[1], val.data_ptr(), strides[2], strides[3],
            T, B, m, g.data_ptr(), g_ls, g_rs, out.data_ptr(), n_cols, k)
    _build.count_launch(packed_row_rmatvec)
    return out


packed_row_rmatvec.launches = 0


# ---------------------------------------------------------------------------
# K3: X.T S X
# ---------------------------------------------------------------------------

#: env override (rows per chunk) of the plain gram's row chunking
GRAM_CHUNK_ENV = "SKDIST_GRAM_CHUNK_ROWS"


@functools.lru_cache(maxsize=None)
def _gram_lib():
    lib = _build.load("packed_gram")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.skdist_packed_gram_f32.argtypes = [
        P, P, P, P, P, I64, P, I64, P, I64, I32, P,
    ]
    lib.skdist_packed_gram_f32.restype = ctypes.c_int
    lib.skdist_gram_error_string.argtypes = [ctypes.c_int]
    lib.skdist_gram_error_string.restype = ctypes.c_char_p
    return lib


def _gram_row_chunk(n, m, lanes):
    """Rows per chunk of :func:`packed_weighted_gram_ref`, or None for
    one shot (a copy of ``skdist_tpu/sparse.py``'s): the env override
    first; otherwise the ``(lanes, n, m, m)`` contribution tensor is
    billed against the host memory budget at 1/8 (the tensor, its
    indices and the scatter's temporaries coexist), and chunking engages
    only when the bill overshoots that share."""
    env = os.environ.get(GRAM_CHUNK_ENV, "").strip()
    if env:
        try:
            v = int(float(env))
            if v > 0:
                return min(v, n)
        except ValueError:
            pass
    budget, _ = densify_budget_bytes()
    if budget is None:
        return None
    lane_bytes = int(m) * int(m) * 4 * max(1, int(lanes))
    share = budget // 8
    if int(n) * lane_bytes <= share:
        return None
    return max(1, int(share // max(lane_bytes, 1)))


def _check_sw(sw, n, device):
    if sw.dtype != torch.float32:
        raise TypeError(f"sw must be float32; got {sw.dtype}")
    if sw.device != device:
        raise ValueError(f"sw is on {sw.device}, the packed pair on {device}")
    if sw.ndim not in (1, 2) or sw.shape[-1] != n:
        raise ValueError(
            f"sw must be ({n},) or (T, {n}); got {tuple(sw.shape)}"
        )


def packed_weighted_gram_ref(idx, val, sw, n_cols, row_chunk=None):
    """Plain ``X.T S X``: the m**2 scatter of the JAX package's
    ``sparse.packed_weighted_gram``, contribution
    ``(val[i,a] * sw[i]) * val[i,b]`` at ``(idx[i,a], idx[i,b])``,
    accumulated with ``index_put_`` over the flattened output in chunks
    of ``row_chunk`` rows (default :func:`_gram_row_chunk`). ``sw`` is
    ``(n,)`` or a lane batch ``(T, n)``; returns ``(n_cols, n_cols)`` or
    ``(T, n_cols, n_cols)``."""
    n, m = idx.shape
    p = int(n_cols)
    sw2 = sw if sw.ndim == 2 else sw[None]
    T = sw2.shape[0]
    if row_chunk is None:
        row_chunk = _gram_row_chunk(n, m, lanes=T)
    chunk = n if row_chunk is None else max(1, min(int(row_chunk), n))
    out = torch.zeros(T * p * p, dtype=val.dtype, device=val.device)
    lane0 = (torch.arange(T, device=idx.device) * (p * p))[:, None, None, None]
    for i0 in range(0, n, chunk):
        ii = idx[i0:i0 + chunk].long()
        vv = val[i0:i0 + chunk]
        vw = vv[None] * sw2[:, i0:i0 + chunk, None]  # (T, c, m)
        contrib = vw[:, :, :, None] * vv[None, :, None, :]  # (T, c, m, m)
        cell = lane0 + (ii[:, :, None] * p + ii[:, None, :])[None]
        out.index_put_((cell.reshape(-1),), contrib.reshape(-1),
                       accumulate=True)
    out = out.reshape(T, p, p)
    return out if sw.ndim == 2 else out[0]


class PackedPairs:
    """The pair table K3 reads: every ``(row, slot a, slot b)`` of a
    packed pair with both values nonzero (padding and explicit zeros
    dropped, which is exact), stably sorted by its output cell
    ``idx[a] * n_cols + idx[b]``, so each cell's rows ascend, for a pair
    of ``n_rows`` rows. Per pair
    ``rows (n_pairs,) int32``, ``va``/``vb (n_pairs,) float32`` (the
    values at slots a and b); per occupied cell ``cell_key (n_cells,)
    int64`` and ``cell_ptr (n_cells + 1,) int64``. Independent of the
    sample weights: one table serves every lane and round."""

    __slots__ = ("cell_key", "cell_ptr", "rows", "va", "vb", "n_rows",
                 "n_cols")

    def __init__(self, cell_key, cell_ptr, rows, va, vb, n_rows, n_cols):
        self.cell_key = cell_key
        self.cell_ptr = cell_ptr
        self.rows = rows
        self.va = va
        self.vb = vb
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    @property
    def n_pairs(self):
        return int(self.rows.shape[0])

    @property
    def n_cells(self):
        return int(self.cell_key.shape[0])

    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in (
            self.cell_key, self.cell_ptr, self.rows, self.va, self.vb))


def build_pairs(idx, val, n_cols):
    """Build the :class:`PackedPairs` of a packed pair on its device:
    layout preparation (a stable sort by output cell), done once per
    operator, not part of the contraction."""
    _check_packed(idx, val)
    n, m = idx.shape
    p = int(n_cols)
    nz = val != 0
    both = (nz[:, :, None] & nz[:, None, :]).reshape(-1)
    flat = torch.nonzero(both).squeeze(1)  # (row, a, b) row-major
    row = flat // (m * m)
    a = (flat // m) % m
    b = flat % m
    del flat, both
    cols_a = idx[row, a].long()
    cols_b = idx[row, b].long()
    if cols_a.numel() and (int(cols_a.min()) < 0 or int(cols_a.max()) >= p):
        raise ValueError(f"packed idx holds a column outside [0, {p})")
    key = cols_a * p + cols_b
    del cols_a, cols_b
    order = torch.argsort(key, stable=True)
    key = key[order]
    cell_key, counts = torch.unique_consecutive(key, return_counts=True)
    del key
    cell_ptr = torch.zeros(cell_key.shape[0] + 1, dtype=torch.int64,
                           device=idx.device)
    torch.cumsum(counts, 0, out=cell_ptr[1:])
    row, a, b = row[order], a[order], b[order]
    return PackedPairs(
        cell_key.contiguous(), cell_ptr, row.to(torch.int32).contiguous(),
        val[row, a].contiguous(), val[row, b].contiguous(), n, p,
    )


def packed_weighted_gram(idx, val, sw, n_cols, pairs=None):
    """``X.T S X`` on the packed pair. ``sw`` is ``(n,)`` or a lane
    batch ``(T, n)``; returns ``(n_cols, n_cols)`` or ``(T, n_cols,
    n_cols)`` float32. CPU tensors take :func:`packed_weighted_gram_ref`;
    CUDA tensors launch K3 once for all lanes, over ``pairs`` (a
    :class:`PackedPairs`, built here when not given). Deterministic: two
    launches on the same inputs are bitwise equal."""
    _check_packed(idx, val)
    _check_sw(sw, idx.shape[0], idx.device)
    p = int(n_cols)
    if idx.device.type != "cuda":
        return packed_weighted_gram_ref(idx, val, sw, p)
    if pairs is None:
        pairs = build_pairs(idx, val, p)
    if (pairs.n_rows, pairs.n_cols) != (idx.shape[0], p):
        raise ValueError(
            f"pairs were built for {pairs.n_rows} rows and {pairs.n_cols} "
            f"columns, not {idx.shape[0]} and {p}"
        )
    sw2 = (sw if sw.ndim == 2 else sw[None]).contiguous()
    T = sw2.shape[0]
    out = torch.empty((T, p, p), dtype=torch.float32, device=idx.device)
    lib = _gram_lib()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skdist_packed_gram_f32(
            pairs.cell_key.data_ptr(), pairs.cell_ptr.data_ptr(),
            pairs.rows.data_ptr(), pairs.va.data_ptr(), pairs.vb.data_ptr(),
            pairs.n_cells, sw2.data_ptr(), sw2.stride(0) if T > 1 else 0,
            out.data_ptr(), p * p, T, stream,
        )
    _check_launch(lib.skdist_gram_error_string, code, "packed_weighted_gram")
    _build.count_launch(packed_weighted_gram)
    return out if sw.ndim == 2 else out[0]


packed_weighted_gram.launches = 0


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
