"""The per-level tree histogram on the card, beside its plain version.

Counterpart of ``skdist_tpu/ops/pallas_hist.py``. A hand-written CUDA
kernel (``csrc/level_histogram.cu``, K4) replaces its Pallas kernel
``level_histogram``:

    hist[t, f, j, b, c] = sum_i [Xb[i,f]==b] * [node_key[t,i]==j] * Ych[t,i,c]

for a round of T trees that share the binned features ``Xb (n, d)``.
``node_key (T, n)`` holds each sample's node relative to the level
start; a key outside ``[0, nl)`` means "not at this level". The TPU
kernel's tiling knobs (``S``, ``LB``) have no counterpart.

Dispatch is by the device of the tensors: CPU tensors go to the plain
version (:func:`level_histogram_ref`, an ``index_add_`` scatter), CUDA
tensors to the kernel. There is no fallback: a build or launch failure
raises. :func:`level_histogram` counts its kernel launches in
``level_histogram.launches``.
"""

import ctypes
import functools

import torch

from . import _build

__all__ = ["level_histogram", "level_histogram_ref", "SMEM_MAX_BYTES"]

#: shared memory one block may take on sm_90; one node's (B, C)
#: histogram must fit it
SMEM_MAX_BYTES = 227 * 1024


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("level_histogram")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.skdist_level_histogram_f32.argtypes = [
        P, I64, I64, P, P, P, I64, I32, I32, I32, I32, I32, P,
    ]
    lib.skdist_level_histogram_f32.restype = ctypes.c_int
    lib.skdist_hist_error_string.argtypes = [ctypes.c_int]
    lib.skdist_hist_error_string.restype = ctypes.c_char_p
    return lib


def _as_batch(Xb, node_key, Ych):
    """Checks, then the ``(T, n)`` / ``(T, n, C)`` forms and whether the
    input was batched."""
    if Xb.dtype != torch.int32 or node_key.dtype != torch.int32:
        raise TypeError(
            f"Xb and node_key must be int32; got {Xb.dtype}/{node_key.dtype}"
        )
    if Ych.dtype != torch.float32:
        raise TypeError(f"Ych must be float32; got {Ych.dtype}")
    if Xb.ndim != 2:
        raise ValueError(f"Xb must be (n, d); got {tuple(Xb.shape)}")
    batched = node_key.ndim == 2
    if not batched:
        node_key, Ych = node_key[None], Ych[None]
    n = Xb.shape[0]
    if node_key.ndim != 2 or Ych.ndim != 3 or node_key.shape[1] != n \
            or Ych.shape[:2] != node_key.shape:
        raise ValueError(
            f"node_key {tuple(node_key.shape)} and Ych {tuple(Ych.shape)} "
            f"do not fit Xb {tuple(Xb.shape)}"
        )
    if not (Xb.device == node_key.device == Ych.device):
        raise ValueError("Xb, node_key and Ych must be on one device")
    return node_key, Ych, batched


def level_histogram_ref(Xb, node_key, Ych, nl, n_bins):
    """Plain version: one ``index_add_`` per feature over a ``(T, nl*B +
    1, C)`` buffer whose last slot absorbs samples not at this level (or
    with a bin outside ``[0, B)``). Same signature and result as
    :func:`level_histogram`."""
    node_key, Ych, batched = _as_batch(Xb, node_key, Ych)
    T, n = node_key.shape
    d, C, B = Xb.shape[1], Ych.shape[2], int(n_bins)
    S = int(nl) * B  # the sentinel slot
    key = node_key.long()
    valid = (key >= 0) & (key < nl)
    base = torch.where(valid, key * B, S)
    t_off = (torch.arange(T, device=Xb.device) * (S + 1))[:, None]
    src = Ych.reshape(T * n, C)
    out = torch.zeros((d, T * (S + 1), C), dtype=torch.float32,
                      device=Xb.device)
    for f in range(d):
        b = Xb[:, f].long()[None, :]
        ok = valid & (b >= 0) & (b < B)
        seg = torch.where(ok, base + b, S) + t_off
        out[f].index_add_(0, seg.reshape(-1), src)
    out = out.reshape(d, T, S + 1, C)[:, :, :S].reshape(d, T, int(nl), B, C)
    out = out.transpose(0, 1).contiguous()
    return out if batched else out[0]


def level_histogram(Xb, node_key, Ych, nl, n_bins):
    """The level histogram of a round of trees.

    ``Xb (n, d) int32`` bins (any non-negative strides), ``node_key (T,
    n) int32``, ``Ych (T, n, C) float32``; returns ``(T, d, nl, B, C)``
    float32. The unbatched forms ``node_key (n,)``, ``Ych (n, C)``
    return ``(d, nl, B, C)``. CPU tensors take
    :func:`level_histogram_ref`; CUDA tensors launch K4.
    """
    node_key3, Ych3, batched = _as_batch(Xb, node_key, Ych)
    if Xb.device.type != "cuda":
        return level_histogram_ref(Xb, node_key, Ych, nl, n_bins)
    T, n = node_key3.shape
    d, C, B, nl = Xb.shape[1], Ych3.shape[2], int(n_bins), int(nl)
    if B * C * 4 > SMEM_MAX_BYTES:
        raise ValueError(
            f"level_histogram: one node's (B={B}, C={C}) histogram needs "
            f"{B * C * 4} bytes of shared memory; at most {SMEM_MAX_BYTES}"
        )
    if T > 65535:
        raise ValueError(f"level_histogram: {T} trees in one launch; "
                         "at most 65535")
    if min(Xb.stride()) < 0:
        raise ValueError("Xb has a negative stride")
    node_key3 = node_key3.contiguous()
    Ych3 = Ych3.contiguous()
    out = torch.empty((T, d, nl, B, C), dtype=torch.float32,
                      device=Xb.device)
    lib = _lib()
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skdist_level_histogram_f32(
            Xb.data_ptr(), Xb.stride(0), Xb.stride(1), node_key3.data_ptr(),
            Ych3.data_ptr(), out.data_ptr(), n, d, nl, B, C, T, stream,
        )
    if code != 0:
        msg = lib.skdist_hist_error_string(code).decode()
        raise RuntimeError(f"level_histogram kernel launch failed: {msg} "
                           f"({code})")
    level_histogram.launches += 1
    return out if batched else out[0]


level_histogram.launches = 0
