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

The kernel has two kinds of shared-memory cell. A channel whose values
are whole numbers, with every tree's sum of ``|values|`` below 2**24
(bootstrap counts times unit weights, every count channel), sums exactly
in int32 cells; the caller proves it once a round with
:func:`integer_channels` and hands the proof to :func:`level_histogram`
as ``integer=``. The other channels take float cells. The bins may be
int32 or uint8 (a quarter of the bytes).
"""

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "IntegerChannels",
    "MAX_SAMPLES",
    "SMEM_MAX_BYTES",
    "integer_channels",
    "kernel_bins",
    "level_histogram",
    "level_histogram_ref",
]

#: shared memory one node's (B, C) histogram may take in a K4 block: the
#: 227 KB a block may have on sm_90, less its warps' 12 KB of sample queues
SMEM_MAX_BYTES = 227 * 1024 - 12 * 1024

#: most samples one launch takes (K4 indexes them with 32-bit ints)
MAX_SAMPLES = 2 ** 31 - 2 ** 12

#: trees checked at once by :func:`integer_channels` (bounds its
#: temporaries to this many trees' channels)
_CHECK_TREES = 32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("level_histogram")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.skdist_level_histogram_f32.argtypes = [
        P, I32, I64, I64, P, P, P, I64, I32, I32, I32, I32, ctypes.c_uint32,
        I32, P,
    ]
    lib.skdist_level_histogram_f32.restype = ctypes.c_int
    lib.skdist_hist_error_string.argtypes = [ctypes.c_int]
    lib.skdist_hist_error_string.restype = ctypes.c_char_p
    return lib


class IntegerChannels:
    """Proof, made by :func:`integer_channels`, that some channels of one
    channels tensor hold whole numbers whose (tree, channel) sums of
    ``|values|`` stay below 2**24: bit c of ``mask`` for channel c. It
    names that tensor by storage, shape, strides and in-place version, so
    :func:`level_histogram` refuses it for any other tensor, or for the
    same one after an in-place change."""

    __slots__ = ("mask", "_sig")

    def __init__(self, Ych, mask):
        self.mask = int(mask)
        self._sig = self._signature(Ych)

    @staticmethod
    def _signature(Ych):
        return (Ych.device, Ych.data_ptr(), tuple(Ych.shape), Ych.stride(),
                Ych._version)

    def matches(self, Ych):
        return self._sig == self._signature(Ych)


def integer_channels(Ych):
    """:class:`IntegerChannels` for ``Ych (T, n, C)`` (or ``(n, C)``)
    float32, marking each channel c (c < 32) whose values are all whole
    numbers and whose sum of ``|values|`` is below 2**24 in every tree;
    None when no channel is. Every partial sum of such a channel's
    histogram is then exact in float32 and in int32, whatever the order,
    and K4 sums it in int32 (bootstrap counts times unit weights, and
    every count channel). One pass over ``Ych``, a few trees at a time,
    and one host sync: a caller checks once a round, not once a level."""
    Y = Ych if Ych.ndim == 3 else Ych[None]
    if Ych.dtype != torch.float32 or Y.ndim != 3:
        raise TypeError(f"Ych must be (T, n, C) float32; got {Ych.dtype} "
                        f"{tuple(Ych.shape)}")
    C = Y.shape[2]
    frac = torch.zeros(C, dtype=torch.bool, device=Y.device)
    top = torch.zeros(C, dtype=torch.float64, device=Y.device)
    for t0 in range(0, Y.shape[0], _CHECK_TREES):
        part = Y[t0:t0 + _CHECK_TREES]
        frac |= torch.any((part != torch.round(part)).reshape(-1, C), dim=0)
        if part.numel():
            top = torch.maximum(top, torch.amax(
                torch.sum(part.abs(), dim=1, dtype=torch.float64), dim=0))
    ok = (~frac & (top < 2.0 ** 24)).tolist()
    mask = sum(1 << c for c in range(min(C, 32)) if ok[c])
    return IntegerChannels(Ych, mask) if mask else None


def kernel_bins(Xb, n_bins):
    """``Xb (n, d)`` bins in the layout K4 reads fastest, made once a
    round: uint8 rows padded to 16 bytes (returned as the strided ``(n,
    d)`` view) when ``n_bins <= 255``, every bin outside ``[0, n_bins)``
    stored as 255 (so it still adds nothing); else ``Xb`` itself."""
    B = int(n_bins)
    if B > 255:
        return Xb
    n, d = Xb.shape
    rows = torch.full((n, -(-d // 16) * 16), 255, dtype=torch.uint8,
                      device=Xb.device)
    rows[:, :d] = torch.where((Xb >= 0) & (Xb < B), Xb, 255)
    return rows[:, :d]


def _as_batch(Xb, node_key, Ych):
    """Checks, then the ``(T, n)`` / ``(T, n, C)`` forms and whether the
    input was batched."""
    if Xb.dtype not in (torch.int32, torch.uint8) \
            or node_key.dtype != torch.int32:
        raise TypeError(
            f"Xb must be int32 or uint8 and node_key int32; got "
            f"{Xb.dtype}/{node_key.dtype}"
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
    with a bin outside ``[0, B)``). Same arguments (but ``integer``) and
    result as :func:`level_histogram`."""
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


def level_histogram(Xb, node_key, Ych, nl, n_bins, integer=None):
    """The level histogram of a round of trees.

    ``Xb (n, d)`` int32 or uint8 bins (any non-negative strides; K4 reads
    the layout of :func:`kernel_bins` fastest), ``node_key (T,
    n) int32``, ``Ych (T, n, C) float32``; returns ``(T, d, nl, B, C)``
    float32. The unbatched forms ``node_key (n,)``, ``Ych (n, C)``
    return ``(d, nl, B, C)``. ``integer``: None, or the
    :class:`IntegerChannels` that :func:`integer_channels` made for this
    very ``Ych``; with it K4 sums the channels it marks in int32 (exact, so
    bitwise equal to the plain version), and anything else raises. CPU
    tensors take :func:`level_histogram_ref`; CUDA tensors launch K4.
    """
    node_key3, Ych3, batched = _as_batch(Xb, node_key, Ych)
    if integer is not None:
        if not isinstance(integer, IntegerChannels):
            raise TypeError(
                "integer must be None or the IntegerChannels that "
                f"integer_channels(Ych) returned; got {type(integer).__name__}"
            )
        if not integer.matches(Ych):
            raise ValueError(
                "integer= was made for another channels tensor (or this one "
                "changed in place since): call integer_channels(Ych) again"
            )
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
    if n > MAX_SAMPLES:
        raise ValueError(f"level_histogram: {n} samples; at most "
                         f"{MAX_SAMPLES}")
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
            Xb.data_ptr(), int(Xb.dtype == torch.uint8), Xb.stride(0),
            Xb.stride(1), node_key3.data_ptr(), Ych3.data_ptr(),
            out.data_ptr(), n, d, nl, B, C,
            0 if integer is None else integer.mask, T, stream,
        )
    if code != 0:
        msg = lib.skdist_hist_error_string(code).decode()
        raise RuntimeError(f"level_histogram kernel launch failed: {msg} "
                           f"({code})")
    level_histogram.launches += 1
    return out if batched else out[0]


level_histogram.launches = 0
