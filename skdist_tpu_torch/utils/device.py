"""Device resolution, matmul precision and per-lane sums for the port's
entry points.

Entry points run on the card unless the caller passes ``device="cpu"``.
With no card and no explicit ``"cpu"`` they raise: nothing falls back to
the CPU quietly.
"""

import contextlib
import threading

import torch
import torch.nn.functional as F

#: elements of float32 in the 32-byte block every lane's row starts on in
#: :func:`lane_sum` on the card
_LANE_BLOCK = 8

#: the CPU's reduction grain: PyTorch cuts a reduction of this many
#: elements or more across threads, as the batch's shape falls
_CPU_GRAIN = 32768


def resolve_device(device=None):
    """``torch.device`` for ``device``: None means ``"cuda"``. Raises when
    a CUDA device is asked for (or implied) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; skdist_tpu_torch runs on the card "
            "by default; pass device='cpu' to run the plain CPU versions"
        )
    return dev


#: holders of :func:`exact_matmuls` in this process, and the TF32 setting
#: the first of them found
_EXACT = {"holders": 0, "saved": None}
_EXACT_LOCK = threading.Lock()


@contextlib.contextmanager
def exact_matmuls():
    """Full-float32 matmuls for the duration (TF32 off): the counterpart
    of the JAX package's ``exact_matmuls`` ('highest' precision), which
    the <= 1e-5 ``cv_results_`` parity contract needs.

    The switch is process-global and threads may hold the context at
    once (``LocalBackend(n_jobs>1)``, concurrent prediction callers), so
    the holders are counted under a lock: the first saves the caller's
    setting and turns TF32 off, the last one out restores it. A thread
    leaving while another still holds the context leaves TF32 off."""
    matmul = torch.backends.cuda.matmul
    with _EXACT_LOCK:
        if _EXACT["holders"] == 0:
            _EXACT["saved"] = matmul.allow_tf32
            matmul.allow_tf32 = False
        _EXACT["holders"] += 1
    try:
        yield
    finally:
        with _EXACT_LOCK:
            _EXACT["holders"] -= 1
            if _EXACT["holders"] == 0:
                matmul.allow_tf32 = _EXACT["saved"]


def lane_sum(x):
    """Sum of a ``(T, ...)`` tensor over every axis but the lane axis,
    in an order that does not depend on the lane's place in the batch.

    On the card, PyTorch's row reduction takes each row's head apart up
    to the next aligned address, so rows of a length that is not a whole
    number of vectors (n = 11314 samples, say) sum in orders that
    alternate from lane to lane. There, each lane's row is padded with
    zeros to whole 32-byte blocks first (a copy when the rows are not
    already aligned). The CPU's sums do not depend on alignment, but a
    batch of long rows (``_CPU_GRAIN`` elements or more) is cut across
    threads by the batch's shape: there each lane's row is summed alone,
    as a lone lane's is. Otherwise, and for one lane, this is the plain
    sum."""
    dims = tuple(range(1, x.ndim))
    if not x.is_cuda:
        if x.shape[0] > 1 and x[0].numel() >= _CPU_GRAIN:
            return torch.stack([torch.sum(row) for row in x])
        return torch.sum(x, dim=dims)
    x = x.reshape(x.shape[0], -1)
    pad = -x.shape[1] % _LANE_BLOCK
    if pad or x.stride(0) % _LANE_BLOCK:
        x = F.pad(x, (0, pad))
    return torch.sum(x, dim=1)
