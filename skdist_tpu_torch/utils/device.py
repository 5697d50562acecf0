"""Device resolution, matmul precision and per-lane sums for the port's
entry points.

Entry points run on the card unless the caller passes ``device="cpu"``.
With no card and no explicit ``"cpu"`` they raise: nothing falls back to
the CPU quietly.
"""

import contextlib

import torch
import torch.nn.functional as F

#: elements of float32 in the 32-byte block every lane's row starts on in
#: :func:`lane_sum` on the card
_LANE_BLOCK = 8


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


@contextlib.contextmanager
def exact_matmuls():
    """Full-float32 matmuls for the duration (TF32 off), restoring the
    caller's setting after: the counterpart of the JAX package's
    ``exact_matmuls`` ('highest' precision), which the <= 1e-5
    ``cv_results_`` parity contract needs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lane_sum(x):
    """Sum of a ``(T, ...)`` tensor over every axis but the lane axis,
    in an order that does not depend on the lane's place in the batch.

    On the card, PyTorch's row reduction takes each row's head apart up
    to the next aligned address, so rows of a length that is not a whole
    number of vectors (n = 11314 samples, say) sum in orders that
    alternate from lane to lane. There, each lane's row is padded with
    zeros to whole 32-byte blocks first (a copy when the rows are not
    already aligned). The CPU's sums do not depend on alignment, and
    there this is the plain sum."""
    dims = tuple(range(1, x.ndim))
    if not x.is_cuda:
        return torch.sum(x, dim=dims)
    x = x.reshape(x.shape[0], -1)
    pad = -x.shape[1] % _LANE_BLOCK
    if pad or x.stride(0) % _LANE_BLOCK:
        x = F.pad(x, (0, pad))
    return torch.sum(x, dim=1)
