"""Device resolution and matmul precision for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``.
With no card and no explicit ``"cpu"`` they raise: nothing falls back to
the CPU quietly.
"""

import contextlib

import torch


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
