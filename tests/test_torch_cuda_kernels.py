"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip on a machine without a CUDA device (a
CUDA kernel has no CPU or interpret mode). On the card, without the JAX
test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerance: an output is a sum of c products (c = m for K1, the column's
entry count for K2); two float32 sums of the same terms in different
orders differ by at most 2 * c * 2**-24 * sum|terms|.
"""

import numpy as np
import pytest
import torch

from skdist_tpu_torch.ops import packed_sparse as ps

pytestmark = pytest.mark.cuda

U = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


def _packed(seed, n, d, m, device, pad_frac=0.3):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    val = rng.randn(n, m).astype(np.float32)
    pad = rng.rand(n, m) < pad_frac
    idx[pad] = 0
    val[pad] = 0.0
    return torch.as_tensor(idx).to(device), torch.as_tensor(val).to(device)


SHAPES = [  # (n, p, m, T, k): ragged rows/columns, m = 1, K = 1, K % 32
    (37, 53, 5, 1, 3),
    (8, 300, 1, 1, 1),
    (100, 700, 7, 3, 13),
    (300, 2000, 70, 2, 20),  # m above one shared-memory chunk
]


@pytest.mark.parametrize("n,p,m,T,k", SHAPES)
def test_kernels_match_plain_versions(cuda, n, p, m, T, k):
    idx, val = _packed(n, n, p, m, cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    W = torch.randn((T, p, k), generator=g, device=cuda)
    r = torch.randn((T, n, k), generator=g, device=cuda)
    before = (ps.packed_matvec.launches, ps.packed_rmatvec.launches)

    out = ps.packed_matvec(idx, val, W)
    tol = 2 * m * U * ps.packed_matvec_ref(idx, val.abs(), W.abs())
    assert bool(((out - ps.packed_matvec_ref(idx, val, W)).abs() <= tol).all())

    cols = ps.build_columns(idx, val, p)
    counts = (cols.col_ptr[1:] - cols.col_ptr[:-1]).float()
    back = ps.packed_rmatvec(idx, val, r, p, columns=cols)
    assert torch.equal(back, ps.packed_rmatvec(idx, val, r, p, columns=cols))
    tol2 = 2 * counts[None, :, None] * U * ps.packed_rmatvec_ref(
        idx, val.abs(), r.abs(), p)
    ref2 = ps.packed_rmatvec_ref(idx, val, r, p)
    assert bool(((back - ref2).abs() <= tol2).all())
    assert (ps.packed_matvec.launches, ps.packed_rmatvec.launches) == (
        before[0] + 1, before[1] + 2)


def test_strided_operands_and_vector_forms(cuda):
    """A column slice of a task batch (what the decision kernel passes)
    and the 1-D forms read through strides, no copy."""
    n, p, m = 64, 90, 6
    idx, val = _packed(1, n, p - 10, m, cuda)
    W = torch.randn((4, p, 5), device=cuda)
    view = W[:, : p - 10]
    assert not view.is_contiguous()
    torch.testing.assert_close(ps.packed_matvec(idx, val, view),
                               ps.packed_matvec_ref(idx, val, view.contiguous()))
    w1 = torch.randn(p - 10, device=cuda)
    torch.testing.assert_close(ps.packed_matvec(idx, val, w1),
                               ps.packed_matvec_ref(idx, val, w1))
    r1 = torch.randn(n, device=cuda)
    torch.testing.assert_close(ps.packed_rmatvec(idx, val, r1, p - 10),
                               ps.packed_rmatvec_ref(idx, val, r1, p - 10))


def test_autograd_backward_is_k2(cuda):
    n, p, m, T, k = 120, 400, 9, 3, 4
    idx, val = _packed(5, n, p, m, cuda)
    W = torch.randn((T, p, k), device=cuda)
    G = torch.randn((T, n, k), device=cuda)
    Wk = W.clone().requires_grad_(True)
    mv = ps.matvec_with_vjp(idx, val, p)
    before = ps.packed_rmatvec.launches
    (mv(Wk) * G).sum().backward()
    assert ps.packed_rmatvec.launches == before + 1
    Wr = W.clone().requires_grad_(True)
    (ps.packed_matvec_ref(idx, val, Wr) * G).sum().backward()
    torch.testing.assert_close(Wk.grad, Wr.grad, rtol=1e-5, atol=1e-5)
