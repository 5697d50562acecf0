"""K1 and K2 in per-lane row form (``packed_row_matvec``,
``packed_row_rmatvec``) against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip on a machine without a CUDA device (a
CUDA kernel has no CPU or interpret mode). On the card, without the JAX
test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_rows_cuda.py

Tolerance: integer data must equal the plain version bitwise (every sum
is exact). Fractional data: an output is a sum of c products (c = m for
the row matvec, the column's entries in the lane's batch for the row
rmatvec), and two float32 sums of the same terms in different orders
differ by at most 2 * c * 2**-24 * sum|terms|. The row rmatvec sums each
column in the plain version's order, so it also equals that version run
on the CPU (a sequential ``index_add_``) bitwise.
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


def _rows(seed, T, B, p, m, k, device, integer=False, column=None,
          pad_row=False):
    """Gathered rows (T, B, m) with padding, W (T, p, k), g (T, B, k).
    ``column``: every row holds that column (a Zipf head) in slot 0;
    ``pad_row``: row 0 of every lane is padding only."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, p, size=(T, B, m)).astype(np.int32)
    if integer:
        val = rng.randint(-3, 4, size=(T, B, m)).astype(np.float32)
        W = rng.randint(-4, 5, size=(T, p, k)).astype(np.float32)
        g = rng.randint(-4, 5, size=(T, B, k)).astype(np.float32)
    else:
        val = rng.randn(T, B, m).astype(np.float32)
        W = rng.randn(T, p, k).astype(np.float32)
        g = rng.randn(T, B, k).astype(np.float32)
    pad = rng.rand(T, B, m) < 0.3
    if pad_row:
        pad[:, 0] = True
    idx[pad] = 0
    val[pad] = 0.0
    if column is not None:
        idx[:, :, 0] = column
        val[:, :, 0] = np.where(val[:, :, 0] == 0, 1.0, val[:, :, 0])
    return tuple(torch.as_tensor(a).to(device) for a in (idx, val, W, g))


SHAPES = [  # (T, B, p, m, k)
    (1, 37, 53, 5, 3),       # one lane, B not 64
    (3, 64, 300, 1, 1),      # m = 1, k = 1
    (300, 16, 900, 7, 1),    # 300 lanes
    (4, 64, 2000, 41, 20),   # k = 20, the text's m
    (2, 300, 5000, 41, 4),   # 12300 entries a lane: sorted in chunks
]


def _check(idx, val, W, g, p, integer):
    out = ps.packed_row_matvec(idx, val, W)
    ref = ps.packed_row_matvec_ref(idx, val, W)
    back = ps.packed_row_rmatvec(idx, val, g, p)
    again = ps.packed_row_rmatvec(idx, val, g, p)
    ref2 = ps.packed_row_rmatvec_ref(idx, val, g, p)
    assert torch.equal(back, again)
    if integer:
        assert torch.equal(out, ref)
        assert torch.equal(back, ref2)
        return
    m = idx.shape[2]
    tol = 2 * m * U * ps.packed_row_matvec_ref(idx, val.abs(), W.abs())
    assert bool(((out - ref).abs() <= tol).all())
    ones = torch.ones_like(g)
    counts = ps.packed_row_rmatvec_ref(idx, (val != 0).float(), ones, p)
    tol2 = 2 * counts * U * ps.packed_row_rmatvec_ref(idx, val.abs(),
                                                      g.abs(), p)
    assert bool(((back - ref2).abs() <= tol2).all())
    cpu = ps.packed_row_rmatvec_ref(idx.cpu(), val.cpu(), g.cpu(), p)
    assert torch.equal(back.cpu(), cpu)


@pytest.mark.parametrize("T,B,p,m,k", SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_row_kernels_match_plain_versions(cuda, T, B, p, m, k, integer):
    before = (ps.packed_row_matvec.launches, ps.packed_row_rmatvec.launches)
    idx, val, W, g = _rows(T * 7 + m, T, B, p, m, k, cuda, integer=integer,
                           pad_row=True)
    _check(idx, val, W, g, p, integer)
    assert (ps.packed_row_matvec.launches, ps.packed_row_rmatvec.launches) \
        == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("column", [7, 0])
@pytest.mark.parametrize("integer", [True, False])
def test_one_column_in_every_row(cuda, column, integer):
    """The Zipf head: one column in every row of a lane's batch; and
    every entry on column 0 (padding's column too)."""
    idx, val, W, g = _rows(3, 6, 64, 400, 9, 2, cuda, integer=integer,
                           column=column)
    if column == 0:
        idx.zero_()
    _check(idx, val, W, g, 400, integer)


def test_sgd_path_shape(cuda):
    """20 lanes of 64 rows of the text's 41 entries (40 and the
    intercept) at p = 2**18 + 1, k = 1: the one-vs-rest SGD step."""
    p = 2 ** 18 + 1
    idx, val, W, g = _rows(11, 20, 64, p, 41, 1, cuda)
    idx[..., -1] = p - 1
    val[..., -1] = 1.0
    _check(idx, val, W, g, p, integer=False)


def test_shared_batch_and_slots(cuda):
    """A batch every lane shares, read through a lane stride of 0, gives
    the bits of its copies; lanes in reverse slots give the same bits."""
    idx, val, W, g = _rows(5, 1, 64, 700, 12, 3, cuda)
    T = 9
    W = torch.randn((T, 700, 3), device=cuda)
    g = torch.randn((T, 64, 3), device=cuda)
    si, sv = idx.expand(T, -1, -1), val.expand(T, -1, -1)
    ci, cv = si.contiguous(), sv.contiguous()
    assert si.stride(0) == 0
    assert torch.equal(ps.packed_row_matvec(si, sv, W),
                       ps.packed_row_matvec(ci, cv, W))
    assert torch.equal(ps.packed_row_rmatvec(si, sv, g, 700),
                       ps.packed_row_rmatvec(ci, cv, g, 700))
    idx, val, W, g = _rows(6, T, 64, 700, 12, 1, cuda)
    rev = torch.arange(T - 1, -1, -1, device=cuda)
    assert torch.equal(ps.packed_row_matvec(idx, val, W)[rev],
                       ps.packed_row_matvec(idx[rev], val[rev], W[rev]))
    assert torch.equal(ps.packed_row_rmatvec(idx, val, g, 700)[rev],
                       ps.packed_row_rmatvec(idx[rev], val[rev], g[rev], 700))


def test_bad_arguments_raise(cuda):
    idx, val, W, g = _rows(1, 2, 8, 50, 3, 2, cuda)
    with pytest.raises(TypeError):
        ps.packed_row_matvec(idx.long(), val, W)
    with pytest.raises(ValueError):
        ps.packed_row_rmatvec(idx, val, g[:1], 50)
    with pytest.raises(ValueError):
        ps.packed_row_matvec(idx, val, W.cpu())
