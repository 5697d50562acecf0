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
on the CPU (a sequential ``index_add_``) bitwise. Both kernels repeat
bitwise, and a lane's bits do not depend on its slot.
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
    (2, 300, 5000, 41, 4),   # 12300 entries a lane
    (2, 40, 700, 12, 33),    # k = 33: two chunks of j
    (2, 300, 40, 41, 4),     # 12300 entries on 40 columns: more than one
                             # block keeps at once, taken in chunks
]


def _check(idx, val, W, g, p, integer):
    out = ps.packed_row_matvec(idx, val, W)
    ref = ps.packed_row_matvec_ref(idx, val, W)
    back = ps.packed_row_rmatvec(idx, val, g, p)
    again = ps.packed_row_rmatvec(idx, val, g, p)
    ref2 = ps.packed_row_rmatvec_ref(idx, val, g, p)
    assert torch.equal(back, again)
    assert torch.equal(out, ps.packed_row_matvec(idx, val, W))
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
        == (before[0] + 2, before[1] + 2)


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


def _every_column(seed, T, B, p, m, k, device, shared):
    """Integer rows touching every column of ``p`` (``B * (m - 2) >=
    p``), so every slice edge of the row rmatvec's grid is hit whatever
    its slice width, with column 0 and column p - 1 in every row; one
    batch every lane shares (lane stride 0) with ``shared``."""
    rng = np.random.RandomState(seed)
    lanes = 1 if shared else T
    idx = np.zeros((lanes, B, m), np.int32)
    idx[:, :, 1:-1] = np.stack([rng.permutation(B * (m - 2)) % p
                                for _ in range(lanes)]).reshape(lanes, B, -1)
    idx[:, :, -1] = p - 1
    val = rng.randint(-3, 4, size=(lanes, B, m)).astype(np.float32)
    W = rng.randint(-4, 5, size=(T, p, k)).astype(np.float32)
    g = rng.randint(-4, 5, size=(T, B, k)).astype(np.float32)
    idx, val, W, g = (torch.as_tensor(a).to(device) for a in (idx, val, W, g))
    if shared:
        idx, val = idx.expand(T, -1, -1), val.expand(T, -1, -1)
    return idx, val, W, g


@pytest.mark.parametrize("T,k,shared", [
    (1, 1, False), (20, 1, False), (20, 1, True), (20, 4, False),
    (20, 4, True), (6, 20, False), (6, 20, True), (3, 33, False),
    (3, 33, True), (300, 1, False), (300, 1, True)])
def test_every_column_and_slice_edge(cuda, T, k, shared):
    """Every column of an odd n_cols (6147: not a multiple of 4 or of any
    slice width) holds entries, columns 0 and n_cols - 1 in every row;
    for each lane's own rows and for one batch shared by every lane."""
    idx, val, W, g = _every_column(T + k, T, 64, 6147, 100, k, cuda, shared)
    assert (idx.stride(0) == 0) == shared
    _check(idx, val, W, g, 6147, integer=True)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 20])
def test_lane_permutation_permutes_outputs(cuda, shared, k):
    """A random permutation of the lanes permutes both kernels' outputs
    bitwise (fractional data), for own rows and a shared batch."""
    T, p = 24, 3001
    idx, val, W, g = _rows(8, 1 if shared else T, 64, p, 41, k, cuda)
    W = torch.randn((T, p, k), device=cuda)
    g = torch.randn((T, 64, k), device=cuda)
    if shared:
        idx, val = idx.expand(T, -1, -1), val.expand(T, -1, -1)
    perm = torch.as_tensor(np.random.RandomState(1).permutation(T)).to(cuda)
    assert torch.equal(ps.packed_row_matvec(idx, val, W)[perm],
                       ps.packed_row_matvec(idx[perm], val[perm], W[perm]))
    assert torch.equal(ps.packed_row_rmatvec(idx, val, g, p)[perm],
                       ps.packed_row_rmatvec(idx[perm], val[perm], g[perm],
                                             p))


@pytest.mark.parametrize("shared", [False, True])
def test_nonfinite_g_propagates_as_in_plain_version(cuda, shared):
    """An inf or NaN in g: the padding's zero values then add NaN to
    column 0, as in the plain version (the row rmatvec leaves zero
    values out only when every g it staged is finite)."""
    T = 6
    idx, val, _W, _g = _rows(21, 1 if shared else T, 64, 300, 9, 2, cuda,
                             pad_row=True)
    if shared:
        idx, val = idx.expand(T, -1, -1), val.expand(T, -1, -1)
    g = torch.randn((T, 64, 2), device=cuda)
    g[2, 5, 1] = float("inf")
    g[4, 0, 0] = float("nan")
    back = ps.packed_row_rmatvec(idx, val, g, 300)
    ref = ps.packed_row_rmatvec_ref(idx.cpu(), val.cpu(), g.cpu(), 300)
    assert bool(ref.isnan().any())
    assert torch.equal(back.isnan().cpu(), ref.isnan())
    assert torch.equal(back.cpu().nan_to_num(0.0, 1.0, -1.0),
                       ref.nan_to_num(0.0, 1.0, -1.0))


def test_bad_arguments_raise(cuda):
    idx, val, W, g = _rows(1, 2, 8, 50, 3, 2, cuda)
    with pytest.raises(TypeError):
        ps.packed_row_matvec(idx.long(), val, W)
    with pytest.raises(ValueError):
        ps.packed_row_rmatvec(idx, val, g[:1], 50)
    with pytest.raises(ValueError):
        ps.packed_row_matvec(idx, val, W.cpu())
