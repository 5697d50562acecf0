"""The layout K2 reads (skdist_tpu_torch.ops.packed_sparse.build_columns):
the column-sorted copy's segment table, and the predicate that picks the
kernels' 16-byte vector form or their scalar form.

K2 cuts each column of more than ``SEGMENT_ENTRIES`` (L) entries into
segments of at most L, sums each segment in stored order, then
sums a column's segments in segment order. These tests hold the table to
that contract on the CPU, and replay the two-level order in numpy
against the plain ``X.T @ r`` to the summation-order tolerance
2 * c * 2**-24 * sum|terms| (c = the column's entry count).
"""

import numpy as np
import pytest
import torch

from skdist_tpu_torch.ops import packed_sparse as ps

U = 2.0 ** -24


def _packed(seed, n, p, m, pad_frac=0.3, heavy=()):
    """A packed pair with padding, explicit zeros, and columns ``heavy``
    put into every row (long columns)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, p, size=(n, m)).astype(np.int32)
    val = rng.randn(n, m).astype(np.float32)
    pad = rng.rand(n, m) < pad_frac
    idx[pad] = 0
    val[pad] = 0.0
    for slot, col in enumerate(heavy):
        idx[:, slot] = col
        val[:, slot] = rng.randn(n).astype(np.float32)
    return torch.as_tensor(idx), torch.as_tensor(val)


def _segments_of(cols):
    lo, hi = cols.seg_lo.numpy(), cols.seg_hi.numpy()
    cs = cols.col_seg.numpy()
    return [list(zip(lo[cs[c]:cs[c + 1]], hi[cs[c]:cs[c + 1]]))
            for c in range(cols.n_cols)]


L = ps.SEGMENT_ENTRIES

CASES = [  # (seed, n, p, m, heavy columns), sized against L = 64
    (0, 500, 9, 5, ()),               # every column a few segments
    (1, 3000, 40, 8, (3,)),           # one column of n entries
    (2, 700, 500, 6, (499, 7)),       # the intercept (last) and a Zipf head
    (3, L, 5, 1, (0,)),               # a column of exactly L entries: not cut
    (4, 2 * L + 1, 2000, 2, (1999,)),  # 2 L + 1 entries: three segments
]


@pytest.mark.parametrize("seed,n,p,m,heavy", CASES)
def test_segments_cover_each_entry_once_in_stored_order(seed, n, p, m,
                                                        heavy):
    idx, val = _packed(seed, n, p, m, heavy=heavy)
    cols = ps.build_columns(idx, val, p)
    assert cols.col_seg.dtype == torch.int32
    assert cols.seg_lo.dtype == cols.seg_hi.dtype == torch.int64
    assert cols.col_seg.shape == (p + 1,) and int(cols.col_seg[0]) == 0
    assert int(cols.col_seg[-1]) == cols.n_segs == cols.seg_hi.shape[0]
    ptr = cols.col_ptr.numpy()
    counts = np.diff(ptr)
    covered = np.zeros(cols.nnz, dtype=int)
    for c, segs in enumerate(_segments_of(cols)):
        # only columns longer than L are cut, into ceil(count / L)
        want = -(-counts[c] // L) if counts[c] > L else 0
        assert len(segs) == want, (c, counts[c])
        if not segs:
            continue
        # consecutive, in stored order, each non-empty and at most L long
        assert segs[0][0] == ptr[c] and segs[-1][1] == ptr[c + 1]
        for (lo, hi), (lo2, _) in zip(segs, segs[1:]):
            assert hi == lo2
        for lo, hi in segs:
            assert 0 < hi - lo <= L
            covered[lo:hi] += 1
    # every entry of a long column in exactly one segment, no other entry
    expect = np.zeros(cols.nnz, dtype=int)
    for c in np.nonzero(counts > L)[0]:
        expect[ptr[c]:ptr[c + 1]] = 1
    np.testing.assert_array_equal(covered, expect)
    assert all(counts[c] > L for c in heavy if n > L)


@pytest.mark.parametrize("seed,n,p,m,heavy", CASES)
def test_two_level_sum_matches_plain_rmatvec(seed, n, p, m, heavy):
    """K2's order replayed in float32 numpy: a short column sums its
    entries in stored order, a long one its segments' in-order sums in
    segment order; both within the summation-order bound of the plain
    ``index_add_``."""
    idx, val = _packed(seed, n, p, m, heavy=heavy)
    k = 3
    r = np.random.RandomState(seed + 10).randn(n, k).astype(np.float32)
    cols = ps.build_columns(idx, val, p)
    rows, vals = cols.rows.numpy(), cols.vals.numpy()
    ptr = cols.col_ptr.numpy()

    def in_order(lo, hi):
        acc = np.zeros(k, np.float32)
        for e in range(lo, hi):
            acc = (acc + vals[e] * r[rows[e]]).astype(np.float32)
        return acc

    out = np.zeros((p, k), np.float32)
    for c, segs in enumerate(_segments_of(cols)):
        if segs:
            for lo, hi in segs:
                out[c] = out[c] + in_order(lo, hi)
        else:
            out[c] = in_order(ptr[c], ptr[c + 1])
    ref = ps.packed_rmatvec_ref(idx, val, torch.as_tensor(r), p).numpy()
    scale = ps.packed_rmatvec_ref(idx, val.abs(), torch.as_tensor(np.abs(r)),
                                  p).numpy()
    tol = 2 * np.diff(ptr)[:, None] * U * scale
    assert np.all(np.abs(out - ref) <= tol)


def test_all_empty_operator():
    idx = torch.zeros((6, 3), dtype=torch.int32)
    val = torch.zeros((6, 3))
    cols = ps.build_columns(idx, val, 10)
    assert cols.nnz == 0 and cols.n_segs == 0
    assert torch.equal(cols.col_ptr, torch.zeros(11, dtype=torch.int64))
    assert torch.equal(cols.col_seg, torch.zeros(11, dtype=torch.int32))
    r = torch.randn(6, 4)
    assert torch.equal(ps.packed_rmatvec(idx, val, r, 10), torch.zeros(10, 4))


@pytest.mark.parametrize("n", [1, L - 1, L, L + 1, 11314])
def test_single_intercept_column_of_n_rows(n):
    idx = torch.zeros((n, 1), dtype=torch.int32)
    val = torch.ones((n, 1))
    cols = ps.build_columns(idx, val, 1)
    n_segs = -(-n // L) if n > L else 0
    assert cols.n_segs == n_segs
    assert cols.col_seg.tolist() == [0, n_segs]
    if n_segs:
        assert cols.seg_lo.tolist() == list(range(0, n, L))
        assert cols.seg_hi.tolist() == [min(lo + L, n)
                                        for lo in range(0, n, L)]
    assert torch.equal(cols.rows, torch.arange(n, dtype=torch.int32))


def _aligned(shape):
    """A float32 tensor whose storage starts on a 16-byte boundary."""
    x = torch.randn(shape)
    assert x.data_ptr() % 16 == 0
    return x


@pytest.mark.parametrize("case,want", [
    ("contiguous k=20", 4),
    ("contiguous k=4, T=1", 4),
    ("row slice of an aligned batch", 4),    # W[:, 1:]: base + 80 bytes
    ("k=1 (binary)", 1),
    ("1-D operand", 1),
    ("last-axis slice, odd base", 1),        # (T, p, 21)[..., 1:]
    ("last-axis slice, 8-byte base", 1),     # (T, p, 8)[..., 2:6]
    ("k=4 under a row stride of 5", 1),      # (T, p, 5)[..., :4]
    ("k=6", 1),
    ("T=1 batch of a stride-6 buffer", 4),   # batch stride unused
    ("T=2, batch stride 4k+2", 1),
])
def test_vector_width_predicate(case, want):
    T, p = 3, 10
    x3 = {
        "contiguous k=20": lambda: _aligned((T, p, 20)),
        "contiguous k=4, T=1": lambda: _aligned((1, p, 4)),
        "row slice of an aligned batch": lambda: _aligned((T, p + 1, 20))[:, 1:],
        "k=1 (binary)": lambda: _aligned((T, p, 1)),
        "1-D operand": lambda: _aligned((p,))[None, :, None],
        "last-axis slice, odd base": lambda: _aligned((T, p, 21))[..., 1:],
        "last-axis slice, 8-byte base": lambda: _aligned((T, p, 8))[..., 2:6],
        "k=4 under a row stride of 5": lambda: _aligned((T, p, 5))[..., :4],
        "k=6": lambda: _aligned((T, p, 6)),
        "T=1 batch of a stride-6 buffer":
            lambda: _aligned((p * 4 + 2,))[: p * 4].view(1, p, 4),
        "T=2, batch stride 4k+2":
            lambda: _aligned((2 * (p * 4 + 2),)).as_strided(
                (2, p, 4), (p * 4 + 2, 4, 1)),
    }[case]()
    assert ps._vector_width(x3) == want
