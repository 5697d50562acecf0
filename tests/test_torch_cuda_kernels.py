"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip on a machine without a CUDA device (a
CUDA kernel has no CPU or interpret mode). On the card, without the JAX
test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerance: an output is a sum of c products (c = m for K1, the column's
entry count for K2, the cell's pair count for K3); two float32 sums of
the same terms in different orders differ by at most
2 * c * 2**-24 * sum|terms|.
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


def _segmented(seed, n, p, m, device):
    """Entries on columns [0, 100) only (an empty stretch many K2 tiles
    wide up to p - 1), column 7 in every third row and column p - 1 (an
    intercept) in every row: both cut into many K2 segments."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 100, size=(n, m)).astype(np.int32)
    idx[:, 0] = p - 1
    idx[::3, 1] = 7
    val = rng.randn(n, m).astype(np.float32)
    return torch.as_tensor(idx).to(device), torch.as_tensor(val).to(device)


def _zipf(seed, n, d, m, device):
    """Hashed-text-like rows: Zipf column popularity plus an intercept
    column d, as the LogReg path packs them."""
    rng = np.random.RandomState(seed)
    pop = 1.0 / np.arange(1, d + 1)
    rng.shuffle(pop)
    idx = np.searchsorted(np.cumsum(pop / pop.sum()), rng.rand(n, m - 1))
    idx = np.minimum(idx, d - 1).astype(np.int32)
    val = (rng.rand(n, m - 1) + 0.5).astype(np.float32)
    idx = np.concatenate([idx, np.full((n, 1), d, np.int32)], 1)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    return torch.as_tensor(idx).to(device), torch.as_tensor(val).to(device)


def _ridge_rhs(pair, n, T, k, g, device):
    """K2's operand on the ridge path, sw[..., None] * Y with Y the +-1
    targets: sw the grid's 0/1 fold masks ("ridge masks") or fractional
    weights ("ridge weights"), one lane a row."""
    y = torch.randint(0, k, (n,), generator=g, device=device)
    Y = torch.where(y[:, None] == torch.arange(k, device=device), 1.0, -1.0)
    if pair == "ridge masks":
        fold = torch.arange(n, device=device) * 5 // n
        lane = torch.arange(T, device=device) % 5
        sw = (fold[None] != lane[:, None]).float()
    else:
        sw = torch.rand((T, n), generator=g, device=device)
    return sw[..., None] * Y


BRANCH_CASES = [  # (pair, n, p, m, T, k, sliced)
    ("random", 3000, 40, 8, 5, 20, False),      # ~480 entries a column
    ("segmented", 2000, 5000, 6, 7, 8, False),  # segments, empty stretch
    ("segmented", 2000, 5000, 6, 6, 20, True),  # vector form ruled out
    ("segmented", 2000, 5000, 6, 96, 1, False),  # the binary path's k, T
    ("segmented", 300, 5000, 6, 2, 300, True),  # k past one block's lanes
    ("zipf", 11314, 2**16 + 1, 41, 8, 20, False),
    ("zipf", 11314, 2**16 + 1, 41, 96, 1, False),
    ("ridge masks", 11314, 2**14 + 1, 41, 60, 20, False),  # a ridge round
    ("ridge weights", 11314, 2**14 + 1, 41, 60, 20, False),
]


@pytest.mark.parametrize("pair,n,p,m,T,k,sliced", BRANCH_CASES)
def test_kernels_at_each_branch_of_their_design(cuda, pair, n, p, m, T, k,
                                                sliced):
    """K1, K2 and the PackedMatvec gradient against their plain versions
    where K2 cuts columns into segments, skips empty tiles, and where the
    operands' layout picks the scalar form, and at a ridge round, whose
    K2 operand is weighted +-1 targets; K2 bitwise repeatable. The
    "ridge" pairs are hashed-text rows like "zipf"."""
    if pair == "random":
        idx, val = _packed(n, n, p, m, cuda)
    elif pair == "segmented":
        idx, val = _segmented(n, n, p, m, cuda)
    else:
        idx, val = _zipf(n, n, p - 1, m, cuda)
    extra = 1 if sliced else 0
    g = torch.Generator(device=cuda).manual_seed(T * k)
    W = torch.randn((T, p, k + extra), generator=g, device=cuda)[..., extra:]
    r = torch.randn((T, n, k + extra), generator=g, device=cuda)[..., extra:]
    if pair.startswith("ridge"):
        r = _ridge_rhs(pair, n, T, k, g, cuda)
    want = 4 if (k % 4 == 0 and not sliced) else 1
    assert ps._vector_width(W) == ps._vector_width(r) == want

    out = ps.packed_matvec(idx, val, W)
    tol = 2 * m * U * ps.packed_matvec_ref(idx, val.abs(), W.abs())
    assert bool(((out - ps.packed_matvec_ref(idx, val, W)).abs() <= tol).all())

    cols = ps.build_columns(idx, val, p)
    assert cols.n_segs > 0
    counts = (cols.col_ptr[1:] - cols.col_ptr[:-1]).float()
    back = ps.packed_rmatvec(idx, val, r, p, columns=cols)
    assert torch.equal(back, ps.packed_rmatvec(idx, val, r, p, columns=cols))
    tol2 = 2 * counts[None, :, None] * U * ps.packed_rmatvec_ref(
        idx, val.abs(), r.abs(), p)
    assert bool(((back - ps.packed_rmatvec_ref(idx, val, r, p)).abs()
                 <= tol2).all())

    Wk = W.detach().clone().requires_grad_(True)
    (ps.PackedMatvec.apply(Wk, idx, val, cols) * r).sum().backward()
    Wr = W.detach().clone().requires_grad_(True)
    (ps.packed_matvec_ref(idx, val, Wr) * r).sum().backward()
    assert bool(((Wk.grad - Wr.grad).abs() <= tol2).all())


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


# ---------------------------------------------------------------------------
# K4: the level histogram. Integer channels sum exactly in float32, so the
# kernel must equal its plain version bitwise and repeat bitwise;
# fractional channels are held to 2 * c * 2**-24 * sum|terms| with c the
# sample count.
# ---------------------------------------------------------------------------

from skdist_tpu_torch.ops import hist as kh  # noqa: E402

HIST_SHAPES = [  # (T, n, d, nl, B, C): ragged n, sentinel keys, B up to 256
    (1, 37, 3, 3, 4, 2),
    (3, 1000, 5, 1, 32, 3),
    (2, 5003, 7, 128, 32, 4),
    (4, 3001, 3, 3, 256, 3),
]


def _hist_inputs(cuda, T, n, d, nl, B, C, integer, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    Xb = torch.randint(0, B, (n, d), generator=g, device=cuda,
                       dtype=torch.int32)
    key = torch.randint(0, nl + max(1, nl // 2), (T, n), generator=g,
                        device=cuda, dtype=torch.int32)
    if integer:
        Y = torch.randint(0, 3, (T, n, C), generator=g, device=cuda).float()
    else:
        Y = torch.rand((T, n, C), generator=g, device=cuda)
    return Xb, key, Y


@pytest.mark.parametrize("T,n,d,nl,B,C", HIST_SHAPES)
def test_level_histogram_matches_plain_version(cuda, T, n, d, nl, B, C):
    before = kh.level_histogram.launches
    for integer in (True, False):
        Xb, key, Y = _hist_inputs(cuda, T, n, d, nl, B, C, integer, n)
        XbF = Xb.t().contiguous().t()  # the feature-major layout trees use
        out = kh.level_histogram(XbF, key, Y, nl, B)
        again = kh.level_histogram(Xb, key, Y, nl, B)
        ref = kh.level_histogram_ref(Xb, key, Y, nl, B)
        if integer:
            assert torch.equal(out, ref) and torch.equal(again, out)
        else:
            tol = 2 * n * U * kh.level_histogram_ref(Xb, key, Y.abs(), nl, B)
            assert bool(((out - ref).abs() <= tol).all())
            assert bool(((again - ref).abs() <= tol).all())
    assert kh.level_histogram.launches == before + 4
    one = kh.level_histogram(Xb, key[0], Y[0], nl, B)  # unbatched form
    assert one.shape == (d, nl, B, C)


def _hist_layouts(Xb, B):
    """The bin layouts K4 takes: uint8 rows padded to 16 bytes (what trees
    pass: 16-byte loads), unpadded uint8 rows, feature-major uint8, int32
    rows and an int32 view sliced out of a wider array."""
    out = {"int32 rows": Xb}
    if B <= 255:
        out["uint8 rows padded"] = kh.kernel_bins(Xb, B)
        u8 = torch.where((Xb >= 0) & (Xb < B), Xb, 255).to(torch.uint8)
        out["uint8 rows"] = u8
        out["uint8 feature-major"] = u8.t().contiguous().t()
    wide = torch.zeros((Xb.shape[0], Xb.shape[1] + 3), dtype=torch.int32,
                       device=Xb.device)
    wide[:, 2:2 + Xb.shape[1]] = Xb
    out["int32 sliced"] = wide[:, 2:2 + Xb.shape[1]]
    return out


def _hold_hist(Xs, Xb, key, Y, nl, B, proof):
    """K4 with ``proof`` against the plain version: channels of whole
    numbers bitwise equal and repeatable, the rest within 2 * c * u *
    sum|terms|."""
    out = kh.level_histogram(Xs, key, Y, nl, B, integer=proof)
    again = kh.level_histogram(Xs, key, Y, nl, B, integer=proof)
    ref = kh.level_histogram_ref(Xb, key, Y, nl, B)
    whole = kh.integer_channels(Y)
    mask = whole.mask if whole is not None else 0
    for c in range(Y.shape[-1]):
        if mask >> c & 1:
            assert torch.equal(out[..., c], ref[..., c])
            assert torch.equal(again[..., c], ref[..., c])
        else:
            cnt = kh.level_histogram_ref(Xb, key, torch.ones_like(Y[..., :1]),
                                         nl, B)[..., 0]
            tol = 2 * cnt * U * kh.level_histogram_ref(
                Xb, key, Y[..., c:c + 1].abs(), nl, B)[..., 0]
            assert bool(((out[..., c] - ref[..., c]).abs() <= tol).all())
            assert bool(((again[..., c] - ref[..., c]).abs() <= tol).all())


HIST_BRANCHES = {  # label: (T, n, d, nl, B, C, node every key is on)
    "copies, one node of nl=1, chunked flush": (2, 70001, 28, 1, 32, 3, 0),
    "copies, one node of nl=2, chunked flush": (2, 70001, 28, 2, 32, 3, 1),
    "every feature, node blocks": (2, 20011, 3, 128, 256, 4, None),
    "feature groups, every node": (2, 20011, 60, 2, 256, 4, None),
    "one feature, node blocks (B=256, C=4, nl=128)": (2, 20011, 60, 128, 256,
                                                      4, None),
    "11 channels": (3, 3001, 4, 5, 16, 11, None),
    "ragged, bins outside [0, B)": (3, 5003, 7, 128, 32, 3, None),
}


@pytest.mark.parametrize("channels", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("branch", list(HIST_BRANCHES))
def test_level_histogram_branches(cuda, branch, channels):
    """Each branch of K4's design, in every bin layout it takes: integer
    channels through int32 cells (with the proof), fractional through
    float cells, mixed (channel 0 fractional) through both in one tile."""
    T, n, d, nl, B, C, node = HIST_BRANCHES[branch]
    g = torch.Generator(device=cuda).manual_seed(n + d + C)
    Xb = torch.randint(0, B, (n, d), generator=g, device=cuda,
                       dtype=torch.int32)
    if branch.startswith("ragged"):
        Xb[::7, 0] = B + 3
        Xb[::5, 1] = -1
    if node is None:
        key = torch.randint(0, nl + max(1, nl // 2), (T, n), generator=g,
                            device=cuda, dtype=torch.int32)
    else:
        key = torch.full((T, n), node, dtype=torch.int32, device=cuda)
    Yi = torch.randint(0, 3, (T, n, C), generator=g, device=cuda).float()
    Yf = torch.rand((T, n, C), generator=g, device=cuda)
    Y = {"integer": Yi, "fractional": Yf}.get(channels)
    if Y is None:
        Y = Yi.clone()
        Y[..., 0] = Yf[..., 0]
    proof = kh.integer_channels(Y)
    assert (proof is None) == (channels == "fractional")
    before = kh.level_histogram.launches
    layouts = _hist_layouts(Xb, B)
    for Xs in layouts.values():
        _hold_hist(Xs, Xb, key, Y, nl, B, proof)
    assert kh.level_histogram.launches == before + 2 * len(layouts)


def test_level_histogram_integer_path_refuses_fractional_channels(cuda):
    """A fractional Ych never takes the integer path: it gets no proof
    (or a proof for its whole channels only), and a proof made for other
    channels, or for these before an in-place change, is refused before
    any launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    T, n, d, nl, B, C = 2, 3001, 5, 4, 32, 3
    Xb = torch.randint(0, B, (n, d), generator=g, device=cuda,
                       dtype=torch.int32)
    key = torch.randint(0, nl, (T, n), generator=g, device=cuda,
                        dtype=torch.int32)
    Yi = torch.randint(0, 3, (T, n, C), generator=g, device=cuda).float()
    Yf = Yi * 0.75 + 0.125
    assert kh.integer_channels(Yf) is None
    proof = kh.integer_channels(Yi)
    before = kh.level_histogram.launches
    with pytest.raises(ValueError, match="another channels tensor"):
        kh.level_histogram(Xb, key, Yf, nl, B, integer=proof)
    Yi[0, 0, 0] += 0.5
    with pytest.raises(ValueError, match="changed in place"):
        kh.level_histogram(Xb, key, Yi, nl, B, integer=proof)
    with pytest.raises(TypeError, match="IntegerChannels"):
        kh.level_histogram(Xb, key, Yf, nl, B, integer=True)
    assert kh.level_histogram.launches == before
    Ym = Yi.clone()  # channel 0 now holds a fraction: only 1 and 2 proven
    assert kh.integer_channels(Ym).mask == 0b110
    _hold_hist(kh.kernel_bins(Xb, B), Xb, key, Ym, nl, B,
               kh.integer_channels(Ym))


def test_small_forest_on_card_equals_cpu(cuda):
    """Same seeds on the card and on the CPU: the shared counter-hash
    draws and the exact integer histograms grow the same forest."""
    from skdist_tpu_torch.distribute.ensemble import DistRandomForestClassifier

    rng = np.random.RandomState(0)
    X = rng.rand(2000, 10).astype(np.float32)
    y = (X[:, 0] + X[:, 1] + 0.3 * rng.randn(2000) > 1).astype(int)
    kw = dict(n_estimators=16, max_depth=6, random_state=0)
    before = kh.level_histogram.launches
    card = DistRandomForestClassifier(**kw).fit(X, y)
    assert kh.level_histogram.launches == before + 6  # one per level
    cpu = DistRandomForestClassifier(device="cpu", **kw).fit(X, y)
    for k in ("feat", "thr", "is_split", "seed"):
        np.testing.assert_array_equal(card._trees[k], cpu._trees[k])
    np.testing.assert_allclose(card.predict_proba(X), cpu.predict_proba(X),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# K3: the weighted gram. Each term is the plain version's term bitwise, so
# integer data must give the plain version's gram exactly; fractional
# data is held to 2 * c * 2**-24 * sum|terms| with c the cell's pair
# count; two launches are bitwise equal.
# ---------------------------------------------------------------------------

GRAM_SHAPES = [  # (n, p, m, T): n off every chunk, p odd, m = 1 and 70
    (37, 53, 7, 1),
    (1001, 301, 1, 3),
    (299, 1001, 70, 3),
    (500, 9, 7, 1),  # few columns: long cells, many repeats in a row
]


def _gram_inputs(cuda, n, p, m, T, integer, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, p, size=(n, m)).astype(np.int32)
    if integer:
        val = rng.randint(-3, 4, size=(n, m)).astype(np.float32)
        sw = rng.randint(0, 4, size=(T, n)).astype(np.float32)
    else:
        val = rng.randn(n, m).astype(np.float32)
        sw = rng.rand(T, n).astype(np.float32)
    pad = rng.rand(n, m) < 0.3
    idx[pad] = 0
    val[pad] = 0.0
    idx[1], val[1] = 0, 0.0  # an empty row
    if m > 1:
        idx[2, 1] = idx[2, 0]  # a repeated (row, col) entry
    return (torch.as_tensor(idx).to(cuda), torch.as_tensor(val).to(cuda),
            torch.as_tensor(sw).to(cuda))


@pytest.mark.parametrize("n,p,m,T", GRAM_SHAPES)
def test_weighted_gram_matches_plain_version(cuda, n, p, m, T):
    before = ps.packed_weighted_gram.launches
    for integer in (True, False):
        idx, val, sw = _gram_inputs(cuda, n, p, m, T, integer, n + m)
        pairs = ps.build_pairs(idx, val, p)
        out = ps.packed_weighted_gram(idx, val, sw, p, pairs=pairs)
        again = ps.packed_weighted_gram(idx, val, sw, p)  # builds its table
        ref = ps.packed_weighted_gram_ref(idx, val, sw, p)
        assert out.shape == (T, p, p) and torch.equal(again, out)
        if integer:
            assert torch.equal(out, ref)
        else:
            count = ps.packed_weighted_gram_ref(
                idx, (val != 0).float(), torch.ones_like(sw), p)
            tol = 2 * count * U * ps.packed_weighted_gram_ref(
                idx, val.abs(), sw.abs(), p)
            assert bool(((out - ref).abs() <= tol).all())
        one = ps.packed_weighted_gram(idx, val, sw[0], p, pairs=pairs)
        assert torch.equal(one, out[0])  # the unbatched form
    assert ps.packed_weighted_gram.launches == before + 6


def test_small_ridge_classifier_on_card_equals_cpu(cuda):
    """A well-conditioned packed ridge fit (n > p, alpha = 1) through K3,
    K2 and cuSOLVER on the card against the same fit on the CPU. They
    differ by summation order only, in the gram and in the factorisation;
    with a gram condition number in the hundreds that moves coef_ by far
    less than 1e-4 of max|coef_|."""
    import scipy.sparse as sp

    from skdist_tpu_torch.models import RidgeClassifier

    rng = np.random.RandomState(0)
    X = sp.random(3000, 400, density=0.02, format="csr", random_state=rng,
                  dtype=np.float32)
    y = rng.randint(0, 4, size=3000)
    before = ps.packed_weighted_gram.launches
    card = RidgeClassifier(alpha=1.0).fit(X, y)
    assert ps.packed_weighted_gram.launches == before + 1
    cpu = RidgeClassifier(alpha=1.0, device="cpu").fit(X, y)
    assert card._meta["x_format"] == "packed"
    scale = float(np.abs(cpu.coef_).max())
    np.testing.assert_allclose(card.coef_, cpu.coef_, rtol=0,
                               atol=1e-4 * scale)
    dec = cpu.decision_function(X)
    np.testing.assert_allclose(card.decision_function(X), dec, rtol=0,
                               atol=1e-4 * float(np.abs(dec).max()))
