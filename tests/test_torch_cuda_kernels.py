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
