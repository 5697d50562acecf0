"""Histogram gradient boosting on the card: K4 at the boosting round's
Newton shapes against its plain version, a fit's K4 launches, and the
per-tree lambda's scalar form. Marked ``cuda``: they skip on a machine
without a CUDA device. On the card, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_gbdt_cuda.py

Tolerances: K4's count channel (whole numbers, the ``integer_channels``
proof) bitwise equal to the plain version; its gradient and hessian
channels within the float32 summation-order bound of every cell, ``2 * c
* u * sum|terms|`` (``c`` the cell's sample count, ``u = 2**-24``), as
chip_smoke.py's phase 5 holds K4's float cells.
"""

import numpy as np
import pytest
import torch

from skdist_tpu_torch.models.gbdt import DistHistGradientBoostingClassifier
from skdist_tpu_torch.models.tree import build_tree_kernel, newton_channels
from skdist_tpu_torch.ops import hist as kh

pytestmark = pytest.mark.cuda

U32 = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


def _newton(T, n, seed, device):
    """A boosting round's channels: sigmoid gradients and hessians of
    random margins on random 0/1 labels, under fold masks."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.sigmoid(torch.randn((T, n), generator=g, device=device))
    y = torch.randint(0, 2, (n,), generator=g, device=device).float()
    w = (torch.rand((T, n), generator=g, device=device) < 0.67).float()
    return newton_channels(p - y, p * (1 - p), w), g


@pytest.mark.parametrize("T", [1, 7, 48])
@pytest.mark.parametrize("nl", [1, 2, 4, 8, 16])
def test_k4_at_newton_shapes(cuda, T, nl):
    n, d, B = 200_000, 28, 64
    Y, g = _newton(T, n, T * 100 + nl, cuda)
    Xb = torch.randint(0, B, (n, d), generator=g, device=cuda,
                       dtype=torch.int32)
    key = torch.randint(0, nl, (T, n), generator=g, device=cuda,
                        dtype=torch.int32)
    key = torch.where(torch.any(Y != 0, dim=-1), key, nl).to(torch.int32)
    proof = kh.integer_channels(Y)
    assert proof is not None and proof.mask == 0b100  # the count channel
    out = kh.level_histogram(kh.kernel_bins(Xb, B), key, Y, nl, B,
                             integer=proof)
    ref = kh.level_histogram_ref(Xb, key, Y, nl, B)
    assert torch.equal(out[..., 2], ref[..., 2])
    cnt = ref[..., 2:3]
    tol = 2 * cnt * U32 * kh.level_histogram_ref(Xb, key, Y[..., :2].abs(),
                                                 nl, B)
    assert bool(((out[..., :2] - ref[..., :2]).abs() <= tol).all())


def test_fit_launches_and_scalar_lambda(cuda):
    rng = np.random.RandomState(0)
    X = rng.rand(20_000, 28).astype(np.float32)
    y = (X @ rng.randn(28) > 0).astype(np.int64)
    kh.level_histogram.launches = 0
    est = DistHistGradientBoostingClassifier(max_iter=30, early_stopping=True,
                                             n_iter_no_change=3,
                                             tol=1e-3).fit(X, y)
    assert kh.level_histogram.launches == est.n_iter_ * est.max_depth
    proba = est.predict_proba(X)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    # a scalar lambda gives the bits of a per-tree lambda of one value
    Y, g = _newton(4, 20_000, 7, cuda)
    Xb = torch.randint(0, 64, (20_000, 28), generator=g, device=cuda,
                       dtype=torch.int32)
    grow = build_tree_kernel(
        n_features=28, n_bins=64, channels=3, max_depth=5, max_features=28,
        min_samples_split=2, min_samples_leaf=20, min_impurity_decrease=0.0,
        extra=False, classification=False, newton=True)
    seeds = torch.zeros(4, dtype=torch.int64, device=cuda)
    scalar = grow(Xb, Y, seeds, 1.0)
    again = grow(Xb, Y, seeds, 1.0)
    per_tree = grow(Xb, Y, seeds, torch.full((4,), 1.0, device=cuda))
    if all(torch.equal(scalar[k], again[k]) for k in scalar):
        for k in scalar:
            assert torch.equal(scalar[k], per_tree[k]), k
    else:
        # K4's float cells added in another order this call: the trees
        # are held to the leaves' float32 rounding of their own magnitude
        for k in ("feat", "thr", "is_split"):
            assert torch.equal(scalar[k], per_tree[k]), k
        assert float((scalar["leaf"] - per_tree["leaf"]).abs().max()) <= \
            1e-5 * float(scalar["leaf"].abs().max())
