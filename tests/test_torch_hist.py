"""The port's level histogram (skdist_tpu_torch.ops.hist) against the
JAX package's Pallas kernel (skdist_tpu.ops.pallas_hist, interpret mode
on the CPU), over the oracle cases of tests/test_pallas_hist.py, plus
the batched (T, ...) form against T unbatched calls.

On the CPU ``level_histogram`` runs its plain version (an index_add_
scatter); the CUDA kernel is held to that plain version on the card in
tests/test_torch_cuda_kernels.py.

Tolerances: atol 1e-4 for fractional channels (the two sum the same
terms in different orders: a one-hot matmul over sample chunks against
a sequential scatter); exact equality for integer channels, whose sums
are exact in float32.
"""

import numpy as np
import pytest
import torch

from skdist_tpu.ops.pallas_hist import level_histogram as jax_hist
from skdist_tpu_torch.ops.hist import level_histogram, level_histogram_ref


def _oracle(Xb, node_key, Ych, nl, B):
    n, d = Xb.shape
    hist = np.zeros((d, nl, B, Ych.shape[1]), np.float64)
    for i in range(n):
        j = node_key[i]
        if not 0 <= j < nl:
            continue
        for f in range(d):
            if 0 <= Xb[i, f] < B:
                hist[f, j, Xb[i, f]] += Ych[i]
    return hist.astype(np.float32)


def _case(n, nl, d=3, C=2, B=4, integer=False, seed=None):
    rng = np.random.RandomState(n + nl if seed is None else seed)
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    # ~1/4 of samples not at this level (key == nl sentinel)
    node_key = rng.randint(0, nl + (nl // 2 or 1), size=n).astype(np.int32)
    if integer:
        Ych = rng.randint(0, 4, size=(n, C)).astype(np.float32)
    else:
        Ych = rng.rand(n, C).astype(np.float32)
    return Xb, node_key, Ych


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("n,nl", [(37, 3), (64, 1), (130, 8)])
def test_matches_jax_kernel_and_oracle(n, nl):
    Xb, node_key, Ych = _case(n, nl)
    ours = level_histogram(*_torch(Xb, node_key, Ych), nl, 4).numpy()
    ref = np.asarray(jax_hist(Xb, node_key, Ych, nl=nl, n_bins=4,
                              interpret=True, S=32))
    assert ours.shape == (3, nl, 4, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours, _oracle(Xb, node_key, Ych, nl, 4),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,nl,B,C", [(41, 4, 8, 3), (200, 16, 32, 4)])
def test_integer_channels_exact(n, nl, B, C):
    Xb, node_key, Ych = _case(n, nl, d=5, C=C, B=B, integer=True)
    ours = level_histogram(*_torch(Xb, node_key, Ych), nl, B).numpy()
    ref = np.asarray(jax_hist(Xb, node_key, Ych, nl=nl, n_bins=B,
                              interpret=True, S=32))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, _oracle(Xb, node_key, Ych, nl, B))


def test_total_mass_excludes_sentinel():
    rng = np.random.RandomState(7)
    n, d, C, B, nl = 41, 2, 3, 8, 4
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    node_key = rng.randint(0, nl, size=n).astype(np.int32)
    node_key[::5] = nl + 3  # not at this level
    Ych = rng.rand(n, C).astype(np.float32)
    out = level_histogram(*_torch(Xb, node_key, Ych), nl, B).numpy()
    want = Ych[node_key < nl].sum(axis=0)
    for f in range(d):
        np.testing.assert_allclose(out[f].sum(axis=(0, 1)), want, rtol=1e-5)


def test_batched_equals_unbatched_calls():
    """(T, n) keys and (T, n, C) channels against T single calls;
    small bins (B=2: no TPU sublane guard) and out-of-range bins and
    keys, which add nothing."""
    rng = np.random.RandomState(3)
    T, n, d, C, B, nl = 4, 90, 3, 3, 2, 5
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    Xb[::11, 1] = B + 2
    Xb[::13, 2] = -1
    keys = rng.randint(-1, nl + 2, size=(T, n)).astype(np.int32)
    Ych = rng.rand(T, n, C).astype(np.float32)
    out = level_histogram(*_torch(Xb, keys, Ych), nl, B)
    assert out.shape == (T, d, nl, B, C)
    for t in range(T):
        one = level_histogram(*_torch(Xb, keys[t], Ych[t]), nl, B)
        torch.testing.assert_close(out[t], one, rtol=0, atol=0)
        np.testing.assert_allclose(one.numpy(),
                                   _oracle(Xb, keys[t], Ych[t], nl, B),
                                   rtol=0, atol=1e-5)
    # the CPU wrapper is the plain version, launching nothing
    torch.testing.assert_close(
        out, level_histogram_ref(*_torch(Xb, keys, Ych), nl, B),
        rtol=0, atol=0)


def test_argument_checks():
    Xb, node_key, Ych = _torch(*_case(10, 2))
    with pytest.raises(TypeError, match="int32"):
        level_histogram(Xb.long(), node_key, Ych, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        level_histogram(Xb, node_key, Ych.double(), 2, 4)
    with pytest.raises(ValueError, match="do not fit"):
        level_histogram(Xb, node_key[:5], Ych, 2, 4)


# ---------------------------------------------------------------------------
# K4's inputs: uint8 bins, its bin layout, and the proof of which channels
# are integral (the int32 cells). On the CPU the wrapper still runs the plain
# version; these hold what the wrapper accepts, checks and hands on.
# ---------------------------------------------------------------------------

from skdist_tpu_torch.ops.hist import (  # noqa: E402
    IntegerChannels, integer_channels, kernel_bins)


@pytest.mark.parametrize("n,nl,B", [(37, 3, 4), (130, 8, 16), (300, 1, 255)])
def test_uint8_bins_match_int32_and_jax_kernel(n, nl, B):
    Xb, node_key, Ych = _case(n, nl, d=4, C=3, B=B, seed=n)
    ours8 = level_histogram(torch.as_tensor(Xb.astype(np.uint8)),
                            *_torch(node_key, Ych), nl, B)
    ours32 = level_histogram(*_torch(Xb, node_key, Ych), nl, B)
    torch.testing.assert_close(ours8, ours32, rtol=0, atol=0)
    ref = np.asarray(jax_hist(Xb, node_key, Ych, nl=nl, n_bins=B,
                              interpret=True, S=32))
    np.testing.assert_allclose(ours8.numpy(), ref, rtol=0, atol=1e-4)


def test_kernel_bins_layout():
    """uint8 rows padded to 16 bytes, a bin outside [0, B) stored as 255
    (still adding nothing); at B = 256 the int32 bins themselves."""
    rng = np.random.RandomState(1)
    n, d, B, nl = 90, 21, 12, 3
    Xb = torch.as_tensor(rng.randint(0, B, size=(n, d)).astype(np.int32))
    Xb[::9, 3] = B + 5
    Xb[::11, 20] = -2
    rows = kernel_bins(Xb, B)
    assert rows.dtype == torch.uint8 and rows.shape == (n, d)
    assert rows.stride() == (32, 1)
    ok = (Xb >= 0) & (Xb < B)
    assert torch.equal(rows[ok].long(), Xb[ok].long())
    assert bool((rows[~ok] == 255).all())
    key = torch.as_tensor(rng.randint(0, nl + 1, size=(2, n)).astype(np.int32))
    Y = torch.as_tensor(rng.rand(2, n, 3).astype(np.float32))
    torch.testing.assert_close(level_histogram(rows, key, Y, nl, B),
                               level_histogram_ref(Xb, key, Y, nl, B),
                               rtol=0, atol=0)
    assert kernel_bins(Xb, 256) is Xb


def test_integer_channels_marks_whole_channels():
    rng = np.random.RandomState(2)
    Yi = torch.as_tensor(rng.randint(-2, 4, size=(3, 50, 4)).astype(
        np.float32))
    assert integer_channels(Yi).mask == 0b1111
    assert integer_channels(Yi[0]).mask == 0b1111  # unbatched (n, C)
    Ym = Yi.clone()
    Ym[1, 7, 2] = 0.5  # one fractional value takes its channel out
    assert integer_channels(Ym).mask == 0b1011
    assert integer_channels(torch.rand(2, 9, 3) + 0.25) is None
    big = torch.ones((2, 5, 2))
    big[1, :, 1] = 2.0 ** 22  # a tree's sum of 5 * 2**22 >= 2**24
    assert integer_channels(big).mask == 0b01
    with pytest.raises(TypeError, match="float32"):
        integer_channels(Yi.double())


def test_integer_keyword_is_validated():
    """The proof is checked against the tensor it was made for: another
    tensor, or the same one changed in place, is refused before anything
    runs; with a matching proof the result is the plain version's."""
    Xb, node_key, Ych = _torch(*_case(60, 3, C=3, integer=True, seed=5))
    proof = integer_channels(Ych)
    assert isinstance(proof, IntegerChannels) and proof.matches(Ych)
    torch.testing.assert_close(
        level_histogram(Xb, node_key, Ych, 3, 4, integer=proof),
        level_histogram_ref(Xb, node_key, Ych, 3, 4), rtol=0, atol=0)
    with pytest.raises(TypeError, match="IntegerChannels"):
        level_histogram(Xb, node_key, Ych, 3, 4, integer=True)
    other = Ych + 0.5  # fractional: never given this proof
    with pytest.raises(ValueError, match="another channels tensor"):
        level_histogram(Xb, node_key, other, 3, 4, integer=proof)
    Ych.add_(0.5)
    with pytest.raises(ValueError, match="changed in place"):
        level_histogram(Xb, node_key, Ych, 3, 4, integer=proof)
    with pytest.raises(TypeError, match="uint8"):
        level_histogram(Xb.to(torch.int16), node_key, Ych, 3, 4)
