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
