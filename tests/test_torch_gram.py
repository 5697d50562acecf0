"""The port's weighted gram (K3's plain version, the pair table K3 reads,
``LinearOperator.weighted_gram_rhs`` and ``packed_to_dense``) against the
JAX package's: its m**2-scatter ``sparse.packed_weighted_gram`` and its
Pallas ``packed_weighted_gram`` run as the JAX package's own tests run it
off-TPU, in interpret mode at S=8, DB=64.

On the CPU the port's wrapper takes its plain version; the CUDA kernel
is held to that plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

Tolerances: integer data sums exactly in float32, so every form must
agree bitwise. Float data: atol 1e-4 against the Pallas gram (the JAX
package's own pallas-vs-XLA tolerance for this case: sums of up to ~90
unit-scale products, accumulated in MXU-block order) and 1e-5 against
the XLA scatter and for the operator pieces (the same scatter, or a
small f32 GEMM, summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skdist_tpu import sparse as jsx
from skdist_tpu.ops import pallas_sparse as jps
from skdist_tpu_torch import sparse as tsx
from skdist_tpu_torch.ops import packed_sparse as tps


def _packed(seed, n, d, m, integer=False, pad_frac=0.3):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    if integer:
        val = rng.randint(-3, 4, size=(n, m)).astype(np.float32)
        sw = rng.randint(0, 3, size=n).astype(np.float32)
    else:
        val = rng.randn(n, m).astype(np.float32)
        sw = rng.rand(n).astype(np.float32)
    pad = rng.rand(n, m) < pad_frac
    idx[pad] = 0
    val[pad] = 0.0
    return idx, val, sw


def _port_gram(idx, val, sw, d, **kw):
    return tps.packed_weighted_gram(torch.as_tensor(idx), torch.as_tensor(val),
                                    torch.as_tensor(sw), d, **kw).numpy()


@pytest.mark.parametrize("n,d,m", [(90, 70, 6), (37, 5, 1), (64, 130, 9)])
def test_plain_gram_matches_jax(n, d, m):
    idx, val, sw = _packed(n + d, n, d, m)
    got = _port_gram(idx, val, sw, d)
    ji, jv, js = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(sw)
    np.testing.assert_allclose(
        got, np.asarray(jsx.packed_weighted_gram(ji, jv, js, d)), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jps.packed_weighted_gram(ji, jv, js, d, S=8, DB=64)),
        atol=1e-4)
    # integer data: bitwise against both JAX forms
    idx, val, sw = _packed(n + d + 1, n, d, m, integer=True)
    got = _port_gram(idx, val, sw, d)
    ji, jv, js = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(sw)
    np.testing.assert_array_equal(
        got, np.asarray(jsx.packed_weighted_gram(ji, jv, js, d)))
    np.testing.assert_array_equal(
        got, np.asarray(jps.packed_weighted_gram(ji, jv, js, d, S=8, DB=64)))


def test_lane_batch_equals_loop_of_lanes():
    """A ``(T, n)`` sw is T independent grams in one call."""
    idx, val, _ = _packed(3, 50, 40, 7)
    SW = np.random.RandomState(4).rand(3, 50).astype(np.float32)
    batch = _port_gram(idx, val, SW, 40)
    assert batch.shape == (3, 40, 40)
    for t in range(3):
        np.testing.assert_array_equal(batch[t],
                                      _port_gram(idx, val, SW[t], 40))


def test_row_chunking_and_env(monkeypatch):
    """Every row chunk gives the one-shot gram (bitwise on integer data),
    and the env override sets the chunk, as in the JAX package."""
    idx, val, sw = _packed(5, 64, 48, 4, integer=True)
    ti, tv, ts = (torch.as_tensor(a) for a in (idx, val, sw))
    full = tps.packed_weighted_gram_ref(ti, tv, ts, 48, row_chunk=64)
    for chunk in (1, 7, 63, 1000):
        np.testing.assert_array_equal(
            tps.packed_weighted_gram_ref(ti, tv, ts, 48, row_chunk=chunk),
            full)
    monkeypatch.setenv(tps.GRAM_CHUNK_ENV, "9")
    assert tps._gram_row_chunk(64, 4, lanes=16) == 9
    np.testing.assert_array_equal(tps.packed_weighted_gram_ref(ti, tv, ts, 48),
                                  full)
    monkeypatch.delenv(tps.GRAM_CHUNK_ENV)
    # a budget whose 1/8 share holds 10 rows of 16 lanes' (4, 4) terms
    monkeypatch.setenv("SKDIST_DENSIFY_BUDGET_BYTES", str(8 * 10 * 16 * 4 * 4 * 4))
    assert tps._gram_row_chunk(64, 4, lanes=16) == 10


def test_pair_table_holds_each_nonzero_pair_once():
    """The table K3 reads: one entry per (row, a, b) with both values
    nonzero, cells ascending, rows ascending within a cell, and the
    values of slots a and b."""
    idx, val, _ = _packed(6, 30, 12, 5, pad_frac=0.4)
    val[3, 1] = 0.0  # an explicit zero on a real column
    idx[4, :2] = 7   # a repeated (row, col) entry
    pairs = tps.build_pairs(torch.as_tensor(idx), torch.as_tensor(val), 12)
    want = sorted(
        (idx[i, a] * 12 + idx[i, b], i, a, b)
        for i in range(30) for a in range(5) for b in range(5)
        if val[i, a] != 0 and val[i, b] != 0
    )
    assert pairs.n_pairs == len(want)
    counts = np.bincount([w[0] for w in want], minlength=144)
    np.testing.assert_array_equal(pairs.cell_key.numpy(), np.nonzero(counts)[0])
    np.testing.assert_array_equal(np.diff(pairs.cell_ptr.numpy()),
                                  counts[counts > 0])
    np.testing.assert_array_equal(pairs.rows.numpy(), [w[1] for w in want])
    np.testing.assert_array_equal(pairs.va.numpy(),
                                  [val[w[1], w[2]] for w in want])
    np.testing.assert_array_equal(pairs.vb.numpy(),
                                  [val[w[1], w[3]] for w in want])
    assert pairs.rows.dtype == torch.int32 and pairs.cell_key.dtype == torch.int64


def test_gram_wrapper_rejects_what_the_kernel_does_not_take():
    idx, val, sw = _packed(1, 6, 9, 3)
    ti, tv, ts = (torch.as_tensor(a) for a in (idx, val, sw))
    with pytest.raises(TypeError):
        tps.packed_weighted_gram(ti, tv, ts.double(), 9)
    with pytest.raises(ValueError):
        tps.packed_weighted_gram(ti, tv, ts[:5], 9)
    with pytest.raises(ValueError):
        tps.packed_weighted_gram(ti, tv, ts[None, None], 9)
    with pytest.raises(ValueError):
        tps.build_pairs(ti, tv, 4)  # idx holds columns >= 4


def test_packed_to_dense_matches_jax():
    idx, val, _ = _packed(7, 20, 15, 4)
    idx[2, :2] = 3  # duplicates accumulate, as in CSR
    got = tsx.packed_to_dense(torch.as_tensor(idx), torch.as_tensor(val), 15)
    want = jsx.packed_to_dense(jnp.asarray(idx), jnp.asarray(val), 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["dense", "packed"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_weighted_gram_rhs_matches_jax(form, fit_intercept):
    n, d, m, k = 80, 30, 5, 3
    idx, val, _ = _packed(8, n, d, m)
    rng = np.random.RandomState(9)
    sw = rng.rand(n).astype(np.float32)
    T = rng.randn(n, k).astype(np.float32)
    if form == "packed":
        tX = tsx.PackedX(torch.as_tensor(idx), torch.as_tensor(val), d)
        jX = jsx.PackedX(jnp.asarray(idx), jnp.asarray(val), d)
    else:
        dense = np.array(jsx.packed_to_dense(jnp.asarray(idx),
                                             jnp.asarray(val), d))
        tX, jX = torch.as_tensor(dense), jnp.asarray(dense)
    top = tsx.LinearOperator(tX, fit_intercept)
    jop = jsx.LinearOperator(jX, fit_intercept)
    G, b = top.weighted_gram_rhs(torch.as_tensor(sw), torch.as_tensor(T))
    jG, jb = jop.weighted_gram_rhs(jnp.asarray(sw), jnp.asarray(T))
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-5)
    # a lane batch: each lane is the one-lane call
    SW = rng.rand(2, n).astype(np.float32)
    GB, bB = top.weighted_gram_rhs(torch.as_tensor(SW), torch.as_tensor(T))
    assert GB.shape == (2, top.p, top.p) and bB.shape == (2, top.p, k)
    for t in range(2):
        G1, b1 = top.weighted_gram_rhs(torch.as_tensor(SW[t]),
                                       torch.as_tensor(T))
        np.testing.assert_allclose(GB[t].numpy(), G1.numpy(), atol=1e-5)
        np.testing.assert_allclose(bB[t].numpy(), b1.numpy(), atol=1e-5)
    assert top.gram_pairs() is None  # no table off the card
