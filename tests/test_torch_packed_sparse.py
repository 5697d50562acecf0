"""The port's packed-CSR contractions (skdist_tpu_torch.ops.packed_sparse)
against the JAX package's Pallas kernels, run as the JAX package's own
tests run them off-TPU: interpret mode, S=8, DB=128.

On the CPU the port's wrappers take their plain versions (gather +
row-dot, index_add_); the CUDA kernels are held to those same plain
versions on the card by chip_smoke.py.

Tolerances: atol 1e-5, the JAX package's own pallas-vs-XLA tolerance
for these cases (f32 sums of at most 18 unit-scale products, summed in
different orders); the gradient is the same scatter-add, held to the
same atol.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skdist_tpu.ops import pallas_sparse as jps
from skdist_tpu_torch.ops import packed_sparse as tps

ATOL = 1e-5


def _packed_case(seed, n, d, m, k, pad_frac=0.3):
    """A packed pair with genuinely padded rows (idx 0 / val 0)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    val = rng.randn(n, m).astype(np.float32)
    mask = rng.rand(n, m) < pad_frac
    idx[mask] = 0
    val[mask] = 0.0
    W = rng.randn(d, k).astype(np.float32)
    r = rng.randn(n, k).astype(np.float32)
    return idx, val, W, r


CASES = [
    (37, 53, 5, 3),     # nothing aligned to any tile
    (8, 300, 1, 1),     # single packed slot, single output
    (200, 1000, 17, 20),  # the multinomial shape class
    (5, 4, 4, 2),       # d smaller than every block default
    (256, 512, 8, 4),   # exactly block-aligned
]


@pytest.mark.parametrize("n,d,m,k", CASES)
def test_plain_kernels_match_pallas(n, d, m, k):
    idx, val, W, r = _packed_case(n * 7 + k, n, d, m, k)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    ji, jv = jnp.asarray(idx), jnp.asarray(val)
    np.testing.assert_allclose(
        tps.packed_matvec(ti, tv, torch.as_tensor(W)).numpy(),
        np.asarray(jps.packed_matvec(ji, jv, jnp.asarray(W), S=8, DB=128)),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        tps.packed_rmatvec(ti, tv, torch.as_tensor(r), d).numpy(),
        np.asarray(jps.packed_rmatvec(ji, jv, jnp.asarray(r), d,
                                      S=8, DB=128)),
        atol=ATOL,
    )
    # 1-D operand forms
    np.testing.assert_allclose(
        tps.packed_matvec(ti, tv, torch.as_tensor(W[:, 0])).numpy(),
        np.asarray(jps.packed_matvec(ji, jv, jnp.asarray(W[:, 0]),
                                     S=8, DB=128)),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        tps.packed_rmatvec(ti, tv, torch.as_tensor(r[:, 0]), d).numpy(),
        np.asarray(jps.packed_rmatvec(ji, jv, jnp.asarray(r[:, 0]), d,
                                      S=8, DB=128)),
        atol=ATOL,
    )


def test_task_batch_equals_per_task_calls():
    """A (T, p, k) batch is T independent contractions in one call."""
    idx, val, _, _ = _packed_case(3, 40, 60, 6, 1)
    rng = np.random.RandomState(4)
    W = torch.as_tensor(rng.randn(3, 60, 5).astype(np.float32))
    r = torch.as_tensor(rng.randn(3, 40, 5).astype(np.float32))
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    out = tps.packed_matvec(ti, tv, W)
    back = tps.packed_rmatvec(ti, tv, r, 60)
    assert out.shape == (3, 40, 5) and back.shape == (3, 60, 5)
    for t in range(3):
        torch.testing.assert_close(out[t], tps.packed_matvec(ti, tv, W[t]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(back[t],
                                   tps.packed_rmatvec(ti, tv, r[t], 60),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 4])
def test_packed_matvec_gradient_matches_jax_vjp(k):
    """The autograd.Function's backward is the transpose, as the JAX
    custom VJP's is."""
    n, d, m = 50, 70, 6
    idx, val, W, r = _packed_case(11 + k, n, d, m, k)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    Wt = torch.as_tensor(W).requires_grad_(True)
    mv = tps.matvec_with_vjp(ti, tv, d)
    (mv(Wt) * torch.as_tensor(r)).sum().backward()

    jmv = jps.matvec_with_vjp(jnp.asarray(idx), jnp.asarray(val), d,
                              S=8, DB=128)
    jgrad = jax.grad(lambda w: jnp.sum(jmv(w) * jnp.asarray(r)))(
        jnp.asarray(W))
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(jgrad), atol=ATOL)


def test_column_copy_drops_zeros_exactly():
    """The column-sorted copy K2 reads keeps every nonzero entry, in
    row-major order within each column, and nothing else."""
    idx, val, _, _ = _packed_case(5, 30, 12, 5, 1, pad_frac=0.4)
    val[3, 1] = 0.0  # an explicit zero on a real column
    idx[4, :2] = 7   # a duplicate (row, col) pair
    cols = tps.build_columns(torch.as_tensor(idx), torch.as_tensor(val), 12)
    keep = val != 0
    assert cols.nnz == int(keep.sum())
    counts = np.bincount(idx[keep], minlength=12)
    np.testing.assert_array_equal(np.diff(cols.col_ptr.numpy()), counts)
    rows, cs = np.nonzero(keep)
    order = np.argsort(idx[rows, cs], kind="stable")
    np.testing.assert_array_equal(cols.rows.numpy(), rows[order])
    np.testing.assert_array_equal(cols.vals.numpy(), val[rows, cs][order])
    assert cols.rows.dtype == torch.int32 and cols.col_ptr.dtype == torch.int64


def test_wrappers_reject_what_the_kernels_do_not_take():
    idx, val, W, r = _packed_case(1, 6, 9, 3, 2)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    with pytest.raises(TypeError):
        tps.packed_matvec(ti.long(), tv, torch.as_tensor(W))
    with pytest.raises(TypeError):
        tps.packed_matvec(ti, tv, torch.as_tensor(W).double())
    with pytest.raises(ValueError):
        tps.packed_matvec(ti, tv[:, :2], torch.as_tensor(W))
    with pytest.raises(ValueError):
        tps.packed_rmatvec(ti, tv, torch.as_tensor(r[:5]), 9)
    with pytest.raises(ValueError):
        tps.build_columns(ti, tv, 4)  # idx holds columns >= 4
