"""The port's sparse plane (skdist_tpu_torch.sparse) against the JAX
package's: the host-side packing and routing must be identical, and the
LinearOperator's matvec/rmatvec, dense and packed, with and without the
intercept column, must agree with the JAX LinearOperator (its default
gather mode) on the same inputs.

Tolerance for the contractions: atol 1e-5 (f32 sums of at most ~20
unit-scale products in different orders); the packing is exact.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from skdist_tpu import sparse as jsx
from skdist_tpu_torch import sparse as tsx

ATOL = 1e-5


def _csr(seed, n, d, nnz_row, heavy_rows=0):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), nnz_row)
    cols = rng.randint(0, d, size=n * nnz_row)
    data = rng.randn(n * nnz_row).astype(np.float32)
    X = sp.csr_matrix((data, (rows, cols)), shape=(n, d), dtype=np.float32)
    X = X.tolil()
    for i in range(heavy_rows):
        X[i, :] = rng.randn(d).astype(np.float32)
    X[5, :] = 0  # an empty row
    X = X.tocsr()
    X.eliminate_zeros()
    return X


CSRS = [
    _csr(0, 60, 500, 6),
    _csr(1, 40, 2000, 3, heavy_rows=2),  # nnz outliers
    _csr(2, 30, 40, 10),                 # dense-competitive density
]


@pytest.mark.parametrize("X", CSRS)
def test_packing_and_routing_identical(X):
    ti, tv = tsx.pack_csr_rows(X)
    ji, jv = jsx.pack_csr_rows(X)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert tsx.pack_decision(X) == jsx.pack_decision(X)
    assert tsx.would_pack(X) == jsx.would_pack(X)
    tp, jp = tsx.pack_for_fit(X), jsx.pack_for_fit(X)
    assert (tp is None) == (jp is None)
    if tp is not None:
        np.testing.assert_array_equal(tp.idx, jp.idx)
        np.testing.assert_array_equal(tp.val, jp.val)
        assert tp.shape == jp.shape and tp.m == jp.m


def test_sparse_to_dense_matches():
    X = CSRS[0]
    np.testing.assert_array_equal(tsx.sparse_to_dense_f32(X),
                                  jsx.sparse_to_dense_f32(X))


def test_packedx_rejects_out_of_range_columns():
    idx = np.array([[0, 3]], np.int32)
    val = np.ones((1, 2), np.float32)
    with pytest.raises(ValueError):
        tsx.PackedX(idx, val, 3)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fit_intercept", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_linear_operator_matches_jax(packed, fit_intercept, k):
    X = CSRS[0]
    rng = np.random.RandomState(7 + k)
    n, d = X.shape
    p = d + int(fit_intercept)
    W = rng.randn(p, k).astype(np.float32) if k else \
        rng.randn(p).astype(np.float32)
    r = rng.randn(n, k).astype(np.float32) if k else \
        rng.randn(n).astype(np.float32)
    if packed:
        px = tsx.pack_for_fit(X)
        assert px is not None
        t_op = tsx.LinearOperator(px.to("cpu"), fit_intercept)
        j_op = jsx.LinearOperator(
            jsx.PackedX(jnp.asarray(px.idx), jnp.asarray(px.val), d),
            fit_intercept,
        )
    else:
        Xd = tsx.sparse_to_dense_f32(X)
        t_op = tsx.LinearOperator(torch.as_tensor(Xd), fit_intercept)
        j_op = jsx.LinearOperator(jnp.asarray(Xd), fit_intercept)
    assert (t_op.d, t_op.p, t_op.n) == (j_op.d, j_op.p, j_op.n)
    np.testing.assert_allclose(
        t_op.matvec(torch.as_tensor(W)).numpy(),
        np.asarray(j_op.matvec(jnp.asarray(W))), atol=ATOL,
    )
    np.testing.assert_allclose(
        t_op.rmatvec(torch.as_tensor(r)).numpy(),
        np.asarray(j_op.rmatvec(jnp.asarray(r))), atol=ATOL,
    )
    if k:
        # a task batch is the per-task contraction T times over
        Wb = torch.as_tensor(np.stack([W, 2 * W]))
        out = t_op.matvec(Wb)
        np.testing.assert_allclose(out[1].numpy(),
                                   2 * t_op.matvec(Wb[0]).numpy(), atol=ATOL)
