"""``matmul_dtype='bfloat16'`` in the port (skdist_tpu_torch.sparse
``LinearOperator``, ``models.linear.LogisticRegression``) against its own
emulation of the contract and against the JAX package's, on the same
numpy inputs made from a seed, on the CPU.

The contract (the JAX package's): bf16 operands, float32 accumulation and
result, float32 solver state. Packed X: ``(v_bf16 * W_bf16[idx])`` in
bf16, summed in float32 over each row's entries. Dense X: the product of
the bf16-rounded operands summed in float32.

- On dyadic data whose bf16-rounded products and their sums are exact in
  float32 whatever the order, the packed matvec must equal its emulation
  and the JAX package's bitwise (the products still round: the operands'
  products carry 16 significant bits, bf16 keeps 8).
- On random data: the port and the JAX package within the summation
  order's bound (m float32 roundings of the row's absolute sum); the
  packed and dense bf16 passes within 0.02 relative of float32
  (``tests/test_pallas_sparse.py``'s agreement class).
- The dense bf16 LogisticRegression fit: its score within 1e-3 of the
  JAX package's bf16 fit and of its own float32 fit, probabilities
  within 0.05 (``tests/test_models_linear.py``'s contract).
- ``tests/test_torch_bf16_cuda.py`` runs the same expressions on the
  card and holds them to the CPU's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from skdist_tpu import sparse as jsx
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu_torch import sparse as tsx
from skdist_tpu_torch.distribute.search import DistGridSearchCV
from skdist_tpu_torch.models import LogisticRegression
from skdist_tpu_torch.ops import packed_sparse as ps
from skdist_tpu_torch.parallel import CUDABackend

U32 = 2.0 ** -24


def _packed(rng, n, d, m, dyadic):
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    if dyadic:
        # k / 16 with |k| < 256: exactly bf16
        val = (rng.randint(1, 256, size=(n, m))
               * rng.choice([-1, 1], size=(n, m)) / 16.0).astype(np.float32)
    else:
        val = rng.randn(n, m).astype(np.float32)
    val[:, -1] = 0.0  # padding entries
    idx[:, -1] = 0
    return idx, val


def _weights(rng, shape, dyadic):
    if dyadic:
        return (rng.randint(1, 256, size=shape)
                * rng.choice([-1, 1], size=shape) / 16.0).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _emulate(idx, val, W):
    """The contract in numpy: each operand and product rounded to bf16
    (through torch's rounding), the row's products summed in float64
    (exact for the dyadic data)."""
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    Wb, vb = bf(W), bf(val)
    if W.ndim == 1:
        prod = bf(vb * Wb[idx])
        return prod.astype(np.float64).sum(axis=1).astype(np.float32)
    prod = bf(vb[:, :, None] * Wb[idx])
    return prod.astype(np.float64).sum(axis=1).astype(np.float32)


def _jax_op(idx, val, d, bf16=True):
    return jsx.LinearOperator(
        jsx.PackedX(jnp.asarray(idx), jnp.asarray(val), d),
        fit_intercept=False, matmul_dtype="bfloat16" if bf16 else None)


@pytest.mark.parametrize("k", [None, 1, 5])
def test_packed_bf16_matvec_is_bitwise_the_contract(k):
    rng = np.random.RandomState(0 if k is None else k)
    n, d, m = 70, 50, 9
    idx, val = _packed(rng, n, d, m, dyadic=True)
    W = _weights(rng, (d,) if k is None else (d, k), dyadic=True)
    ours = tsx.packed_matvec_bf16(torch.as_tensor(idx), torch.as_tensor(val),
                                  torch.as_tensor(W)).numpy()
    np.testing.assert_array_equal(ours, _emulate(idx, val, W))
    theirs = np.asarray(_jax_op(idx, val, d).matvec(jnp.asarray(W)))
    np.testing.assert_array_equal(ours, theirs)
    # the products did round: float32 products give another answer
    f32 = np.asarray(ps.packed_matvec_ref(
        torch.as_tensor(idx), torch.as_tensor(val), torch.as_tensor(W)))
    assert not np.array_equal(ours, f32)
    # a task batch (T, p, k) is each lane's matvec
    if k is not None:
        Wt = np.stack([W, -W[::-1]])
        out = tsx.packed_matvec_bf16(torch.as_tensor(idx),
                                     torch.as_tensor(val),
                                     torch.as_tensor(Wt)).numpy()
        for t in range(2):
            np.testing.assert_array_equal(out[t], _emulate(idx, val, Wt[t]))


@pytest.mark.parametrize("k", [None, 3])
def test_packed_bf16_matvec_matches_jax_within_summation_order(k):
    rng = np.random.RandomState(11)
    n, d, m = 90, 120, 12
    idx, val = _packed(rng, n, d, m, dyadic=False)
    W = _weights(rng, (d,) if k is None else (d, k), dyadic=False)
    ours = tsx.packed_matvec_bf16(torch.as_tensor(idx), torch.as_tensor(val),
                                  torch.as_tensor(W)).numpy()
    theirs = np.asarray(_jax_op(idx, val, d).matvec(jnp.asarray(W)))
    # the same rounded products; only the float32 sums' order differs
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    Wb, vb = bf(W), bf(val)
    absum = (np.abs(bf(vb * Wb[idx])) if k is None
             else np.abs(bf(vb[:, :, None] * Wb[idx]))).sum(axis=1)
    np.testing.assert_array_less(np.abs(ours - theirs),
                                 m * U32 * absum + 1e-30)
    np.testing.assert_allclose(ours, _emulate(idx, val, W), rtol=0,
                               atol=float((m * U32 * absum).max()) + 1e-30)


def test_operator_bf16_agreement_class():
    """The packed and dense bf16 passes of ``LinearOperator`` (intercept
    appended) within 0.02 relative of float32, and the packed pass equal
    to :func:`packed_matvec_bf16` on the operator's own pair; the packed
    bf16 operator builds no K2 column copy (it runs no K1/K2)."""
    rng = np.random.RandomState(13)
    n, d, m, k = 80, 96, 6, 3
    X = sp.random(n, d, density=m / d, format="csr", dtype=np.float32,
                  random_state=rng)
    idx, val = tsx.pack_csr_rows(X)
    packed = tsx.PackedX(idx, val, d).to("cpu")
    W = torch.as_tensor(rng.randn(d + 1, k).astype(np.float32))
    op = tsx.LinearOperator(packed, True, matmul_dtype="bfloat16")
    out = op.matvec(W).numpy()
    np.testing.assert_array_equal(
        out, tsx.packed_matvec_bf16(op.pidx, op.pval, W).numpy())
    assert op.columns is None
    Xd = torch.as_tensor(X.toarray())
    dense = tsx.LinearOperator(Xd, True, matmul_dtype="bfloat16").matvec(
        W).numpy()
    f32 = tsx.LinearOperator(Xd, True).matvec(W).numpy()
    scale = np.maximum(1.0, np.abs(f32))
    assert np.max(np.abs(out - dense) / scale) < 0.02
    assert np.max(np.abs(out - f32) / scale) < 0.02
    assert not np.array_equal(dense, f32)
    # the JAX package's dense bf16 pass: the same exact products, float32
    # sums in another order
    jop = jsx.LinearOperator(jnp.asarray(X.toarray()), fit_intercept=True,
                             matmul_dtype="bfloat16")
    np.testing.assert_allclose(dense, np.asarray(jop.matvec(jnp.asarray(W))),
                               rtol=0, atol=1e-5)


def test_dense_bf16_operator_differentiates():
    """The dense bf16 product carries a gradient in ``W`` (the fit's
    autograd): ``X_bf16.T @ g``, rounded to bf16 like the operand."""
    rng = np.random.RandomState(3)
    X = torch.as_tensor(rng.randn(40, 7).astype(np.float32))
    op = tsx.LinearOperator(X, True, matmul_dtype="bfloat16")
    W = torch.as_tensor(rng.randn(8, 2).astype(np.float32),
                        ).requires_grad_(True)
    g = torch.as_tensor(rng.randn(40, 2).astype(np.float32))
    (op.matvec(W) * g).sum().backward()
    Xr = torch.cat([X, torch.ones(40, 1)], 1).to(torch.bfloat16).float()
    expect = (Xr.T @ g).to(torch.bfloat16).float()
    torch.testing.assert_close(W.grad, expect, rtol=0, atol=0)


def _clf_data():
    """The JAX package's ``clf_data`` fixture (tests/conftest.py)."""
    rng = np.random.RandomState(0)
    X = np.vstack([rng.normal(loc=c, scale=0.5, size=(60, 8))
                   for c in (-2.0, 0.0, 2.0)]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def test_dense_bf16_fit_matches_jax_and_f32():
    X, y = _clf_data()
    ours = LogisticRegression(max_iter=100, matmul_dtype="bfloat16",
                              device="cpu").fit(X, y)
    theirs = JaxLR(max_iter=100, matmul_dtype="bfloat16").fit(X, y)
    f32 = LogisticRegression(max_iter=100, engine="xla",
                             device="cpu").fit(X, y)
    assert not ours._resolve_host_engine()  # bf16 opts out of 'auto'
    assert abs(ours.score(X, y) - theirs.score(X, y)) <= 1e-3
    assert abs(ours.score(X, y) - f32.score(X, y)) <= 1e-3
    np.testing.assert_allclose(ours.predict_proba(X), f32.predict_proba(X),
                               atol=0.05)
    np.testing.assert_allclose(ours.predict_proba(X),
                               theirs.predict_proba(X), atol=0.05)
    with pytest.raises(ValueError, match="matmul_dtype"):
        LogisticRegression(matmul_dtype="float16")


def test_bf16_search_is_its_own_bucket_and_matches_jax():
    """bf16 rides the searches as a kernel-shaping param: a grid over
    ``matmul_dtype`` runs a bucket each; scores within 1e-3 of float32
    and of the JAX package's bf16 grid."""
    X, y = _clf_data()
    grid = {"C": [0.1, 1.0], "matmul_dtype": [None, "bfloat16"]}
    ours = DistGridSearchCV(
        LogisticRegression(max_iter=60, device="cpu"), grid, cv=3,
        scoring="accuracy", backend=CUDABackend(device="cpu")).fit(X, y)
    theirs = JaxGrid(JaxLR(max_iter=60, engine="xla"), grid, cv=3,
                     scoring="accuracy").fit(X, y)
    assert len(ours.round_stats_) == 2
    assert ours.cv_results_["params"] == theirs.cv_results_["params"]
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               theirs.cv_results_["mean_test_score"],
                               atol=1e-3)
    s = ours.cv_results_["mean_test_score"]
    np.testing.assert_allclose(s[1::2], s[0::2], atol=1e-3)


def test_packed_bf16_fit_runs_no_packed_kernel_and_tracks_f32():
    """A bf16 fit over packed X runs the gather contract: K1's and K2's
    plain versions are never called; its scores track float32's."""
    rng = np.random.RandomState(4)
    n, d = 150, 500
    rows = np.repeat(np.arange(n), 8)
    X = sp.csr_matrix(((rng.rand(n * 8) + 0.5).astype(np.float32),
                       (rows, rng.randint(0, d, n * 8))), shape=(n, d))
    y = (np.asarray(X @ rng.randn(d)) > 0).astype(int)
    calls = []
    real_mv, real_rmv = ps.packed_matvec_ref, ps.packed_rmatvec_ref

    def spy_mv(*a, **k):
        calls.append("K1")
        return real_mv(*a, **k)

    def spy_rmv(*a, **k):
        calls.append("K2")
        return real_rmv(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ps, "packed_matvec_ref", spy_mv)
    mp.setattr(ps, "packed_rmatvec_ref", spy_rmv)
    try:
        fit = LogisticRegression(max_iter=60, matmul_dtype="bfloat16",
                                 device="cpu").fit(X, y)
    finally:
        mp.undo()
    assert fit._meta["x_format"] == "packed"
    assert not calls
    f32 = LogisticRegression(max_iter=60, device="cpu").fit(X, y)
    assert abs(fit.score(X, y) - f32.score(X, y)) <= 0.02
