"""SGD over packed sparse X on the CPU: the plain versions of K1 and K2 in
per-lane row form (``ops/packed_sparse.py packed_row_matvec_ref`` and
``packed_row_rmatvec_ref``, what a CPU tensor takes) against the JAX
package's Pallas kernels on each lane's gathered rows (interpret mode,
as the JAX package's own tests run them off-TPU), and ``SGDClassifier``
and one-vs-rest SGD over packed X against the JAX package's.

The JAX package draws its epoch orders from ``jax.random``; the parity
tests inject that stream into the port's one seam
(``utils/draws.py epoch_permutation``), as ``tests/test_torch_sgd.py``
does, so the whole algorithm is held.

Tolerances: the row forms bitwise on integer data (every sum exact),
else 1e-6 of the output's scale (at least 1):
float32 sums of at most 12 unit-scale products, in other orders, whose
values reach ~10, where one ulp is ~1e-6; fits ``n_iter_`` equal and ``coef_``/
``intercept_`` within 1e-5 of ``max|coef_|`` (the same float32 updates
in the same order, differing by the summation order of products and
batch sums); decisions 1e-5. Bitwise contracts of the port alone: a
lane's weights do not depend on its slot, and an expanded batch (one
batch every lane shares) gives the bits of its copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu.distribute.multiclass import (
    DistOneVsRestClassifier as JaxOvR,
)
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu.ops import pallas_sparse as jps
from skdist_tpu.parallel import TPUBackend
from skdist_tpu.sparse import LinearOperator as JaxLinearOperator
from skdist_tpu.sparse import PackedX as JaxPackedX
from skdist_tpu_torch.distribute.multiclass import DistOneVsRestClassifier
from skdist_tpu_torch.models import SGDClassifier
from skdist_tpu_torch.models.linear import _freeze, prepare_fit_X, to_device_X
from skdist_tpu_torch.ops import packed_sparse as tps
from skdist_tpu_torch.sparse import LinearOperator, PackedX
from skdist_tpu_torch.utils import draws

ROW_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small steps: the
    tier-1 run shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_orders(monkeypatch):
    """Inject the JAX package's epoch orders into the port (see
    ``tests/test_torch_sgd.py``)."""

    def use(max_iter):
        def orders(seed, epoch, padded, n, device=None):
            keys = jax.random.split(jax.random.PRNGKey(seed), max_iter)
            perm = np.array(jax.random.permutation(keys[epoch], padded) % n)
            return torch.as_tensor(perm, dtype=torch.int64, device=device)

        monkeypatch.setattr(draws, "epoch_permutation", orders)

    return use


def _rows_case(seed, T, B, n, p, m, k, pad_frac=0.3):
    """A packed pair of n rows (with padding), each lane's batch of B row
    indices, and per-lane operands W (T, p, k) and g (T, B, k)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, p, size=(n, m)).astype(np.int32)
    val = rng.randn(n, m).astype(np.float32)
    pad = rng.rand(n, m) < pad_frac
    idx[pad] = 0
    val[pad] = 0.0
    rows = rng.randint(0, n, size=(T, B))
    W = rng.randn(T, p, k).astype(np.float32)
    g = rng.randn(T, B, k).astype(np.float32)
    return idx, val, rows, W, g


ROW_CASES = [  # (T, B, n, p, m, k): ragged, m = 1, k = 1, one lane
    (3, 16, 40, 53, 5, 1),
    (2, 7, 30, 300, 1, 3),
    (1, 64, 100, 700, 12, 20),
    (5, 9, 20, 11, 4, 2),  # few columns: every batch repeats them
]


@pytest.mark.parametrize("T,B,n,p,m,k", ROW_CASES)
def test_row_forms_match_jax_kernels(T, B, n, p, m, k):
    idx, val, rows, W, g = _rows_case(T * 31 + m, T, B, n, p, m, k)
    ti = torch.as_tensor(idx)[torch.as_tensor(rows)]
    tv = torch.as_tensor(val)[torch.as_tensor(rows)]
    out = tps.packed_row_matvec(ti, tv, torch.as_tensor(W))
    back = tps.packed_row_rmatvec(ti, tv, torch.as_tensor(g), p)
    assert out.shape == (T, B, k) and back.shape == (T, p, k)
    for t in range(T):
        ji, jv = jnp.asarray(idx[rows[t]]), jnp.asarray(val[rows[t]])
        for got, want in (
                (out[t], jps.packed_matvec(ji, jv, jnp.asarray(W[t]),
                                           S=8, DB=128)),
                (back[t], jps.packed_rmatvec(ji, jv, jnp.asarray(g[t]), p,
                                             S=8, DB=128))):
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=ROW_ATOL * scale)


def test_row_forms_are_the_full_products_of_the_rows():
    """Each lane's row products equal K1 and K2 on its gathered rows,
    bitwise for the rmatvec (the same index_add_ order)."""
    idx, val, rows, W, g = _rows_case(5, 4, 12, 50, 80, 6, 3)
    for t in range(4):
        ti = torch.as_tensor(idx[rows[t]])
        tv = torch.as_tensor(val[rows[t]])
        lanes_i = torch.as_tensor(idx[rows])
        lanes_v = torch.as_tensor(val[rows])
        torch.testing.assert_close(
            tps.packed_row_rmatvec(lanes_i, lanes_v, torch.as_tensor(g), 80)[t],
            tps.packed_rmatvec(ti, tv, torch.as_tensor(g[t]), 80),
            rtol=0, atol=0)
        torch.testing.assert_close(
            tps.packed_row_matvec(lanes_i, lanes_v, torch.as_tensor(W))[t],
            tps.packed_matvec(ti, tv, torch.as_tensor(W[t])),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["first_last", "repeated", "shared"])
@pytest.mark.parametrize("mode", ["gather", "pallas"])
@pytest.mark.parametrize("integer", [True, False])
def test_row_plain_versions_match_jax_row_products(case, mode, integer):
    """The plain row forms, through the port's operator (``row_batch``,
    ``row_matvec``, ``row_rmatvec`` over packed X with the intercept),
    against the JAX package's ``LinearOperator.row_matvec`` /
    ``row_rmatvec`` lane by lane (its gather expressions, or its Pallas
    kernels in interpret mode), on edge shapes: entries on the first
    column and the last feature column beside the intercept; one column
    in every row; one batch every lane shares (read through a lane
    stride of 0). Integer data must agree bitwise."""
    rng = np.random.RandomState({"first_last": 1, "repeated": 2,
                                 "shared": 3}[case])
    n, d, m, T, B, k = 40, 60, 6, 4, 16, 2
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    if integer:
        val = rng.randint(-3, 4, size=(n, m)).astype(np.float32)
        W = rng.randint(-4, 5, size=(T, d + 1, k)).astype(np.float32)
        g = rng.randint(-4, 5, size=(T, B, k)).astype(np.float32)
    else:
        val = rng.randn(n, m).astype(np.float32)
        W = rng.randn(T, d + 1, k).astype(np.float32)
        g = rng.randn(T, B, k).astype(np.float32)
    pad = rng.rand(n, m) < 0.2
    idx[pad], val[pad] = 0, 0.0
    if case == "first_last":
        idx[:, 0], idx[::2, 1] = 0, d - 1
        val[:, :2] = np.where(val[:, :2] == 0, 1.0, val[:, :2])
    elif case == "repeated":
        idx[:, 0] = 7
        val[:, 0] = np.where(val[:, 0] == 0, 1.0, val[:, 0])
    if case == "shared":
        rows = torch.as_tensor(rng.randint(0, n, size=B)).expand(T, B)
    else:
        rows = torch.as_tensor(rng.randint(0, n, size=(T, B)))
    op = LinearOperator(PackedX(torch.as_tensor(idx), torch.as_tensor(val),
                                d), fit_intercept=True)
    batch = op.row_batch(rows)
    assert (batch[0].stride(0) == 0) == (case == "shared")
    out = op.row_matvec(batch, torch.as_tensor(W))
    back = op.row_rmatvec(batch, torch.as_tensor(g))
    assert out.shape == (T, B, k) and back.shape == (T, d + 1, k)
    jop = JaxLinearOperator(JaxPackedX(jnp.asarray(idx), jnp.asarray(val), d),
                            fit_intercept=True, mode=mode)
    for t in range(T):
        i = jnp.asarray(rows[t].numpy())
        for got, want in ((out[t], jop.row_matvec(i, jnp.asarray(W[t]))),
                          (back[t], jop.row_rmatvec(i, jnp.asarray(g[t])))):
            want = np.asarray(want)
            if integer:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                scale = max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=ROW_ATOL * scale)


def test_row_batch_of_packed_x():
    """``row_batch`` gathers the packed pair (intercept column included);
    a batch every lane shares is gathered once and expanded, with the
    bits of the copied block."""
    rng = np.random.RandomState(0)
    X = sp.random(50, 400, density=0.02, format="csr", random_state=rng,
                  dtype=np.float32)
    packed = prepare_fit_X(X, SGDClassifier)
    assert isinstance(packed, PackedX)
    op = LinearOperator(packed.to("cpu"), fit_intercept=True)
    one = torch.as_tensor(rng.randint(0, 50, size=16))
    shared = one.expand(3, 16)
    copied = one[None].repeat(3, 1)
    a, b = op.row_batch(shared), op.row_batch(copied)
    assert a[0].stride(0) == 0 and b[0].stride(0) != 0
    assert a[0].shape == (3, 16, packed.m + 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool((a[0][..., -1] == 400).all()) and bool((a[1][..., -1] == 1).all())
    W = torch.as_tensor(rng.randn(3, 401, 2).astype(np.float32))
    g = torch.as_tensor(rng.randn(3, 16, 2).astype(np.float32))
    assert torch.equal(op.row_matvec(a, W), op.row_matvec(b, W))
    assert torch.equal(op.row_rmatvec(a, g), op.row_rmatvec(b, g))
    dense = LinearOperator(torch.as_tensor(X.toarray()), fit_intercept=True)
    torch.testing.assert_close(op.row_matvec(a, W),
                               dense.row_matvec(dense.row_batch(shared), W),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(op.row_rmatvec(a, g),
                               dense.row_rmatvec(dense.row_batch(shared), g),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# SGDClassifier over packed X against the JAX package's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def text():
    """A small hashed-text-shaped problem the packed plane takes: Zipf
    column popularity, 8 nonzeros a row, 4 classes."""
    rng = np.random.RandomState(0)
    n, d, k = 240, 1500, 4
    pop = 1.0 / np.arange(1, d + 1)
    rng.shuffle(pop)
    cols = np.searchsorted(np.cumsum(pop / pop.sum()), rng.rand(n, 8))
    X = sp.csr_matrix(((rng.rand(n * 8) + 0.5).astype(np.float32),
                       (np.repeat(np.arange(n), 8), cols.ravel())),
                      shape=(n, d), dtype=np.float32)
    score = np.asarray(X @ rng.randn(d, k))
    y = np.argmax(score + 0.3 * rng.randn(n, k), axis=1)
    return X, y


def _assert_fit_close(port, ref):
    assert int(port.n_iter_) == int(ref.n_iter_)
    scale = np.abs(ref.coef_).max()
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(port.intercept_, ref.intercept_, rtol=0,
                               atol=1e-5 * scale)


SGD_FITS = [  # (constructor arguments, binary)
    (dict(shuffle=False), False),
    (dict(), True),
    (dict(loss="log_loss"), False),
    (dict(penalty="l1", alpha=1e-3), True),
    (dict(loss="squared_hinge", learning_rate="constant", eta0=0.01,
          class_weight="balanced"), False),
]


@pytest.mark.parametrize("kwargs,binary", SGD_FITS)
def test_packed_sgd_matches_jax_package(text, jax_orders, kwargs, binary):
    X, y = text
    if binary:
        y = (y == 1).astype(np.int64)
    kw = dict(max_iter=4, batch_size=16, tol=1e-3)
    kw.update(kwargs)
    jax_orders(kw["max_iter"])
    port = SGDClassifier(device="cpu", **kw).fit(X, y)
    ref = JaxSGD(**kw).fit(X, y)
    assert port._meta["x_format"] == "packed"
    assert ref._meta.get("x_format") == "packed"
    _assert_fit_close(port, ref)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_packed_sgd_lane_bits_do_not_depend_on_slot(text):
    X, y = text
    est = SGDClassifier(max_iter=3, batch_size=16, random_state=2)
    packed = prepare_fit_X(X, SGDClassifier)
    data_, meta = est._prep_fit_data(packed, y)
    static = _freeze(est._static_config(meta))
    op = SGDClassifier._linear_op(to_device_X(packed, "cpu"), static)
    alphas = np.logspace(-5, -2, 6).astype(np.float32)
    T, n = len(alphas), X.shape[0]
    sw = (torch.arange(n)[None] % 3 != torch.arange(T)[:, None] % 3).float()
    hyper = {"alpha": torch.as_tensor(alphas), "eta0": torch.full((T,), 0.01),
             "l1_ratio": torch.full((T,), 0.15), "tol": torch.full((T,), 1e-3)}
    kernel = SGDClassifier._build_fit_kernel(meta, static)
    rev = torch.arange(T - 1, -1, -1)
    yd = torch.as_tensor(data_["y"])
    w1 = kernel(op, yd, sw, hyper)["W"]
    w2 = kernel(op, yd, sw[rev], {k: v[rev] for k, v in hyper.items()})["W"]
    assert torch.equal(w1, w2[rev])


@pytest.mark.parametrize("loss", ["hinge", "log_loss"])
def test_ovr_sgd_on_packed_x_matches_jax_package(text, jax_orders, loss):
    X, y = text
    kw = dict(loss=loss, max_iter=3, batch_size=16, random_state=0)
    jax_orders(kw["max_iter"])
    port = DistOneVsRestClassifier(SGDClassifier(device="cpu", **kw)).fit(X, y)
    ref = JaxOvR(JaxSGD(**kw), backend=TPUBackend()).fit(X, y)
    assert port.round_stats_[0]["x_format"] == "packed"
    for a, b in zip(port.estimators_, ref.estimators_):
        assert int(a.n_iter_) == int(b._params["n_iter"])
        scale = np.abs(b.coef_).max()
        np.testing.assert_allclose(a.coef_, b.coef_, rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_allclose(port.decision_function(X),
                               ref.decision_function(X), rtol=0, atol=1e-5)
    if loss == "log_loss":
        np.testing.assert_allclose(port.predict_proba(X),
                                   ref.predict_proba(X), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    else:
        # the JAX package ranks a hinge OvR by predict_proba, which its
        # SGD refuses; the port's estimators have no predict_proba there
        # and rank by the decision, as scikit-learn does
        assert not port._has_proba()
        np.testing.assert_array_equal(
            port.predict(X),
            port.classes_[np.argmax(ref.decision_function(X), axis=1)])
