"""The port's streamed ridge-family (``"gram"``) and SGD (``"sgd"``) fits
over a ``ChunkedDataset`` (``skdist_tpu_torch/models/streaming.py``)
against the JAX package's streamed fits, on the CPU, on the same numpy
inputs made from a seed, and against the port's own resident fits.

Tolerances:

- ridge family: ``coef_`` within 1e-3 of max|coef_| of the JAX package's
  streamed fit and of the port's resident fit (the float32 gram sums in
  another order, and the Cholesky solve amplifies that: the ridge
  divergence ROADMAP Queue 3 records), ``score`` within 1e-5;
- SGD: within 1e-5 of max|coef_| of the JAX package's streamed fit (the
  bound of ``tests/test_torch_sgd.py``), with the same ``n_iter_``; and
  bitwise the port's resident fit for ``shuffle=False`` and blocks of
  whole batches, including early stopping, the wrap tail, a one-block
  dataset that wraps and a dataset smaller than one batch (each batch is
  the resident scan's, gathered and summed at the same shapes);
- a serial feed (``sync=True``) and the pipelined one: bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu import data as jdata
from skdist_tpu.models import LinearRegression as JaxOLS
from skdist_tpu.models import Ridge as JaxRidge
from skdist_tpu.models import RidgeClassifier as JaxRidgeClf
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu_torch.data import ChunkedDataset
from skdist_tpu_torch.models import (
    LinearRegression,
    Ridge,
    RidgeClassifier,
    SGDClassifier,
)
from skdist_tpu_torch.models.streaming import stream_fit_estimator


def _clf(n=420, d=12, k=3, seed=0, sparse=False):
    """Classes around seeded centres; ``sparse`` is a wide CSR (d=400,
    ~2% dense plus a class column), which the resident fit packs too."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    if sparse:
        X = sp.random(n, 400, density=0.02, random_state=seed, format="csr",
                      dtype=np.float32).toarray()
        X[np.arange(n), y] += 2.0
        return sp.csr_matrix(X), y
    centres = rng.normal(scale=1.5, size=(k, d))
    return (centres[y] + rng.normal(size=(n, d))).astype(np.float32), y


def _weights(n, seed=1):
    return np.random.RandomState(seed).uniform(0.2, 2.0, n).astype(
        np.float32)


def _datasets(X, y, sw, block_rows, pack):
    return (jdata.ChunkedDataset.from_arrays(X, y, sw, block_rows=block_rows,
                                             pack=pack),
            ChunkedDataset.from_arrays(X, y, sw, block_rows=block_rows,
                                       pack=pack))


def _dense(X):
    return X.toarray() if sp.issparse(X) else X


# --------------------------------------------------------------------------
# the ridge family ("gram")
# --------------------------------------------------------------------------

RIDGE = [  # (family, classes (0: a regressor), X kind, weighted)
    ("clf", 2, "dense", True),
    ("clf", 3, "packed", False),
    ("ridge", 0, "dense", False),
    ("ridge", 0, "packed", True),
    ("ols", 0, "dense", True),
]


def _ridge_models(family):
    if family == "clf":
        return JaxRidgeClf(alpha=0.5), RidgeClassifier(alpha=0.5,
                                                       device="cpu")
    if family == "ridge":
        return JaxRidge(alpha=2.0), Ridge(alpha=2.0, device="cpu")
    return JaxOLS(), LinearRegression(device="cpu")


@pytest.mark.parametrize("family,k,kind,weighted", RIDGE)
def test_streamed_ridge_matches_jax_and_resident(family, k, kind, weighted):
    X, y = _clf(k=max(k, 2), seed=k, sparse=kind == "packed")
    if not k:  # a regressor's target
        y = (_dense(X)[:, :5] @ np.arange(1.0, 6.0)).astype(np.float32)
    sw = _weights(len(y)) if weighted else None
    pack = True if kind == "packed" else None
    jds, ds = _datasets(X, y, sw, 100, pack)
    ref, ours = _ridge_models(family)
    ref.fit(jds)
    ours.fit(ds)
    resident = _ridge_models(family)[1].fit(X, y, sample_weight=sw)
    st = ours.stream_stats_
    assert (st["gram_passes"], st["gram_rounds"], st["passes"]) == (1, 1, 1)
    assert st["blocks_fed"] == ds.n_blocks
    for other in (ref, resident):
        scale = np.abs(other.coef_).max()
        np.testing.assert_allclose(ours.coef_, other.coef_, rtol=0,
                                   atol=1e-3 * scale)
        np.testing.assert_allclose(ours.intercept_, other.intercept_,
                                   rtol=0, atol=1e-3 * scale)
        assert ours.score(_dense(X), y) == pytest.approx(
            other.score(_dense(X), y), abs=1e-5)


def test_ridge_rounds_and_serial_feed(monkeypatch):
    """Lanes in rounds of the sizer's choosing give each lane's own
    solution, a pass a round, and a serial feed the pipelined one's
    bits."""
    from skdist_tpu_torch.models import streaming
    from skdist_tpu_torch.models.linear import _freeze

    X, y = _clf(k=3, sparse=True)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=128, pack=True)
    est = RidgeClassifier(device="cpu")
    y_enc, sw, meta = est._prep_stream_fit(ds, y)
    static = _freeze(est._static_config(meta))
    hyper = {"alpha": np.asarray([0.1, 1.0, 10.0], np.float32)}
    rows = {"y": y_enc, "sw": sw}
    whole = streaming.stream_fit_tasks(RidgeClassifier, meta, static, ds,
                                       rows, hyper, "cpu")
    monkeypatch.setattr(streaming, "_gram_round_lanes",
                        lambda *a: (2, 0, 0))
    stats = streaming.new_stream_stats(True)
    rounds = streaming.stream_fit_tasks(RidgeClassifier, meta, static, ds,
                                        rows, hyper, "cpu", sync=True,
                                        stats=stats)
    assert (stats["gram_rounds"], stats["gram_passes"]) == (2, 2)
    assert stats["blocks_fed"] == 2 * ds.n_blocks
    # a lane's bits depend on its round's shape (the batched gram sums
    # in another order), so rounds agree to the ridge family's tolerance
    np.testing.assert_allclose(rounds["W"], whole["W"], rtol=0,
                               atol=1e-3 * np.abs(whole["W"]).max())
    # serial = pipelined, bitwise, on dense blocks: the plain packed gram
    # (``index_put_`` with accumulate) sums in no fixed order on the CPU,
    # so over packed blocks that holds on the card (the cuda tests)
    Xd, yd = _clf(k=3)
    dsd = ChunkedDataset.from_arrays(Xd, yd, block_rows=128)
    fits = [stream_fit_estimator(RidgeClassifier(alpha=10.0, device="cpu"),
                                 dsd, sync=sync) for sync in (True, False)]
    np.testing.assert_array_equal(fits[0].coef_, fits[1].coef_)
    np.testing.assert_array_equal(fits[0].intercept_, fits[1].intercept_)


# --------------------------------------------------------------------------
# SGD ("sgd")
# --------------------------------------------------------------------------

def _sgd(**kw):
    base = dict(shuffle=False, batch_size=32, max_iter=6, tol=None,
                random_state=3)
    base.update(kw)
    return (JaxSGD(**base), SGDClassifier(device="cpu", **base))


def _same_bits(a, b):
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)
    np.testing.assert_array_equal(a.n_iter_, b.n_iter_)


SGD = [  # (X kind, classes, n, block_rows, extra settings)
    ("dense", 3, 420, 128, {}),
    ("packed", 2, 420, 96, dict(loss="log_loss", penalty="elasticnet")),
    ("dense", 2, 420, 128, dict(tol=1e-3, max_iter=40, loss="log_loss")),
    ("packed", 3, 420, 128, dict(penalty="l1", learning_rate="invscaling",
                                 eta0=0.05)),
]


@pytest.mark.parametrize("kind,k,n,block_rows,kw", SGD)
def test_streamed_sgd_matches_jax_and_is_the_resident_fit(kind, k, n,
                                                          block_rows, kw):
    X, y = _clf(n=n, k=k, seed=k, sparse=kind == "packed")
    sw = _weights(n)
    pack = True if kind == "packed" else None
    jds, ds = _datasets(X, y, sw, block_rows, pack)
    ref, ours = _sgd(**kw)
    ref.fit(jds)
    ours.fit(ds)
    _same_bits(ours, _sgd(**kw)[1].fit(X, y, sample_weight=sw))
    assert int(ours.n_iter_) == int(ref.n_iter_)
    scale = np.abs(ref.coef_).max()
    np.testing.assert_allclose(ours.coef_, ref.coef_, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ours.intercept_, ref.intercept_, rtol=0,
                               atol=1e-5 * scale)
    st = ours.stream_stats_
    assert st["epochs"] == int(ours.n_iter_) or kw.get("tol")
    assert st["steps"] == st["epochs"] * -(-n // 32)


WRAPS = [  # (n, block_rows): the wrap tail, one block that wraps, a
    # dataset smaller than one batch
    (330, 128), (300, 300), (40, 40)]


@pytest.mark.parametrize("n,block_rows", WRAPS)
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_streamed_sgd_wraps_as_the_resident_scan(n, block_rows, kind):
    X, y = _clf(n=n, k=3, seed=5, sparse=kind == "packed")
    kw = dict(batch_size=64, max_iter=4, tol=None)
    pack = True if kind == "packed" else None
    ds = ChunkedDataset.from_arrays(X, y, block_rows=block_rows, pack=pack)
    ours = _sgd(**kw)[1].fit(ds)
    _same_bits(ours, _sgd(**kw)[1].fit(X, y))
    assert ours.stream_stats_["steps"] == 4 * -(-n // 64)


def test_sgd_serial_feed_warm_start_and_shuffle():
    X, y = _clf(n=420, k=3, seed=7, sparse=True)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=128, pack=True)
    fits = [stream_fit_estimator(_sgd()[1], ds, sync=sync)
            for sync in (True, False)]
    _same_bits(*fits)
    assert [f.stream_stats_["stream_mode"] for f in fits] == [
        "serial", "pipelined"]
    warm = _sgd()[1].fit(ds, coef_init=fits[0].coef_,
                         intercept_init=fits[0].intercept_)
    _same_bits(warm, _sgd()[1].fit(X, y, coef_init=fits[0].coef_,
                                   intercept_init=fits[0].intercept_))
    # shuffled: block-local orders keyed by (seed, epoch, block), so the
    # JAX package's draws are matched only statistically
    shuffled = [SGDClassifier(batch_size=32, max_iter=6, device="cpu",
                              random_state=s).fit(ds) for s in (0, 0, 1)]
    _same_bits(shuffled[0], shuffled[1])
    assert not np.array_equal(shuffled[0].coef_, shuffled[2].coef_)
    for fit in shuffled:
        assert np.all(np.isfinite(fit.coef_))
        assert np.mean(fit.predict(ds) == y) > np.bincount(y).max() / len(y)


def test_sgd_blocks_must_hold_whole_batches():
    X, y = _clf(n=300, k=2)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=100)
    with pytest.raises(ValueError, match="divisible by batch_size"):
        SGDClassifier(batch_size=64, device="cpu").fit(ds)
    with pytest.raises(ValueError, match="balanced"):
        SGDClassifier(class_weight="balanced", device="cpu").fit(
            ChunkedDataset.from_arrays(X, y, block_rows=128))
