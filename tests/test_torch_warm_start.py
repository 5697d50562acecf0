"""Warm start (``fit(..., coef_init=, intercept_init=)``) in the port's
linear models against the JAX package's, on the same numpy inputs made
from a seed, on the CPU.

Both packages start their solves at the same seed (scikit-learn's shapes
mapped onto the flat solver layout) and run the same iterations: the
L-BFGS families from a perturbed optimum for a few iterations, SGD
unshuffled for a few epochs, the host engine to convergence; ``coef_``
agrees within 1e-5. A seed at the optimum stops the solve at once. The
ridge family accepts a seed and ignores it. The shape errors and their
messages are the JAX package's.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import RidgeClassifier as JaxRC
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu_torch.models import (
    LinearSVC,
    LogisticRegression,
    RidgeClassifier,
    SGDClassifier,
)

COEF_ATOL = 1e-5


def _data(k, seed=0, n=160, d=10, sparse=False):
    rng = np.random.RandomState(seed + k)
    if sparse:
        dd = 200
        rows = np.repeat(np.arange(n), 6)
        X = sp.csr_matrix(((rng.rand(n * 6) + 0.5).astype(np.float32),
                           (rows, rng.randint(0, dd, n * 6))), shape=(n, dd))
        score = np.asarray(X @ rng.randn(dd, k))
    else:
        X = rng.randn(n, d).astype(np.float32)
        score = X @ rng.randn(d, k)
    y = np.argmax(score + 0.5 * rng.randn(n, k), axis=1)
    return X, y


def _seed(ref, rng):
    """A parent fit's coef_/intercept_, perturbed (a drifted refit)."""
    coef = np.asarray(ref.coef_, np.float32)
    b = np.asarray(ref.intercept_, np.float32)
    return (coef + 0.05 * rng.randn(*coef.shape).astype(np.float32),
            b + 0.05 * rng.randn(*b.shape).astype(np.float32))


FAMILIES = {
    "lr": (lambda **k: JaxLR(engine="xla", **k),
           lambda **k: LogisticRegression(engine="xla", device="cpu", **k),
           dict(C=0.5, max_iter=5, tol=1e-8)),
    "svc": (lambda **k: JaxSVC(engine="xla", **k),
            lambda **k: LinearSVC(engine="xla", device="cpu", **k),
            dict(C=0.03, max_iter=5, tol=1e-8)),
    "sgd": (lambda **k: JaxSGD(**k),
            lambda **k: SGDClassifier(device="cpu", **k),
            dict(loss="log_loss", max_iter=3, shuffle=False, tol=None,
                 alpha=1e-3)),
    "host": (lambda **k: JaxLR(engine="host", **k),
             lambda **k: LogisticRegression(engine="host", device="cpu",
                                            **k),
             dict(C=0.5, max_iter=200)),
}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_warm_start_matches_jax(family, k):
    make_jax, make_port, kw = FAMILIES[family]
    X, y = _data(k, seed=3)
    parent = make_jax(**kw).fit(X, y)
    coef, b = _seed(parent, np.random.RandomState(k))
    theirs = make_jax(**kw).fit(X, y, coef_init=coef, intercept_init=b)
    ours = make_port(**kw).fit(X, y, coef_init=coef, intercept_init=b)
    assert ours.coef_.shape == theirs.coef_.shape
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0,
                               atol=COEF_ATOL)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0,
                               atol=COEF_ATOL)
    np.testing.assert_array_equal(np.max(ours.n_iter_),
                                  np.max(theirs.n_iter_))
    cold = make_port(**kw).fit(X, y)
    assert not np.allclose(ours.coef_, cold.coef_, atol=COEF_ATOL)
    assert not hasattr(ours, "_warm_w0")  # scoped to the one fit


def test_warm_start_packed_matches_jax():
    """Over packed X the seeded L-BFGS runs K1/K2's plain versions."""
    X, y = _data(3, seed=4, sparse=True)
    kw = dict(C=0.5, max_iter=5, tol=1e-8)
    parent = JaxLR(engine="xla", **kw).fit(X, y)
    coef, b = _seed(parent, np.random.RandomState(0))
    theirs = JaxLR(engine="xla", **kw).fit(X, y, coef_init=coef,
                                           intercept_init=b)
    ours = LogisticRegression(device="cpu", **kw).fit(
        X, y, coef_init=coef, intercept_init=b)
    assert ours._meta["x_format"] == "packed"
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0,
                               atol=COEF_ATOL)


@pytest.mark.parametrize("engine", ["xla", "host"])
def test_seed_at_the_optimum_stops_at_once(engine):
    """A converged fit's own coefficients as the seed: the refit stops
    well before ``max_iter`` with ``coef_`` within solver tolerance."""
    X, y = _data(3, seed=5)
    cold = LogisticRegression(engine=engine, device="cpu", C=0.5,
                              max_iter=300, tol=1e-3).fit(X, y)
    warm = LogisticRegression(engine=engine, device="cpu", C=0.5,
                              max_iter=300, tol=1e-3).fit(
        X, y, coef_init=cold.coef_, intercept_init=cold.intercept_)
    assert int(cold.n_iter_) < 300
    assert int(warm.n_iter_) <= max(2, int(cold.n_iter_) // 4)
    np.testing.assert_allclose(warm.coef_, cold.coef_, rtol=0, atol=1e-2)


def test_ridge_accepts_and_ignores_the_seed():
    X, y = _data(3, seed=6)
    cold = RidgeClassifier(alpha=2.0, device="cpu").fit(X, y)
    seeded = RidgeClassifier(alpha=2.0, device="cpu").fit(
        X, y, coef_init=np.ones_like(cold.coef_),
        intercept_init=np.ones_like(cold.intercept_))
    np.testing.assert_array_equal(seeded.coef_, cold.coef_)
    ref = JaxRC(alpha=2.0).fit(X, y, coef_init=np.ones_like(cold.coef_))
    np.testing.assert_allclose(seeded.coef_, ref.coef_, rtol=0, atol=1e-4)


def _messages(make, X, y, **fit_kw):
    with pytest.raises(ValueError) as exc:
        make().fit(X, y, **fit_kw)
    return str(exc.value)


@pytest.mark.parametrize("engine", ["xla", "host"])
def test_shape_errors_match_jax(engine):
    X, y3 = _data(3, seed=7)
    y2 = (y3 > 0).astype(int)
    cases = [
        (y2, {"coef_init": np.zeros(X.shape[1] + 1)}),
        (y3, {"coef_init": np.zeros((2, X.shape[1]))}),
        (y3, {"intercept_init": np.zeros(2)}),
    ]
    for y, fit_kw in cases:
        ours = _messages(lambda: LogisticRegression(engine=engine,
                                                    device="cpu"),
                         X, y, **fit_kw)
        theirs = _messages(lambda: JaxLR(engine=engine), X, y, **fit_kw)
        assert ours == theirs
    ours = _messages(
        lambda: LogisticRegression(engine=engine, device="cpu",
                                   fit_intercept=False),
        X, y3, intercept_init=np.ones(3))
    theirs = _messages(lambda: JaxLR(engine=engine, fit_intercept=False),
                       X, y3, intercept_init=np.ones(3))
    assert ours == theirs and "fit_intercept=False" in ours
    # the (d, k) layout and a scalar intercept broadcast are accepted
    coef = np.zeros((X.shape[1], 3), np.float32)
    fit = LogisticRegression(engine=engine, device="cpu", max_iter=5).fit(
        X, y3, coef_init=coef, intercept_init=0.0)
    assert fit.coef_.shape == (3, X.shape[1])
