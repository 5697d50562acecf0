"""The port's LogisticRegression (skdist_tpu_torch.models.linear) against
the JAX package's ``LogisticRegression(engine="xla")``: binary and
multinomial, dense and packed sparse, with ``sample_weight`` and with
``class_weight="balanced"``; the conversion of a fitted JAX model; the
pickle round trip; and the options that are not ported yet.

Tolerances: coef_/intercept_ atol 2e-4 and predict_proba atol 1e-4.
Both packages run the same L-BFGS in f32 to the same convergence test,
with summation orders that differ; the fits converge (asserted) well
above the f32 noise floor of their gradients, so the iterates they stop
at agree to about 1e-4 of unit-scale coefficients.
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu_torch.convert import logistic_regression_from_reference
from skdist_tpu_torch.models import LogisticRegression as TorchLR

COEF_ATOL = 2e-4
PROBA_ATOL = 1e-4
FIT = dict(C=0.5, tol=1e-2, max_iter=300)


def _data(k, sparse, seed=0, n=160, d=300):
    rng = np.random.RandomState(seed + k)
    if sparse:
        rows = np.repeat(np.arange(n), 8)
        cols = rng.randint(0, d, size=n * 8)
        X = sp.csr_matrix(
            ((rng.rand(n * 8) + 0.5).astype(np.float32), (rows, cols)),
            shape=(n, d), dtype=np.float32,
        )
        score = np.asarray(X @ rng.randn(d, k))
    else:
        X = rng.randn(n, 12).astype(np.float32)
        score = X @ rng.randn(12, k)
    y = np.argmax(score + 0.5 * rng.randn(n, k), axis=1)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, sw


CASES = [
    # (n_classes, sparse X, sample_weight, class_weight)
    (2, False, True, None),
    (2, True, False, "balanced"),
    (4, False, False, "balanced"),
    (4, True, True, None),
]


@pytest.mark.parametrize("k,sparse,use_sw,cw", CASES)
def test_fit_matches_jax(k, sparse, use_sw, cw):
    X, y, sw = _data(k, sparse)
    fit_kw = {"sample_weight": sw} if use_sw else {}
    jm = JaxLR(engine="xla", class_weight=cw, **FIT).fit(X, y, **fit_kw)
    tm = TorchLR(device="cpu", engine="xla", class_weight=cw,
                 **FIT).fit(X, y, **fit_kw)
    assert int(np.max(jm.n_iter_)) < FIT["max_iter"]
    assert tm._meta["x_format"] == ("packed" if sparse else "dense")
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert tm.coef_.shape == jm.coef_.shape
    np.testing.assert_allclose(tm.coef_, jm.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(tm.intercept_, jm.intercept_, atol=COEF_ATOL)
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               atol=PROBA_ATOL)
    np.testing.assert_allclose(tm.decision_function(X),
                               jm.decision_function(X), atol=1e-3)


@pytest.mark.parametrize("k", [2, 3])
def test_convert_reference_model(k):
    """A fitted JAX model carried into the port computes the same
    decision function and probabilities (no refit: identical weights, so
    only the f32 summation order differs)."""
    X, y, _ = _data(k, sparse=False, seed=4)
    jm = JaxLR(engine="xla", max_iter=50).fit(X, y)
    params = {key: np.asarray(v) for key, v in jm._params.items()}
    tm = logistic_regression_from_reference(params, jm._meta, device="cpu")
    np.testing.assert_allclose(tm.decision_function(X),
                               jm.decision_function(X), atol=1e-5)
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               atol=1e-6)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_array_equal(tm.coef_, jm.coef_)
    with pytest.raises(ValueError):
        logistic_regression_from_reference(
            {"W": params["W"][:-3]}, jm._meta, device="cpu")


def test_pickle_round_trip():
    X, y, _ = _data(3, sparse=True, seed=2)
    tm = TorchLR(device="cpu", **FIT).fit(X, y)
    back = pickle.loads(pickle.dumps(tm))
    np.testing.assert_array_equal(back.predict(X), tm.predict(X))
    np.testing.assert_array_equal(back.coef_, tm.coef_)
    assert back.get_params() == tm.get_params()
    assert all(isinstance(v, np.ndarray) for v in back._params.values())


def test_options_not_ported_raise():
    """The options that raised before they were ported now fit:
    ``matmul_dtype='bfloat16'`` (the torch engine, bf16 products) and
    ``engine='host'`` (the f64 host engine), each against the JAX
    package's fit (tests/test_torch_bf16.py and
    tests/test_torch_host_engine.py hold them closely); invalid settings
    still raise, also through ``set_params``."""
    X, y, _ = _data(2, sparse=False)
    bf16 = TorchLR(device="cpu", matmul_dtype="bfloat16", **FIT).fit(X, y)
    ref = JaxLR(engine="xla", matmul_dtype="bfloat16", **FIT).fit(X, y)
    assert not hasattr(bf16, "_w_opt64")
    assert abs(bf16.score(X, y) - ref.score(X, y)) <= 1e-3
    host = TorchLR(device="cpu", engine="host", **FIT).fit(X, y)
    ref = JaxLR(engine="host", **FIT).fit(X, y)
    assert hasattr(host, "_w_opt64")
    np.testing.assert_allclose(host.coef_, ref.coef_, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        TorchLR(penalty="l1")
    for bad in ({"engine": "gpu"}, {"matmul_dtype": "float16"},
                {"penalty": "l1"}):
        with pytest.raises(ValueError):
            TorchLR(device="cpu").set_params(**bad).fit(X, y)


def test_unpenalized_and_no_intercept():
    X, y, _ = _data(3, sparse=False, seed=1)
    jm = JaxLR(engine="xla", penalty=None, fit_intercept=False,
               **FIT).fit(X, y)
    tm = TorchLR(device="cpu", engine="xla", penalty=None,
                 fit_intercept=False, **FIT).fit(X, y)
    np.testing.assert_array_equal(tm.intercept_, np.zeros(3, np.float32))
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               atol=1e-3)
