"""The port's ``LinearSVC`` against the JAX package's
``LinearSVC(engine="xla")`` on the same seeded numpy inputs: binary and
multiclass (the joint one-vs-all problem), dense and packed sparse X,
with ``sample_weight`` and ``class_weight="balanced"``; a
``DistGridSearchCV(LinearSVC)`` against the JAX package's; the
conversion of a fitted JAX model; the pickle round trip; and the
settings the port rejects.

Tolerances: ``n_iter_`` equal, ``coef_`` within 1e-5 of ``max|coef_|``,
and ``decision_function`` (which carries ``intercept_``, unpenalised and
summed over every row, so the noisiest weight) within 1e-5 of the
larger of 1 and ``max|coef_|``. Both packages run the same float32 L-BFGS on the same
squared-hinge objective to the same convergence test, and differ only
in summation order; at these settings (C = 0.03, tol = 1e-2) every fit
converges well above its gradient's float32 noise, so both stop at the
same iteration, about 3e-7 of max|coef_| apart. The squared hinge's
active set changes as rows cross the margin, which amplifies those
order differences as C grows: at C = 0.1 the 4-class packed fit with
sample weights ends 7e-6 of max|coef_| apart (same n_iter_), and at
tol = 1e-3 some fits stop an iteration apart (ROADMAP Queue 3, the
float32 noise floor). Search scores are held
to 1e-5 (tests/test_torch_search.py's standing tolerance), converted
models' decisions to 1e-6. The search's C grid stays where the
objective is well conditioned on this data (C <= 0.1); at C = 0.3 one
test-fold prediction already flips between the two packages' float32
fits, as tests/test_torch_search.py records for the logistic grid.
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.convert import linear_svc_from_reference
from skdist_tpu_torch.distribute.search import DistGridSearchCV
from skdist_tpu_torch.models import LinearSVC

FIT = dict(C=0.03, tol=1e-2, max_iter=300)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run shares the host's cores among
    its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(k, sparse, seed=0, n=200, d=300):
    rng = np.random.RandomState(seed + k)
    if sparse:
        rows = np.repeat(np.arange(n), 8)
        cols = rng.randint(0, d, size=n * 8)
        X = sp.csr_matrix(
            ((rng.rand(n * 8) + 0.5).astype(np.float32), (rows, cols)),
            shape=(n, d), dtype=np.float32)
        score = np.asarray(X @ rng.randn(d, k))
    else:
        X = rng.randn(n, 12).astype(np.float32)
        score = X @ rng.randn(12, k)
    y = np.argmax(score + 0.5 * rng.randn(n, k), axis=1)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, sw


def _assert_fit_close(port, ref):
    assert int(np.max(port.n_iter_)) == int(np.max(ref.n_iter_))
    assert int(np.max(ref.n_iter_)) < FIT["max_iter"]
    scale = np.abs(ref.coef_).max()
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(port.classes_, ref.classes_)


CASES = [
    # (n_classes, sparse X, sample_weight, class_weight)
    (2, False, True, None),
    (2, True, False, "balanced"),
    (4, False, False, None),
    (4, True, True, None),
    (4, False, False, "balanced"),
]


@pytest.mark.parametrize("k,sparse,use_sw,cw", CASES)
def test_fit_matches_jax(k, sparse, use_sw, cw):
    X, y, sw = _data(k, sparse)
    fit_kw = {"sample_weight": sw} if use_sw else {}
    ref = JaxSVC(engine="xla", class_weight=cw, **FIT).fit(X, y, **fit_kw)
    port = LinearSVC(device="cpu", engine="xla", class_weight=cw,
                     **FIT).fit(X, y, **fit_kw)
    assert port._meta["x_format"] == ("packed" if sparse else "dense")
    _assert_fit_close(port, ref)
    np.testing.assert_allclose(port.decision_function(X),
                               ref.decision_function(X), rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref.coef_).max()))
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_defaults_and_pickle():
    X, y, _ = _data(3, False)
    est = LinearSVC(device="cpu", C=0.03, tol=1e-2)
    assert est.max_iter == 1000 and est.loss == "squared_hinge"
    est.fit(X, y)
    loaded = pickle.loads(pickle.dumps(est))
    np.testing.assert_array_equal(loaded.predict(X), est.predict(X))
    assert not hasattr(est, "predict_proba")


def test_rejections():
    X, y, _ = _data(2, False)
    with pytest.raises(ValueError, match="squared_hinge"):
        LinearSVC(loss="hinge")
    with pytest.raises(ValueError, match="engine"):
        LinearSVC(engine="gpu")
    with pytest.raises(ValueError, match="squared_hinge"):
        LinearSVC(device="cpu").set_params(loss="hinge").fit(X, y)
    with pytest.raises(ValueError, match="engine"):
        LinearSVC(device="cpu").set_params(engine="gpu").fit(X, y)
    # engine='host' is ported: the f64 host engine, the JAX package's fit
    host = LinearSVC(device="cpu", engine="host", **FIT).fit(X, y)
    ref = JaxSVC(engine="host", **FIT).fit(X, y)
    np.testing.assert_allclose(host.coef_, ref.coef_, rtol=0, atol=1e-6)


def test_converted_jax_model_decides_the_same():
    for k in (2, 4):
        X, y, _ = _data(k, False)
        ref = JaxSVC(engine="xla", **FIT).fit(X, y)
        port = linear_svc_from_reference(
            {k_: np.asarray(v) for k_, v in ref._params.items()}, ref._meta,
            device="cpu")
        np.testing.assert_allclose(port.decision_function(X),
                                   ref.decision_function(X), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_grid_search_matches_jax(form):
    X, y, _ = _data(3, form == "sparse")
    grid = {"C": list(np.logspace(-2.5, -1, 5))}
    est = dict(tol=1e-2, max_iter=300)
    tg = DistGridSearchCV(LinearSVC(device="cpu", engine="xla", **est),
                          grid, cv=3,
                          scoring="accuracy",
                          backend=CUDABackend(device="cpu")).fit(X, y)
    jg = JaxGrid(JaxSVC(engine="xla", **est), grid, cv=3, scoring="accuracy",
                 backend=TPUBackend()).fit(X, y)
    for key in ["mean_test_score"] + [f"split{i}_test_score"
                                      for i in range(3)]:
        np.testing.assert_allclose(tg.cv_results_[key], jg.cv_results_[key],
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tg.cv_results_["rank_test_score"],
                                  jg.cv_results_["rank_test_score"])
    assert tg.best_params_ == jg.best_params_
    assert tg.round_stats_[0]["x_format"] == ("packed" if form == "sparse"
                                              else "dense")
    np.testing.assert_array_equal(tg.predict(X), jg.predict(X))
