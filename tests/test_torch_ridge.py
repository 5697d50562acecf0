"""The ridge family of the port (``Ridge``, ``LinearRegression``,
``RidgeClassifier``) against the JAX package's, on the CPU: single fits
on dense and packed X, ``DistGridSearchCV`` over an alpha grid, the
conversion of a fitted JAX model, and a lane whose gram is not positive
definite.

The JAX side runs packed X in both of its modes, set through
``SKDIST_SPARSE_MATVEC``: ``gather`` (the m**2-scatter gram) and
``pallas`` (the Pallas gram, K3's reference, in interpret mode). The
port runs K3's plain version on the CPU either way.

Tolerances. The problems have n > p (600 x 129 with the intercept), and
the two packages differ only in summation order (the gram's scatter,
the Cholesky factorisation), which the solve amplifies by the gram's
condition number (~2e3 at alpha = 1). The JAX package's own dense and
packed fits of the balanced 20-class problem already differ by 2.2e-4
of max|coef_|, so ``coef_`` and ``intercept_`` are held to 1e-3 of
max|coef_|, and predictions to 1e-3 of their largest magnitude.
``cv_results_`` ``mean_test_score`` within 1e-5: f1_weighted is an
exact function of the test-fold predictions, and none flips at that
coef_ agreement; r2 moves with coef_ by far less than 1e-5 here.
"""

import warnings

import numpy as np
import pytest

from bench import make_20news_sparse
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LinearRegression as JaxLinReg
from skdist_tpu.models import Ridge as JaxRidge
from skdist_tpu.models import RidgeClassifier as JaxRC
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.convert import ridge_from_reference
from skdist_tpu_torch.distribute.search import DistGridSearchCV as TorchGrid
from skdist_tpu_torch.distribute.search import FitFailedWarning
from skdist_tpu_torch.models import LinearRegression as TorchLinReg
from skdist_tpu_torch.models import Ridge as TorchRidge
from skdist_tpu_torch.models import RidgeClassifier as TorchRC

COEF_RTOL = 1e-3
SCORE_ATOL = 1e-5

#: (form of X, the JAX package's packed mode)
FORMS = [("dense", None), ("packed", "gather"), ("packed", "pallas")]


@pytest.fixture(scope="module")
def text():
    """A small 20news-shaped CSR that packs: 600 x 128, ~10 nnz a row,
    20 classes, and a real-valued target made from it."""
    X, y = make_20news_sparse(seed=0, n=600, d=128, nnz_row=10, k=20)
    rng = np.random.RandomState(1)
    yr = (np.asarray(X @ rng.randn(128)).ravel()
          + 0.1 * rng.randn(600)).astype(np.float32)
    return X, y, yr


def _form(X, form, mode, monkeypatch):
    if mode is None:
        monkeypatch.delenv("SKDIST_SPARSE_MATVEC", raising=False)
    else:
        monkeypatch.setenv("SKDIST_SPARSE_MATVEC", mode)
    return X.toarray() if form == "dense" else X


def _assert_coef_close(t, j):
    scale = float(np.abs(j.coef_).max())
    np.testing.assert_allclose(t.coef_, j.coef_, rtol=0,
                               atol=COEF_RTOL * scale)
    np.testing.assert_allclose(t.intercept_, j.intercept_, rtol=0,
                               atol=COEF_RTOL * scale)


@pytest.mark.parametrize("form,mode", FORMS)
@pytest.mark.parametrize("k", [2, 20])
@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_ridge_classifier_matches_jax(text, form, mode, k, class_weight,
                                      monkeypatch):
    X, y, _ = text
    y = y % k
    X = _form(X, form, mode, monkeypatch)
    t = TorchRC(alpha=1.0, class_weight=class_weight, device="cpu").fit(X, y)
    j = JaxRC(alpha=1.0, class_weight=class_weight).fit(X, y)
    assert t._meta["x_format"] == ("dense" if form == "dense" else "packed")
    assert j._meta.get("x_matvec", None) == mode
    assert t.coef_.shape == j.coef_.shape == (1 if k == 2 else k, 128)
    _assert_coef_close(t, j)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))


@pytest.mark.parametrize("form,mode", FORMS)
@pytest.mark.parametrize("est", ["ridge", "ols", "ridge_2d"])
def test_regressors_match_jax(text, form, mode, est, monkeypatch):
    X, _, yr = text
    X = _form(X, form, mode, monkeypatch)
    sw = np.random.RandomState(2).uniform(0.5, 2.0, 600).astype(np.float32)
    if est == "ols":
        t = TorchLinReg(device="cpu").fit(X, yr, sample_weight=sw)
        j = JaxLinReg().fit(X, yr, sample_weight=sw)
    else:
        y = yr if est == "ridge" else np.stack([yr, -2 * yr + 1], axis=1)
        t = TorchRidge(alpha=0.1, device="cpu").fit(X, y, sample_weight=sw)
        j = JaxRidge(alpha=0.1).fit(X, y, sample_weight=sw)
    assert t.coef_.shape == j.coef_.shape
    _assert_coef_close(t, j)
    pred = j.predict(X)
    np.testing.assert_allclose(t.predict(X), pred, rtol=0,
                               atol=COEF_RTOL * float(np.abs(pred).max()))
    if est != "ridge_2d":
        np.testing.assert_allclose(t.score(X, yr), j.score(X, yr), atol=1e-5)


def _search_pair(est_t, est_j, grid, X, y, **kw):
    tg = TorchGrid(est_t, grid, cv=3, backend=CUDABackend(device="cpu"),
                   **kw).fit(X, y)
    jg = JaxGrid(est_j, grid, cv=3, backend=TPUBackend(), **kw).fit(X, y)
    return tg, jg


def _assert_same_search(tg, jg):
    for key in ["mean_test_score"] + [f"split{i}_test_score"
                                      for i in range(3)]:
        np.testing.assert_allclose(tg.cv_results_[key], jg.cv_results_[key],
                                   atol=SCORE_ATOL, err_msg=key)
    np.testing.assert_array_equal(tg.cv_results_["rank_test_score"],
                                  jg.cv_results_["rank_test_score"])
    assert tg.best_params_ == jg.best_params_
    assert tg.cv_results_["params"] == jg.cv_results_["params"]


@pytest.mark.parametrize("form", ["dense", "packed"])
def test_ridge_classifier_search_matches_jax(text, form):
    X, y, _ = text
    if form == "dense":
        X = X.toarray()
    grid = {"alpha": list(np.logspace(-1, 2, 6))}
    tg, jg = _search_pair(TorchRC(device="cpu"), JaxRC(), grid, X, y,
                          scoring="f1_weighted")
    _assert_same_search(tg, jg)
    assert len(tg.round_stats_) == 1  # the alpha grid is one bucket
    assert tg.round_stats_[0]["x_format"] == ("packed" if form == "packed"
                                              else "dense")
    np.testing.assert_array_equal(tg.predict(X), jg.predict(X))


def test_ridge_regressor_search_matches_jax(text):
    """Default scoring r2, KFold splits for a continuous target."""
    X, _, yr = text
    grid = {"alpha": list(np.logspace(-1, 2, 4))}
    tg, jg = _search_pair(TorchRidge(device="cpu"), JaxRidge(), grid, X, yr)
    _assert_same_search(tg, jg)
    np.testing.assert_allclose(tg.score(X, yr), jg.score(X, yr), atol=1e-5)
    with pytest.raises(NotImplementedError):  # a classification metric
        TorchGrid(TorchRidge(device="cpu"), grid, cv=3, scoring="accuracy",
                  backend=CUDABackend(device="cpu")).fit(X, yr)


@pytest.mark.parametrize("name", ["Ridge", "LinearRegression",
                                  "RidgeClassifier"])
def test_ridge_from_reference_predicts_as_jax(text, name):
    X, y, yr = text
    ref = {"Ridge": JaxRidge(alpha=0.5), "LinearRegression": JaxLinReg(),
           "RidgeClassifier": JaxRC(alpha=0.5)}[name]
    ref.fit(X, y if name == "RidgeClassifier" else yr)
    port = ridge_from_reference(ref, device="cpu")
    assert type(port).__name__ == name
    dec = ref.decision_function(X)
    np.testing.assert_allclose(port.decision_function(X), dec, rtol=0,
                               atol=1e-5 * float(np.abs(dec).max()))
    np.testing.assert_array_equal(port.coef_, np.asarray(ref.coef_))
    if name == "RidgeClassifier":
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_lane_that_is_not_positive_definite_gives_nan(text):
    """alpha = -1e4 pushes the gram's feature diagonal negative: the
    Cholesky factorisation fails. The fit gives NaN weights, as the JAX
    package's does, and raises nothing; the search maps that lane's
    scores to error_score."""
    X, _, yr = text
    t = TorchRidge(alpha=-1e4, device="cpu").fit(X, yr)
    j = JaxRidge(alpha=-1e4).fit(X, yr)
    assert np.isnan(t.coef_).all() and np.isnan(np.asarray(j.coef_)).all()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gs = TorchGrid(TorchRidge(device="cpu"), {"alpha": [-1e4, 1.0]},
                       cv=3, error_score=-1.0,
                       backend=CUDABackend(device="cpu")).fit(X, yr)
    assert any(issubclass(w.category, FitFailedWarning) for w in caught)
    scores = gs.cv_results_["mean_test_score"]
    assert scores[0] == -1.0 and np.isfinite(scores[1]) and scores[1] > 0.5
    assert gs.best_params_ == {"alpha": 1.0}
