"""The slice as a whole: the port's ``DistGridSearchCV(LogisticRegression)``
on ``CUDABackend(device="cpu")`` against the JAX package's on
``TPUBackend()`` over the conftest CPU mesh, on a small
``make_20news_sparse``-shaped CSR and on its dense form.

The JAX side runs its default packed mode (gather); its Pallas mode in
interpret mode would only repeat the kernel test at great cost, and
tests/test_pallas_sparse.py already holds Pallas equal to gather.

Tolerance: every ``mean_test_score``/``split*_test_score`` within 1e-5,
identical ``rank_test_score`` and ``best_params_``. The scores are exact
functions of the test-fold predictions, so they agree when no
prediction flips. The C grid stays where the objective is well
conditioned (C <= 1 on this data), where the two packages' fits agree to
~4e-4 of coef_. Above it the objective flattens: at C >= 2.5 the JAX
package's own dense and packed fits of one problem already differ by
~1e-3 in coef_ (f32 summation order alone), and a test-fold prediction
can flip in either package, so no 1e-5 score contract holds there.
``neg_log_loss`` is continuous in coef_ rather than a function of
predictions, so it is held to 1e-4, what a ~4e-4 coef_ agreement moves
it by; the refit coef_ to 1e-3.
"""

import pickle

import numpy as np
import pytest

from bench import make_20news_sparse
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.distribute.search import DistGridSearchCV as TorchGrid
from skdist_tpu_torch.distribute.search import FitFailedWarning
from skdist_tpu_torch.models import LogisticRegression as TorchLR
from skdist_tpu_torch.models import Ridge as TorchRidge

CS = list(np.logspace(-2, 0, 6))
EST = dict(tol=1e-2, max_iter=200)


@pytest.fixture(scope="module")
def data():
    return make_20news_sparse(seed=0, n=300, d=1024, nnz_row=20, k=5)


def _searches(X, y, scoring="f1_weighted", **kw):
    tg = TorchGrid(TorchLR(device="cpu", **EST), {"C": CS}, cv=3,
                   scoring=scoring, backend=CUDABackend(device="cpu"),
                   **kw).fit(X, y)
    jg = JaxGrid(JaxLR(engine="xla", **EST), {"C": CS}, cv=3,
                 scoring=scoring, backend=TPUBackend(), **kw).fit(X, y)
    return tg, jg


def _assert_same_results(tg, jg, names=("score",)):
    for name in names:
        atol = 1e-4 if name == "neg_log_loss" else 1e-5
        for key in [f"mean_test_{name}"] + [
                f"split{i}_test_{name}" for i in range(3)]:
            np.testing.assert_allclose(tg.cv_results_[key],
                                       jg.cv_results_[key], atol=atol,
                                       err_msg=key)
        np.testing.assert_array_equal(tg.cv_results_[f"rank_test_{name}"],
                                      jg.cv_results_[f"rank_test_{name}"])
    assert tg.best_params_ == jg.best_params_
    assert tg.cv_results_["params"] == jg.cv_results_["params"]
    np.testing.assert_array_equal(
        np.asarray(tg.cv_results_["param_C"], dtype=float),
        np.asarray(jg.cv_results_["param_C"], dtype=float))


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_search_matches_jax(data, form):
    X, y = data
    if form == "dense":
        X = X.toarray()
    tg, jg = _searches(X, y)
    assert tg.round_stats_[0]["x_format"] == ("packed" if form == "sparse"
                                              else "dense")
    _assert_same_results(tg, jg)
    assert tg.best_score_ == pytest.approx(jg.best_score_, abs=1e-5)
    np.testing.assert_allclose(tg.best_estimator_.coef_,
                               jg.best_estimator_.coef_, atol=1e-3)
    # the artifact holds no backend and pickles clean
    assert tg.backend is None
    back = pickle.loads(pickle.dumps(tg))
    np.testing.assert_array_equal(back.predict(X), tg.predict(X))
    assert back.score(X, y) == pytest.approx(tg.score(X, y))


def test_multimetric_with_train_scores(data):
    X, y = data
    tg, jg = _searches(X, y, scoring=["accuracy", "neg_log_loss"],
                       refit="accuracy", return_train_score=True)
    _assert_same_results(tg, jg, names=("accuracy", "neg_log_loss"))
    for name, atol in (("accuracy", 1e-5), ("neg_log_loss", 1e-4)):
        np.testing.assert_allclose(tg.cv_results_[f"mean_train_{name}"],
                                   jg.cv_results_[f"mean_train_{name}"],
                                   atol=atol)


def test_rounds_and_sample_weight(data):
    """Tasks split over rounds give the results of one round, and a
    full-length sample_weight weights the fits as in the JAX package."""
    X, y = data
    sw = np.random.RandomState(0).uniform(0.5, 2.0, len(y))
    one = TorchGrid(TorchLR(device="cpu", **EST), {"C": CS[:3]}, cv=3,
                    backend=CUDABackend(device="cpu")).fit(X, y)
    many = TorchGrid(TorchLR(device="cpu", **EST), {"C": CS[:3]}, cv=3,
                     partitions=4,
                     backend=CUDABackend(device="cpu")).fit(X, y)
    assert many.round_stats_[0]["rounds"] == 3
    np.testing.assert_array_equal(one.cv_results_["mean_test_score"],
                                  many.cv_results_["mean_test_score"])
    tg = TorchGrid(TorchLR(device="cpu", **EST), {"C": CS[:3]}, cv=3,
                   backend=CUDABackend(device="cpu")).fit(
        X, y, sample_weight=sw)
    jg = JaxGrid(JaxLR(engine="xla", **EST), {"C": CS[:3]}, cv=3,
                 backend=TPUBackend()).fit(X, y, sample_weight=sw)
    np.testing.assert_allclose(tg.cv_results_["mean_test_score"],
                               jg.cv_results_["mean_test_score"], atol=1e-5)


def test_unported_paths_raise(data):
    """What still raises: checkpointing (ROADMAP Queue 1 item 10) and a
    regressor's multi-target y. What raised before the generic search path
    now takes it: a scoring with no device kernel for this estimator, a
    searched param off the task axis, and fit params other than
    ``sample_weight`` (which this estimator refuses: every fit fails and
    scores ``error_score``)."""
    X, y = data
    be = CUDABackend(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchGrid(TorchLR(device="cpu"), {"C": CS},
                  backend=be).fit(X, y, checkpoint_dir="ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchGrid(TorchRidge(device="cpu"), {"alpha": [1.0]},
                  backend=be).fit(X, np.stack([y, y], axis=1).astype(float))
    gs = TorchGrid(TorchLR(device="cpu", **EST), {"C": CS[:2]}, cv=3,
                   scoring="r2", backend=be).fit(X, y)
    assert gs.round_stats_[0]["mode"] == "generic"
    assert np.all(np.isfinite(gs.cv_results_["mean_test_score"]))
    with pytest.warns(FitFailedWarning), pytest.raises(
            RuntimeError, match="All candidate fits failed"):
        TorchGrid(TorchLR(device="cpu", **EST), {"C": CS[:2]}, cv=3,
                  backend=be).fit(X, y, groups_x=1)
    gs = TorchGrid(TorchLR(device="cpu", **EST), {"random_state": [0, 1]},
                   cv=3, backend=be).fit(X, y)
    assert gs.round_stats_[0]["mode"] == "generic"
