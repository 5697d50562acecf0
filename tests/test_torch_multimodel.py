"""The port's DistMultiModelSearch (skdist_tpu_torch.distribute.search)
against the JAX package's, on the same numpy inputs made from a seed, on
the CPU, and the cases of the JAX package's own tests/test_multimodel.py.

The JAX side pins its linear estimators to ``engine="xla"`` (its CPU
``auto`` is the f64 host engine) and its forest to
``hist_mode="scatter"``, with ``bootstrap=False, max_features=None`` so
that no draw differs between the packages; the port runs on
``CUDABackend(device="cpu")`` with its linear estimators pinned to
``engine="xla"`` too (their CPU ``auto`` is the host engine). Both draw
scikit-learn's candidates for one ``random_state``, so ``params`` and
``model_index`` are equal, the scores agree within 1e-5 (the batched
fits run float32 in another summation order; the forests grow the same
trees) and ``best_model_name_`` is equal.
"""

import pickle
import warnings

import numpy as np
import pytest

from skdist_tpu.distribute.search import DistMultiModelSearch as JaxMM
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import RandomForestClassifier as JaxRF
from skdist_tpu.models import RidgeClassifier as JaxRC
from skdist_tpu_torch import DistMultiModelSearch
from skdist_tpu_torch.base import BaseEstimator
from skdist_tpu_torch.distribute.search import DistGridSearchCV, _raw_sampler
from skdist_tpu_torch.models import LogisticRegression, RidgeClassifier
from skdist_tpu_torch.models.forest import RandomForestClassifier
from skdist_tpu_torch.models.tree import DecisionTreeClassifier
from skdist_tpu_torch.parallel import CUDABackend

SCORE_ATOL = 1e-5
CPU = dict(backend=CUDABackend(device="cpu"))


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    X = np.vstack([rng.normal(loc=c, scale=1.2, size=(60, 8))
                   for c in (-1.0, 0.0, 1.0)]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def _port_models():
    return [
        ("lr", LogisticRegression(max_iter=50, engine="xla", device="cpu"),
         {"C": [0.01, 0.1, 1.0, 10.0]}),
        ("ridge", RidgeClassifier(device="cpu"), {"alpha": [0.5, 2.0, 8.0]}),
        ("rf", RandomForestClassifier(n_estimators=6, random_state=0,
                                      bootstrap=False, max_features=None,
                                      device="cpu"),
         {"max_depth": [2, 3, 5]}),
    ]


def _jax_models():
    return [
        ("lr", JaxLR(max_iter=50, engine="xla"),
         {"C": [0.01, 0.1, 1.0, 10.0]}),
        ("ridge", JaxRC(), {"alpha": [0.5, 2.0, 8.0]}),
        ("rf", JaxRF(n_estimators=6, random_state=0, bootstrap=False,
                     max_features=None, hist_mode="scatter"),
         {"max_depth": [2, 3, 5]}),
    ]


@pytest.mark.parametrize("n", [2, 3])
def test_matches_jax(data, n):
    X, y = data
    ours = DistMultiModelSearch(_port_models(), n=n, cv=3,
                                scoring="accuracy", random_state=0,
                                **CPU).fit(X, y)
    theirs = JaxMM(_jax_models(), n=n, cv=3, scoring="accuracy",
                   random_state=0).fit(X, y)
    r, j = ours.cv_results_, theirs.cv_results_
    assert r["params"] == j["params"]
    assert list(r["model_index"]) == list(j["model_index"])
    assert list(r["model_name"]) == list(j["model_name"])
    for key in ["mean_test_score"] + [f"split{i}_test_score"
                                      for i in range(3)]:
        np.testing.assert_allclose(r[key], j[key], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(r["rank_test_score"], j["rank_test_score"])
    for key in [k for k in j if k.startswith("param_")]:
        np.testing.assert_array_equal(np.ma.getmaskarray(r[key]),
                                      np.ma.getmaskarray(j[key]))
    assert ours.best_model_name_ == theirs.best_model_name_
    assert ours.best_params_ == theirs.best_params_
    assert ours.best_index_ == int(np.nanargmax(r["mean_test_score"]))
    np.testing.assert_allclose(ours.best_score_, theirs.best_score_,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(ours.worst_score_, theirs.worst_score_,
                               atol=SCORE_ATOL)
    assert ours.worst_score_ <= ours.best_score_
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    modes = {s["model_name"]: s["round_stats"][0]["mode"]
             for s in ours.round_stats_}
    assert modes["rf"] == "generic" and modes["lr"] != "generic"


def test_fit_selects_best(data):
    X, y = data
    mm = DistMultiModelSearch(_port_models(), n=2, cv=3, scoring="accuracy",
                              random_state=0, **CPU).fit(X, y)
    assert mm.best_model_name_ in ("lr", "ridge", "rf")
    assert 0.5 <= mm.best_score_ <= 1.0
    assert mm.predict(X).shape == (len(y),)
    assert len(mm.cv_results_["model_name"]) == 6
    assert set(mm.cv_results_["model_name"]) == {"lr", "ridge", "rf"}
    ranks = mm.cv_results_["rank_test_score"]
    assert min(ranks) == 1
    for col in ("model_index", "model_name", "params", "rank_test_score",
                "mean_test_score", "std_test_score", "mean_fit_time"):
        assert col in mm.cv_results_


def test_raw_sampler_caps_at_grid():
    sets = _raw_sampler([("lr", LogisticRegression(), {"C": [0.1, 1.0]})],
                        n=10, random_state=0)
    assert len(sets) == 2
    with pytest.raises(ValueError, match="n_params"):
        _raw_sampler([("lr", LogisticRegression(), {})])


def test_refit_false(data):
    X, y = data
    mm = DistMultiModelSearch(_port_models()[:1], n=2, cv=2,
                              scoring="accuracy", refit=False, **CPU).fit(X, y)
    assert not hasattr(mm, "best_estimator_")
    with pytest.raises(AttributeError):
        mm.predict(X)


def test_validation_errors():
    X, y = np.zeros((4, 2), np.float32), [0, 1, 0, 1]
    with pytest.raises(ValueError):
        DistMultiModelSearch([]).fit(X, y)
    dup = [("a", LogisticRegression(), {}), ("a", RidgeClassifier(), {})]
    with pytest.raises(ValueError, match="Duplicate"):
        DistMultiModelSearch(dup).fit(X, y)
    with pytest.raises(ValueError, match="name must be str"):
        DistMultiModelSearch([(1, LogisticRegression(), {})]).fit(X, y)
    with pytest.raises(ValueError, match="param set must be dict"):
        DistMultiModelSearch([("a", LogisticRegression(), [])]).fit(X, y)
    with pytest.raises(ValueError, match="each model"):
        DistMultiModelSearch([("a", LogisticRegression())]).fit(X, y)
    with pytest.raises(ValueError, match="single-metric"):
        DistMultiModelSearch(
            [("a", LogisticRegression(device="cpu"), {})],
            scoring=["accuracy", "f1_weighted"], cv=2, **CPU,
        ).fit(np.random.RandomState(0).randn(8, 2).astype(np.float32),
              [0, 1] * 4)


def test_empty_param_dict_model(data):
    """A model with an empty param dict gets exactly one candidate."""
    X, y = data
    mm = DistMultiModelSearch(
        [("lr", LogisticRegression(max_iter=50, device="cpu"),
          {"C": [0.1, 1.0]}),
         ("tree", DecisionTreeClassifier(max_depth=3, device="cpu"), {})],
        n=2, cv=2, scoring="accuracy", random_state=0, **CPU).fit(X, y)
    names = mm.cv_results_["model_name"]
    assert names.count("tree") == 1 and names.count("lr") == 2
    assert mm.cv_results_["params"][2] == {}


def test_fit_params_passthrough(data):
    """Fit params reach every fold's fit and the winner's refit (the
    generic path), in the grid search and in the multi-model search."""
    X, y = data
    seen = []

    class NeedsParam(LogisticRegression):
        def fit(self, X, y, marker=None, sample_weight=None):
            seen.append(marker)
            return super().fit(X, y, sample_weight=sample_weight)

    gs = DistGridSearchCV(NeedsParam(max_iter=100, device="cpu"),
                          {"C": [1.0]}, cv=2, **CPU).fit(X, y, marker="gs")
    assert seen.count("gs") == 3
    assert gs.score(X, y) > 0.5
    seen.clear()
    mm = DistMultiModelSearch(
        [("np", NeedsParam(max_iter=100, device="cpu"), {"C": [1.0]})],
        n=1, cv=2, scoring="accuracy", **CPU).fit(X, y, marker="mm")
    assert seen.count("mm") == 3
    assert mm.best_model_name_ == "np"


class _Exploding(BaseEstimator):
    """A classifier whose every fit raises."""

    _estimator_type = "classifier"

    def __init__(self, C=1.0):
        self.C = C

    def fit(self, X, y):
        raise RuntimeError("boom")


def test_failed_model_not_selected(data):
    """A model whose fits all fail (NaN scores) never wins, placed first
    or last."""
    X, y = data
    good = ("good", LogisticRegression(max_iter=50, device="cpu"),
            {"C": [1.0]})
    bad = ("bad", _Exploding(), {"C": [1.0]})
    for models in ([good, bad], [bad, good]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mm = DistMultiModelSearch(models, n=1, cv=2, scoring="accuracy",
                                      **CPU).fit(X, y)
        assert mm.best_model_name_ == "good"
        scores = np.asarray(mm.cv_results_["mean_test_score"])
        assert np.isnan(scores[mm.cv_results_["model_name"].index("bad")])
        assert mm.cv_results_["rank_test_score"][
            mm.cv_results_["model_name"].index("bad")] == 2


def test_all_failed_raises(data):
    X, y = data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="All candidate fits failed"):
            DistMultiModelSearch([("bad", _Exploding(), {"C": [1.0]})], n=1,
                                 cv=2, scoring="accuracy", **CPU).fit(X, y)


def test_backend_stripped_and_pickle(data):
    X, y = data
    mm = DistMultiModelSearch(_port_models()[:2], n=2, cv=2,
                              scoring="accuracy", random_state=0,
                              **CPU).fit(X, y)
    assert mm.backend is None
    loaded = pickle.loads(pickle.dumps(mm))
    np.testing.assert_array_equal(loaded.predict(X), mm.predict(X))
    np.testing.assert_array_equal(loaded.classes_, mm.classes_)
    np.testing.assert_allclose(loaded.decision_function(X),
                               mm.decision_function(X))
