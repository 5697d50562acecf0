"""The port's generic search path and host scorers against the JAX
package's (and scikit-learn's), on the same numpy inputs made from a
seed, on the CPU.

- A forest search: the port's ``DistGridSearchCV(RandomForestClassifier)``
  against the JAX package's, both on the generic path over their
  ``LocalBackend``. With ``bootstrap=False, max_features=None`` no random
  draw is involved and both grow the same trees (the JAX side pinned to
  ``hist_mode="scatter"``), so every ``cv_results_`` score agrees within
  1e-6, the ranks and ``best_params_`` are equal, and ``preds_`` (the
  out-of-fold probabilities at the best params) agree within 1e-6.
- ``n_jobs=2`` gives ``n_jobs=1``'s scores bitwise (each task is fitted
  alone, whichever thread runs it).
- The ``error_score`` policy, a fit param other than ``sample_weight``
  (cut to each fold's rows) and a callable scorer, each against the JAX
  package's generic path on one duck-typed estimator: equal scores.
- Each host scorer against scikit-learn's scorer of the same name on the
  same fitted model (through a thin scikit-learn adapter, since
  scikit-learn's scorers ask for its own estimator tags): within 1e-6
  relative. The port sums in float64; scikit-learn sums the models'
  float32 probabilities and predictions in float32, ~1e-8 apart.
"""

import pickle
import warnings

import numpy as np
import pytest
from sklearn.base import BaseEstimator as SkBase
from sklearn.base import ClassifierMixin as SkClf
from sklearn.base import RegressorMixin as SkReg
from sklearn.metrics import get_scorer

from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import forest as jf
from skdist_tpu.parallel import LocalBackend as JaxLocal
from skdist_tpu_torch.base import BaseEstimator, ClassifierMixin
from skdist_tpu_torch.distribute.search import DistGridSearchCV as TorchGrid
from skdist_tpu_torch.distribute.search import FitFailedWarning
from skdist_tpu_torch.metrics import HOST_SCORERS, Scorer
from skdist_tpu_torch.metrics import check_multimetric_scoring
from skdist_tpu_torch.models import LogisticRegression, Ridge
from skdist_tpu_torch.models.forest import RandomForestClassifier
from skdist_tpu_torch.parallel import LocalBackend

GRID = {"max_depth": [2, 4], "min_samples_leaf": [1, 15]}
FOREST = dict(n_estimators=3, bootstrap=False, max_features=None,
              random_state=0)


def _binary(seed=0, n=150, d=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    s = X @ rng.randn(d) + 0.3 * rng.randn(n)
    return X, (s > np.median(s)).astype(np.int64)


def _same_scores(tg, jg, names):
    for name in names:
        for key in [f"mean_test_{name}"] + [
                f"split{i}_test_{name}" for i in range(3)]:
            np.testing.assert_allclose(tg.cv_results_[key],
                                       jg.cv_results_[key], rtol=0,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(tg.cv_results_[f"rank_test_{name}"],
                                      jg.cv_results_[f"rank_test_{name}"])
    assert tg.cv_results_["params"] == jg.cv_results_["params"]


def test_forest_search_matches_jax():
    X, y = _binary()
    kw = dict(cv=3, scoring=["accuracy", "roc_auc"], refit="roc_auc",
              preds=True)
    tg = TorchGrid(RandomForestClassifier(device="cpu", **FOREST), GRID,
                   backend=LocalBackend(device="cpu"), **kw).fit(X, y)
    jg = JaxGrid(jf.RandomForestClassifier(hist_mode="scatter", **FOREST),
                 GRID, backend=JaxLocal(), **kw).fit(X, y)
    assert tg.round_stats_[0]["mode"] == "generic"
    _same_scores(tg, jg, ("accuracy", "roc_auc"))
    assert tg.best_params_ == jg.best_params_
    assert tg.preds_.shape == (len(y), 2)
    np.testing.assert_allclose(tg.preds_, jg.preds_, rtol=0, atol=1e-6)
    back = pickle.loads(pickle.dumps(tg))
    np.testing.assert_array_equal(back.predict_proba(X), tg.predict_proba(X))
    assert back.score(X, y) == tg.score(X, y)
    assert tg.score(X, y) == pytest.approx(jg.score(X, y), abs=1e-6)


def test_n_jobs_bitwise():
    """backend=None is the card's backend with n_jobs host threads (the
    estimator's device="cpu" here): two threads give one thread's
    scores bit for bit."""
    X, y = _binary(1)
    runs = [TorchGrid(RandomForestClassifier(device="cpu", **FOREST), GRID,
                      cv=3, n_jobs=n_jobs).fit(X, y) for n_jobs in (1, 2)]
    for key in ("mean_test_score", "split0_test_score", "split2_test_score"):
        np.testing.assert_array_equal(runs[0].cv_results_[key],
                                      runs[1].cv_results_[key])


class _Centroid(BaseEstimator, ClassifierMixin):
    """Nearest weighted class centroid; fails on purpose for
    ``shrink < 0``. ``weights`` is a fit param the batched path does not
    take."""

    def __init__(self, shrink=0.0):
        self.shrink = shrink

    def fit(self, X, y, weights=None):
        if self.shrink < 0:
            raise ValueError("negative shrink")
        X = np.asarray(X, np.float64)
        w = np.ones(len(y)) if weights is None else np.asarray(weights)
        self.classes_ = np.unique(y)
        self.centroids_ = np.stack([
            np.average(X[y == c], axis=0, weights=w[y == c])
            for c in self.classes_]) * (1.0 - self.shrink)
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        dist = ((X[:, None, :] - self.centroids_[None]) ** 2).sum(-1)
        return self.classes_[np.argmin(dist, axis=1)]


def _wrong(est, X, y):
    """A callable scorer: minus the count of wrong labels."""
    return -float(np.sum(est.predict(X) != np.asarray(y)))


@pytest.mark.parametrize("case", ["error_score", "fit_param", "callable"])
def test_duck_typed_search_matches_jax(case):
    X, y = _binary(2)
    grid = {"shrink": [0.0, 0.1, -1.0]}
    kw = dict(cv=3, error_score=-1000.0)
    fit_kw = {}
    if case == "fit_param":
        fit_kw = {"weights": np.random.RandomState(0).rand(len(y)) + 0.5}
    if case == "callable":
        kw["scoring"] = _wrong
    with pytest.warns(FitFailedWarning):
        tg = TorchGrid(_Centroid(), grid, backend=LocalBackend(device="cpu"),
                       **kw).fit(X, y, **fit_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jg = JaxGrid(_Centroid(), grid, backend=JaxLocal(),
                     **kw).fit(X, y, **fit_kw)
    for key in ("mean_test_score", "split0_test_score", "split1_test_score",
                "split2_test_score", "rank_test_score"):
        np.testing.assert_array_equal(tg.cv_results_[key],
                                      jg.cv_results_[key], err_msg=key)
    assert tg.cv_results_["mean_test_score"][2] == -1000.0
    assert tg.best_params_ == jg.best_params_
    if case == "error_score":
        with pytest.raises(ValueError, match="negative shrink"):
            TorchGrid(_Centroid(), grid, cv=3, error_score="raise",
                      backend=LocalBackend(device="cpu")).fit(X, y)


def test_search_paths_and_checkpoint():
    """A searched param outside the task axis and a scoring with no device
    kernel take the generic path; checkpointing still raises."""
    X, y = _binary(3)
    be = LocalBackend(device="cpu")
    lr = LogisticRegression(max_iter=20, device="cpu")
    gs = TorchGrid(lr, {"C": [0.1, 1.0]}, cv=3, backend=be).fit(X, y)
    assert gs.round_stats_[0]["mode"] != "generic"
    gs = TorchGrid(lr, {"C": [0.1, 1.0]}, cv=3, backend=be,
                   scoring={"acc": "accuracy"}, refit="acc").fit(X, y)
    assert gs.round_stats_[0]["mode"] == "generic" and gs.multimetric_
    gs = TorchGrid(lr, {"random_state": [0, 1]}, cv=3, backend=be).fit(X, y)
    assert gs.round_stats_[0]["mode"] == "generic"
    with pytest.raises(NotImplementedError, match="item 10"):
        TorchGrid(lr, {"C": [1.0]}, cv=3, backend=be).fit(
            X, y, checkpoint_dir="ckpt")


# --------------------------------------------------------------------------
# the host scorers against scikit-learn's
# --------------------------------------------------------------------------

class _SkAdapter(SkBase):
    """A fitted port model as scikit-learn sees an estimator."""

    def __init__(self, model=None):
        self.model = model

    def __getattr__(self, name):
        if name in ("predict", "predict_proba", "decision_function",
                    "classes_"):
            return getattr(self.__dict__["model"], name)
        raise AttributeError(name)


class _SkClfAdapter(SkClf, _SkAdapter):
    pass


class _SkRegAdapter(SkReg, _SkAdapter):
    pass


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.RandomState(4)
    X = rng.randn(300, 6).astype(np.float32)
    y3 = np.digitize(X @ rng.randn(6) + 0.5 * rng.randn(300), [-0.7, 0.7])
    y2 = (X[:, 0] + 0.8 * rng.randn(300) > 0).astype(np.int64)
    yr = (X @ rng.randn(6) + 0.3 * rng.randn(300)).astype(np.float32)
    return {
        "multi": (LogisticRegression(max_iter=30, device="cpu").fit(X, y3),
                  X, y3),
        "binary": (LogisticRegression(max_iter=30, device="cpu").fit(X, y2),
                   X, y2),
        "forest": (RandomForestClassifier(n_estimators=4, max_depth=3,
                                          device="cpu").fit(X, y2), X, y2),
        "reg": (Ridge(device="cpu").fit(X, yr), X, yr),
    }


@pytest.mark.parametrize("name", sorted(HOST_SCORERS))
def test_host_scorer_matches_sklearn(fitted, name):
    if name in ("r2", "neg_mean_squared_error", "neg_root_mean_squared_error",
                "neg_mean_absolute_error"):
        cases = ["reg"]
    elif name == "roc_auc":
        cases = ["binary", "forest"]  # decision_function; predict_proba
    else:
        cases = ["multi", "binary"]
    for case in cases:
        model, X, y = fitted[case]
        adapter = (_SkRegAdapter if case == "reg" else _SkClfAdapter)(model)
        ours = Scorer(name)(model, X, y)
        theirs = get_scorer(name)(adapter, X, y)
        assert ours == pytest.approx(theirs, rel=1e-6, abs=1e-9), case


def test_scoring_resolution(fitted):
    model, X, y = fitted["multi"]
    scorers, multi = check_multimetric_scoring(model, None)
    assert not multi and scorers["score"](model, X, y) == model.score(X, y)
    scorers, multi = check_multimetric_scoring(model, _wrong)
    assert scorers == {"score": _wrong} and not multi
    scorers, multi = check_multimetric_scoring(
        model, {"a": "accuracy", "w": _wrong})
    assert multi and set(scorers) == {"a", "w"}
    scorers, multi = check_multimetric_scoring(model, ("accuracy", "f1_macro"))
    assert multi and list(scorers) == ["accuracy", "f1_macro"]
    with pytest.raises(ValueError, match="neg_log_loss"):
        check_multimetric_scoring(model, "precision")
    with pytest.raises(ValueError, match="Duplicate"):
        check_multimetric_scoring(model, ["accuracy", "accuracy"])
    with pytest.raises(ValueError, match="binary"):
        Scorer("roc_auc")(model, X, y)
    with pytest.raises(ValueError, match="continuous"):
        Scorer("accuracy")(fitted["reg"][0], fitted["reg"][1],
                           fitted["reg"][2])
    back = pickle.loads(pickle.dumps(Scorer("f1_weighted")))
    assert back(model, X, y) == Scorer("f1_weighted")(model, X, y)
