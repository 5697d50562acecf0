"""The port's streamed scorers, streamed search, one-vs-rest and one-vs-one
over a ``ChunkedDataset`` (``skdist_tpu_torch/metrics.py STREAM_SCORERS``,
``distribute/search.py``, ``distribute/multiclass.py``) against the JAX
package's, on the CPU, on the same numpy inputs made from a seed, and
against the port's own resident search.

Tolerances: each ``STREAM_SCORERS`` statistic within 1e-5 of the JAX
package's block-stats kernel (float32 sums of the same terms), each
combine within 1e-6; ``cv_results_`` score columns within 1e-5 of the
JAX package's streamed search and of the port's resident search (block
sums reorder the float32 reductions), ``best_params_`` equal;
one-vs-rest and one-vs-one predictions equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu import data as jdata
from skdist_tpu import metrics as jm
from skdist_tpu.distribute.multiclass import DistOneVsOneClassifier as JaxOvO
from skdist_tpu.distribute.multiclass import DistOneVsRestClassifier as JaxOvR
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import Ridge as JaxRidge
from skdist_tpu.models import RidgeClassifier as JaxRidgeClf
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import (
    CUDABackend,
    DistGridSearchCV,
    DistMultiModelSearch,
    DistOneVsOneClassifier,
    DistOneVsRestClassifier,
    DistRandomizedSearchCV,
)
from skdist_tpu_torch import metrics as tm
from skdist_tpu_torch.data import ChunkedDataset
from skdist_tpu_torch.models import (
    GaussianNB,
    LogisticRegression,
    Ridge,
    RidgeClassifier,
    SGDClassifier,
)

torch = pytest.importorskip("torch")

#: the L-BFGS family's settings: converged fits whose tol the float32
#: sums reach (as in ``tests/test_torch_streaming.py``)
LR = dict(tol=1e-3, max_iter=60)
SGD = dict(shuffle=False, batch_size=32, max_iter=6, tol=None)


def _clf(n=420, d=10, k=3, seed=0, sparse=False):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    centres = rng.normal(scale=1.5, size=(k, d))
    X = (centres[y] + rng.normal(size=(n, d))).astype(np.float32)
    if sparse:
        X = sp.csr_matrix(X * (rng.rand(n, d) < 0.5))
    return X, y


def _weights(n, seed=1):
    return np.random.RandomState(seed).uniform(0.2, 2.0, n).astype(
        np.float32)


def _backend():
    return CUDABackend(device="cpu")


# --------------------------------------------------------------------------
# the streamed scorers
# --------------------------------------------------------------------------

def _scorer_inputs(metric, T=3, n=90, seed=0):
    """``(y, out, w, meta)`` for one metric, ``out`` and ``w`` with a lane
    axis: a binary decision for f1, three-class decisions (or
    probabilities for neg_log_loss) for the other classification
    metrics, predictions for the regression ones."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(0, 2, (T, n)).astype(np.float32)
    w[:, ::7] = 0.0  # rows out of a fold
    kind = tm.STREAM_SCORERS[metric][2]
    if kind == "predict":
        y = rng.normal(size=n).astype(np.float32)
        out = (y + rng.normal(scale=0.5, size=(T, n))).astype(np.float32)
        return y, out, w, {}
    k = 2 if metric == "f1" else 3
    y = rng.randint(0, k, n).astype(np.int32)
    if kind == "proba":
        z = rng.normal(size=(T, n, k))
        out = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(
            np.float32)
    elif k == 2:
        out = rng.normal(size=(T, n)).astype(np.float32)
    else:
        out = rng.normal(size=(T, n, k)).astype(np.float32)
    return y, out, w, {"n_classes": k}


@pytest.mark.parametrize("metric", sorted(tm.STREAM_SCORERS))
def test_stream_scorer_matches_jax(metric):
    assert set(tm.STREAM_SCORERS) == set(jm.STREAM_SCORERS)
    assert "roc_auc" not in tm.STREAM_SCORERS
    y, out, w, meta = _scorer_inputs(metric)
    kernel, combine, kind = tm.STREAM_SCORERS[metric]
    jkernel, jcombine, jkind = jm.STREAM_SCORERS[metric]
    assert kind == jkind
    ours = kernel(torch.as_tensor(y), torch.as_tensor(out),
                  torch.as_tensor(w), meta)
    for t in range(w.shape[0]):
        ref = jkernel(jnp.asarray(y), jnp.asarray(out[t]), jnp.asarray(w[t]),
                      meta)
        assert set(ref) == set(ours)
        mine = {s: v[t].numpy() for s, v in ours.items()}
        for s, v in ref.items():
            v = np.asarray(v)
            np.testing.assert_allclose(mine[s], v, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(v).max()))
        assert combine(mine, meta) == pytest.approx(
            jcombine({s: np.asarray(v) for s, v in ref.items()}, meta),
            rel=1e-6, abs=1e-6)


def test_stream_scoring_resolution_refuses():
    from skdist_tpu_torch.distribute.search import _resolve_stream_scoring

    clf, reg = LogisticRegression(device="cpu"), Ridge(device="cpu")
    assert _resolve_stream_scoring(clf, None) == [("score", "accuracy")]
    assert _resolve_stream_scoring(reg, ["r2", "neg_mean_absolute_error"]) \
        == [("r2", "r2"), ("neg_mean_absolute_error",
                           "neg_mean_absolute_error")]
    assert _resolve_stream_scoring(clf, "f1", np.array([0, 1]))
    for scoring, est, y, match in [
            ("roc_auc", clf, None, "no streamed"),
            (lambda e, X, y: 0.0, clf, None, "callable"),
            ("r2", clf, None, "does not fit"),
            ("balanced_accuracy", reg, None, "does not fit"),
            ("f1", clf, np.array([0, 1, 2]), "binary-only")]:
        with pytest.raises(ValueError, match=match):
            _resolve_stream_scoring(est, scoring, y)


# --------------------------------------------------------------------------
# the streamed search
# --------------------------------------------------------------------------

SEARCHES = {  # family -> (JAX estimator, port estimator, grid, scoring)
    "lbfgs": (JaxLR(engine="xla", **LR),
              LogisticRegression(engine="xla", device="cpu", **LR),
              {"C": [0.1, 1.0]},
              ["accuracy", "f1_weighted", "neg_log_loss",
               "balanced_accuracy"]),
    "gram": (JaxRidgeClf(), RidgeClassifier(device="cpu"),
             {"alpha": [0.1, 10.0]},
             ["accuracy", "f1_macro", "precision_weighted",
              "recall_weighted"]),
    "sgd": (JaxSGD(loss="log_loss", **SGD),
            SGDClassifier(loss="log_loss", device="cpu", **SGD),
            {"alpha": [1e-4, 1e-2]}, ["accuracy", "f1_micro",
                                      "neg_log_loss"]),
}


def _score_columns(res):
    return [k for k in res if k.startswith(("split", "mean_test",
                                            "mean_train", "std_test"))
            and "time" not in k]


def _hold_results(ours, other, atol=1e-5):
    for key in _score_columns(other.cv_results_):
        np.testing.assert_allclose(
            np.asarray(ours.cv_results_[key], float),
            np.asarray(other.cv_results_[key], float), rtol=0, atol=atol,
            err_msg=key)
    assert ours.best_params_ == other.best_params_


@pytest.fixture(scope="module")
def search_data():
    """Weighted 3-class data of 420 rows in blocks of 128 (a padded tail):
    the JAX package's and the port's datasets of it."""
    X, y = _clf(n=420, k=3)
    sw = _weights(420)
    return (X, y, sw, jdata.ChunkedDataset.from_arrays(X, y, sw,
                                                        block_rows=128),
            ChunkedDataset.from_arrays(X, y, sw, block_rows=128))


@pytest.mark.parametrize("family", sorted(SEARCHES))
def test_streamed_search_matches_jax_and_resident(search_data, family):
    X, y, sw, jds, ds = search_data
    jest, est, grid, scoring = SEARCHES[family]
    kw = dict(cv=3, scoring=scoring, refit="accuracy",
              return_train_score=True)
    ref = JaxGrid(jest, grid, backend=TPUBackend(), **kw).fit(jds)
    ours = DistGridSearchCV(est, grid, backend=_backend(), **kw).fit(ds)
    resident = DistGridSearchCV(est, grid, backend=_backend(), **kw).fit(
        X, y, sample_weight=sw)
    _hold_results(ours, ref)
    _hold_results(ours, resident)
    st = ours.round_stats_[0]
    assert (st["mode"], st["score_passes"], st["tasks"]) == (
        "streamed", 1, 6)
    # the refit streamed the best candidate over the dataset
    assert ours.best_estimator_.stream_stats_["tasks"] == 1
    np.testing.assert_array_equal(ours.predict(ds), ours.predict(X))


def test_streamed_regression_search_and_sample_weight():
    rng = np.random.RandomState(2)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    y = (X @ rng.normal(size=8) + 0.3 * rng.normal(size=300)).astype(
        np.float32)
    sw = _weights(300, seed=4)
    jds = jdata.ChunkedDataset.from_arrays(X, y, block_rows=64)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=64)
    scoring = ["r2", "neg_mean_squared_error", "neg_root_mean_squared_error",
               "neg_mean_absolute_error"]
    kw = dict(cv=3, scoring=scoring, refit="r2")
    grid = {"alpha": [0.1, 10.0]}
    # a full-length sample_weight fit param weighs the fits, not the scores
    ref = JaxGrid(JaxRidge(), grid, backend=TPUBackend(), **kw).fit(
        jds, sample_weight=sw)
    ours = DistRandomizedSearchCV(Ridge(device="cpu"), grid, n_iter=2,
                                  random_state=0, backend=_backend(),
                                  **kw).fit(ds, sample_weight=sw)
    ours_grid = DistGridSearchCV(Ridge(device="cpu"), grid,
                                 backend=_backend(), **kw).fit(
        ds, sample_weight=sw)
    _hold_results(ours_grid, ref)
    assert ours.best_params_ == ref.best_params_
    resident = DistGridSearchCV(Ridge(device="cpu"), grid,
                                backend=_backend(), **kw).fit(
        X, y, sample_weight=sw)
    _hold_results(ours_grid, resident)


def test_streamed_search_refusals(search_data):
    from skdist_tpu_torch.distribute.adaptive import HalvingSpec
    from skdist_tpu_torch.utils.cv import KFold

    X, y, _sw, _jds, ds = search_data
    est = LogisticRegression(device="cpu", max_iter=5)

    def search(e=est, **kw):
        return DistGridSearchCV(e, {"C": [1.0]}, backend=_backend(),
                                **{"cv": 3, **kw})

    with pytest.raises(ValueError, match="preds=True"):
        search(preds=True).fit(ds)
    with pytest.raises(ValueError, match="engine='host'"):
        search(LogisticRegression(engine="host", device="cpu")).fit(ds)
    with pytest.raises(ValueError, match="no streamed fit path"):
        DistGridSearchCV(GaussianNB(device="cpu"), {"var_smoothing": [1e-9]},
                         backend=_backend(), cv=3).fit(ds)
    with pytest.raises(NotImplementedError, match="item 10"):
        search().fit(ds, checkpoint_dir="x")
    with pytest.raises(NotImplementedError, match="item 9c"):
        search(adaptive=HalvingSpec(eta=3)).fit(ds)
    with pytest.raises(ValueError, match="no streamed"):
        search(scoring="roc_auc").fit(ds)
    overlapping = [(np.arange(100, 420), np.arange(0, 200)),
                   (np.arange(0, 100), np.arange(100, 420))]
    with pytest.raises(ValueError, match="partition-style"):
        search(cv=overlapping).fit(ds)
    with pytest.raises(ValueError, match="partition-style"):
        search(cv=[(np.arange(200, 420), np.arange(0, 100))]).fit(ds)
    with pytest.raises(ValueError, match="sample_weight"):
        search().fit(ds, sample_weight=np.ones(5))
    with pytest.raises(ValueError, match="batchable"):
        DistGridSearchCV(est, {"fit_intercept": [True], "verbose": [0]},
                         backend=_backend(), cv=3).fit(ds)
    with pytest.raises(ValueError, match="not support"):
        DistMultiModelSearch([("lr", est, {"C": [1.0]})], n=1,
                             backend=_backend()).fit(ds, y)
    # KFold over the dataset's own labels works without y
    gs = search(cv=KFold(3)).fit(ds)
    assert gs.round_stats_[0]["tasks"] == 3
    with pytest.raises(NotImplementedError, match="multi-target"):
        DistGridSearchCV(Ridge(device="cpu"), {"alpha": [1.0]},
                         backend=_backend(), cv=3).fit(
            ds, np.zeros((len(y), 2), np.float32))


@pytest.mark.parametrize("error_score", [np.nan, "raise"])
def test_streamed_search_quarantines_nonfinite_lanes(error_score):
    """A lane whose solve fails (a negative alpha: no Cholesky factor, so
    NaN weights) scores ``error_score`` with a warning, or raises, as on
    the resident search."""
    from skdist_tpu_torch.distribute.search import FitFailedWarning

    rng = np.random.RandomState(2)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    y = (X @ rng.normal(size=8)).astype(np.float32)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=64)
    search = DistGridSearchCV(Ridge(device="cpu"), {"alpha": [1.0, -1e6]},
                              cv=3, scoring="r2", error_score=error_score,
                              backend=_backend())
    if error_score == "raise":
        with pytest.raises(RuntimeError, match="non-finite"):
            search.fit(ds)
        return
    with pytest.warns(FitFailedWarning, match="3 of 6"):
        search.fit(ds)
    mean = search.cv_results_["mean_test_score"]
    assert np.isfinite(mean[0]) and np.isnan(mean[1])
    assert search.best_params_ == {"alpha": 1.0}


# --------------------------------------------------------------------------
# one-vs-rest and one-vs-one
# --------------------------------------------------------------------------

MULTI = {
    "lbfgs": (JaxLR(engine="xla", **LR),
              LogisticRegression(engine="xla", device="cpu", **LR)),
    "gram": (JaxRidgeClf(), RidgeClassifier(device="cpu")),
    "sgd": (JaxSGD(loss="log_loss", **SGD),
            SGDClassifier(loss="log_loss", device="cpu", **SGD)),
}


@pytest.fixture(scope="module")
def multi_data():
    X, y = _clf(n=360, k=3, seed=3, sparse=True)
    labels = np.array(["a", "b", "c"])[y]
    return (X, labels,
            jdata.ChunkedDataset.from_arrays(X, labels, block_rows=128,
                                             pack=True),
            ChunkedDataset.from_arrays(X, labels, block_rows=128, pack=True))


@pytest.mark.parametrize("family", sorted(MULTI))
@pytest.mark.parametrize("kind", ["ovr", "ovo"])
def test_streamed_multiclass_predicts_as_jax(multi_data, family, kind):
    X, labels, jds, ds = multi_data
    jest, est = MULTI[family]
    jcls, cls = ((JaxOvR, DistOneVsRestClassifier) if kind == "ovr"
                 else (JaxOvO, DistOneVsOneClassifier))
    ref = jcls(jest, backend=TPUBackend()).fit(jds)
    ours = cls(est).fit(ds)
    pred = ours.predict(ds)
    np.testing.assert_array_equal(pred, ref.predict(X.toarray()))
    np.testing.assert_array_equal(pred, ours.predict(X))
    assert ours.round_stats_[0]["tasks"] == 3  # classes, or pairs
    assert len(ours.estimators_) == 3


def test_streamed_binary_ovr_and_guards(multi_data):
    X, labels, _jds, ds = multi_data
    two = np.where(labels == "a", "a", "z")
    dsb = ChunkedDataset.from_arrays(X, two, block_rows=128, pack=True)
    ovr = DistOneVsRestClassifier(RidgeClassifier(device="cpu")).fit(dsb)
    assert ovr.binary_ and len(ovr.estimators_) == 1
    np.testing.assert_array_equal(
        ovr.predict(dsb),
        DistOneVsRestClassifier(RidgeClassifier(device="cpu")).fit(
            X, two).predict(X))
    lr = LogisticRegression(device="cpu", max_iter=5)
    for cls in (DistOneVsRestClassifier, DistOneVsOneClassifier):
        for est, match in [
                (LogisticRegression(class_weight={"a": 2.0}, device="cpu"),
                 "class_weight"),
                (LogisticRegression(engine="host", device="cpu"),
                 "engine='host'"),
                (GaussianNB(device="cpu"), "no streamed fit")]:
            with pytest.raises(ValueError, match=match):
                cls(est).fit(ds)
        with pytest.raises(ValueError, match="1-D"):
            cls(lr).fit(ds, np.zeros((360, 2)))
        with pytest.raises(ValueError, match="sample_weight"):
            cls(lr).fit(ds, sample_weight=np.ones(3))
    with pytest.raises(ValueError, match="max_negatives"):
        DistOneVsRestClassifier(lr, max_negatives=0.5).fit(ds)
