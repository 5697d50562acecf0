"""Naive Bayes of the port (``skdist_tpu_torch/models/naive_bayes.py``)
against the JAX package's (``skdist_tpu/models/naive_bayes.py``) on the
CPU, on the same numpy inputs made from a seed: the cases of
``tests/test_naive_bayes.py``, each held to the JAX package (and, where
that test reads it, to scikit-learn).

Tolerances (:func:`_hold`): fitted arrays and decisions within 1e-5 of
their largest magnitude, probabilities within 1e-5 of the largest
decision (closed-form float32 fits; the two packages' products and sums
differ only in summation order); predictions equal; search scores within
1e-5 (the searches' standing tolerance); converted models' decisions
within 1e-6 of the largest, their probabilities within 1e-6 of it.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.distribute.search import DistMultiModelSearch as JaxMM
from skdist_tpu.models import GaussianNB as JaxGNB
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import MultinomialNB as JaxMNB
from skdist_tpu_torch import (
    CUDABackend,
    DistGridSearchCV,
    DistMultiModelSearch,
    GaussianNB,
    LocalBackend,
    LogisticRegression,
    MultinomialNB,
    batch_predict,
    convert,
)
from skdist_tpu_torch.distribute.search import FitFailedWarning


def _cpu():
    return CUDABackend(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _hold(ref, ours, X):
    """Fitted arrays and decisions (joint log-likelihoods) within 1e-5 of
    their largest magnitude, probabilities within 1e-5 of the largest
    decision (a decision's rounding, a few ulps of its magnitude, moves
    a probability by at most that much), predictions equal. The Gaussian
    moments are centred on each package's own weighted mean, whose
    float32 rounding differs by summation order, so the class means
    (``gmean + means_c``) are compared, not their centred parts."""
    rp = {k: np.asarray(v) for k, v in ref._params.items()}
    op = {k: np.asarray(v) for k, v in ours._params.items()}
    for p in (rp, op):
        if "gmean" in p:
            p["means_c"] = p["means_c"] + p["gmean"]
    for k, v in rp.items():
        assert _rel(v, op[k]) <= 1e-5, k
    z = np.asarray(ref.decision_function(X))
    assert _rel(z, ours.decision_function(X)) <= 1e-5
    np.testing.assert_allclose(ours.predict_proba(X), ref.predict_proba(X),
                               rtol=0, atol=1e-5 * max(1.0, np.abs(z).max()))
    np.testing.assert_array_equal(ours.predict(X), ref.predict(X))


def _counts(seed=0, n=300, d=40):
    rng = np.random.RandomState(seed)
    X = rng.poisson(2.0, size=(n, d)).astype(np.float32)
    y = (X[:, :5].sum(1) > X[:, 5:10].sum(1)).astype(int)
    return X, y


def test_gaussian_nb_matches_jax_and_sklearn(clf_data):
    from sklearn.naive_bayes import GaussianNB as SkGNB

    X, y = clf_data
    ours = GaussianNB(device="cpu").fit(X, y)
    _hold(JaxGNB().fit(X, y), ours, X)
    sk = SkGNB().fit(X, y)
    np.testing.assert_allclose(ours.predict_proba(X), sk.predict_proba(X),
                               atol=1e-3)
    with pytest.raises(AttributeError):
        ours.coef_
    assert getattr(ours, "coef_", None) is None


def test_gaussian_nb_sample_weight(clf_data):
    X, y = clf_data
    w = np.random.RandomState(0).rand(len(y)).astype(np.float32)
    _hold(JaxGNB().fit(X, y, sample_weight=w),
          GaussianNB(device="cpu").fit(X, y, sample_weight=w), X)


def test_gaussian_nb_large_mean_stability():
    """The centred moments: |mean| >> std must not cancel the variance."""
    from sklearn.naive_bayes import GaussianNB as SkGNB

    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, 400)
    X = (1e4 + y[:, None] * 2.0 + rng.normal(size=(400, 4))).astype(
        np.float32)
    ours = GaussianNB(device="cpu").fit(X, y)
    _hold(JaxGNB().fit(X, y), ours, X)
    sk = SkGNB().fit(X.astype(np.float64), y)
    assert (ours.predict(X) == sk.predict(X)).mean() >= 0.98


def test_multinomial_nb_matches_jax_and_sklearn():
    from sklearn.naive_bayes import MultinomialNB as SkMNB

    X, y = _counts()
    ours = MultinomialNB(alpha=1.0, device="cpu").fit(X, y)
    ref = JaxMNB(alpha=1.0).fit(X, y)
    _hold(ref, ours, X)
    assert ours.coef_.shape == (2, 40)
    np.testing.assert_allclose(ours.coef_, ref.coef_, rtol=1e-5)
    np.testing.assert_allclose(ours.intercept_, ref.intercept_, rtol=1e-5)
    sk = SkMNB(alpha=1.0).fit(X, y)
    np.testing.assert_allclose(ours.predict_proba(X), sk.predict_proba(X),
                               atol=1e-3)


def test_multinomial_nb_alpha_zero_and_negative_input():
    rng = np.random.RandomState(0)
    X = rng.poisson(1.0, size=(100, 20)).astype(np.float32)
    X[:, 5] = 0.0  # a feature no class counts
    y = rng.randint(0, 2, 100)
    ours = MultinomialNB(alpha=0.0, device="cpu").fit(X, y)
    assert not np.isnan(ours.predict_proba(X)).any()
    _hold(JaxMNB(alpha=0.0).fit(X, y), ours, X)
    bad = np.array([[1.0, -1.0], [2.0, 3.0]], dtype=np.float32)
    with pytest.raises(ValueError, match="Negative"):
        MultinomialNB(device="cpu").fit(bad, [0, 1])


@pytest.mark.parametrize("kind", ["gaussian", "multinomial"])
def test_nb_search_matches_jax(clf_data, kind):
    """``var_smoothing``/``alpha`` ride the task axis of one batch."""
    X, y = clf_data
    if kind == "gaussian":
        grid = {"var_smoothing": [1e-9, 1e-3, 1e-1]}
        ref_est, est = JaxGNB(), GaussianNB(device="cpu")
    else:
        X = np.abs(X) * 10
        grid = {"alpha": [0.1, 1.0, 10.0]}
        ref_est, est = JaxMNB(), MultinomialNB(device="cpu")
    ref = JaxGrid(ref_est, grid, cv=3, scoring="accuracy").fit(X, y)
    ours = DistGridSearchCV(est, grid, cv=3, scoring="accuracy",
                            backend=_cpu()).fit(X, y)
    assert ours.round_stats_[0]["mode"] == "classic"
    for k in ref.cv_results_:
        if "test_score" in k:
            np.testing.assert_allclose(ours.cv_results_[k],
                                       ref.cv_results_[k], rtol=0,
                                       atol=1e-5, err_msg=k)
    assert ours.best_params_ == ref.best_params_
    _hold(ref.best_estimator_, ours.best_estimator_, X)
    # probabilities on the task axis: neg_log_loss
    ll = DistGridSearchCV(est, grid, cv=3, scoring="neg_log_loss",
                          backend=_cpu()).fit(X, y)
    ref_ll = JaxGrid(ref_est, grid, cv=3, scoring="neg_log_loss").fit(X, y)
    np.testing.assert_allclose(ll.cv_results_["mean_test_score"],
                               ref_ll.cv_results_["mean_test_score"],
                               rtol=1e-5)


def test_invalid_input_honors_error_score(clf_data):
    """A bucket whose data prep raises (negative counts) runs the generic
    path, where each task fails under ``error_score``."""
    X, y = clf_data  # has negatives: invalid for MultinomialNB
    gs = DistGridSearchCV(MultinomialNB(device="cpu"), {"alpha": [0.1, 1.0]},
                          cv=2, refit=False, scoring="accuracy",
                          error_score=np.nan, backend=_cpu())
    with pytest.warns(FitFailedWarning):
        with pytest.raises(RuntimeError, match="All candidate fits failed"):
            gs.fit(X, y)
    with pytest.raises(ValueError):
        DistGridSearchCV(MultinomialNB(device="cpu"), {"alpha": [1.0]}, cv=2,
                         scoring="accuracy", error_score="raise",
                         backend=_cpu()).fit(X, y)


def test_nb_in_multimodel_matches_jax(clf_data):
    X, y = clf_data
    ref = JaxMM([("lr", JaxLR(max_iter=50, engine="xla"), {"C": [0.1, 1.0]}),
                 ("nb", JaxGNB(), {})],
                n=2, cv=2, scoring="accuracy", random_state=0).fit(X, y)
    ours = DistMultiModelSearch(
        [("lr", LogisticRegression(max_iter=50, engine="xla", device="cpu"),
          {"C": [0.1, 1.0]}),
         ("nb", GaussianNB(device="cpu"), {})],
        n=2, cv=2, scoring="accuracy", random_state=0,
        backend=_cpu()).fit(X, y)
    assert "nb" in list(ours.cv_results_["model_name"])
    assert [st["round_stats"][0]["mode"] for st in ours.round_stats_] == [
        "classic", "classic"]
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], atol=1e-5)


def test_sparse_input_as_the_jax_package_takes_it():
    """CSR that the packed plane would take fails in the JAX package's
    kernels; the port raises a clear TypeError. CSR that it would not is
    densified, as there. Sparse rows to predict work."""
    rng = np.random.RandomState(0)
    wide = sp.random(2000, 2 ** 14, density=0.002, format="csr",
                     random_state=0, dtype=np.float32)
    yw = rng.randint(0, 3, 2000)
    for cls, jcls in ((GaussianNB, JaxGNB), (MultinomialNB, JaxMNB)):
        with pytest.raises(TypeError):
            jcls().fit(wide, yw)
        with pytest.raises(TypeError, match="packed"):
            cls(device="cpu").fit(wide, yw)
    X, y = _counts()
    X[X < 2] = 0
    Xs = sp.csr_matrix(X)
    for cls, jcls in ((GaussianNB, JaxGNB), (MultinomialNB, JaxMNB)):
        ours = cls(device="cpu").fit(Xs, y)
        _hold(jcls().fit(Xs, y), ours, X)
        np.testing.assert_allclose(ours.predict_proba(wide[:, :40]),
                                   ours.predict_proba(
                                       wide[:, :40].toarray()), atol=1e-6)


def test_batch_predict_pickle_and_convert(clf_data):
    import pickle

    X, y = clf_data
    Xc = np.abs(X) * 10
    for ref, ours, data in (
            (JaxGNB().fit(X, y), GaussianNB(device="cpu").fit(X, y), X),
            (JaxMNB().fit(Xc, y), MultinomialNB(device="cpu").fit(Xc, y),
             Xc)):
        direct = ours.predict_proba(data)
        np.testing.assert_allclose(
            batch_predict(ours, data, "predict_proba",
                          backend=LocalBackend(device="cpu"), batch_size=50),
            direct, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            batch_predict(ours, data, backend=LocalBackend(device="cpu")),
            ours.predict(data))
        loaded = pickle.loads(pickle.dumps(ours))
        np.testing.assert_array_equal(loaded.predict_proba(data), direct)
        conv = convert.naive_bayes_from_reference(ref, device="cpu")
        z = np.asarray(ref.decision_function(data))
        assert _rel(z, conv.decision_function(data)) <= 1e-6
        np.testing.assert_allclose(conv.predict_proba(data),
                                   ref.predict_proba(data), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(z).max()))
        np.testing.assert_array_equal(conv.predict(data), ref.predict(data))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="naive Bayes"):
            convert.naive_bayes_from_reference(JaxLR())
