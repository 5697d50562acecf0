"""The port's ``SimpleVoter`` (``skdist_tpu_torch/postprocessing.py``)
against the JAX package's (``skdist_tpu/postprocessing.py``) on the CPU.

Both voters are given the very same fitted members (port models fitted
on a seeded numpy problem, and stubs with fixed predictions), so the
votes must be equal exactly: hard and soft voting, weights, dropped
members, string labels and ties (to the lowest class index).
"""

import pickle
from unittest import mock

import numpy as np
import pytest

from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.postprocessing import SimpleVoter as JaxVoter
from skdist_tpu_torch import (
    GaussianNB,
    LogisticRegression,
    RidgeClassifier,
    SimpleVoter,
    convert,
)
from skdist_tpu_torch.postprocessing import Bunch


@pytest.fixture(scope="module")
def members():
    rng = np.random.RandomState(0)
    X = np.vstack([
        rng.normal(loc=c, scale=1.2, size=(60, 6)) for c in (-1.0, 0.0, 1.0)
    ]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    fitted = [
        ("lr", LogisticRegression(max_iter=50, C=0.1,
                                  device="cpu").fit(X, y)),
        ("rc", RidgeClassifier(device="cpu").fit(X, y)),
        ("nb", GaussianNB(device="cpu").fit(X, y)),
    ]
    return X, y, fitted


class _Stub:
    def __init__(self, preds):
        self._p = np.asarray(preds)

    def predict(self, X):
        return self._p[: len(X)]


@pytest.mark.parametrize("weights", [None, [0.2, 0.5, 0.3], [3.0, 1.0, 1.0]])
def test_hard_vote_matches_jax(members, weights):
    X, y, fitted = members
    ours = SimpleVoter(fitted, classes=np.arange(3), voting="hard",
                       weights=weights).fit(X, y)
    theirs = JaxVoter(fitted, classes=np.arange(3), voting="hard",
                      weights=weights).fit(X, y)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    assert ours.score(X, y) == theirs.score(X, y)
    with pytest.raises(AttributeError):
        ours.predict_proba(X)


@pytest.mark.parametrize("weights", [None, [0.7, 0.3]])
def test_soft_vote_matches_jax(members, weights):
    X, y, fitted = members
    pair = [fitted[0], fitted[2]]  # the members with predict_proba
    ours = SimpleVoter(pair, classes=np.arange(3), voting="soft",
                       weights=weights)
    theirs = JaxVoter(pair, classes=np.arange(3), voting="soft",
                      weights=weights)
    np.testing.assert_array_equal(ours.predict_proba(X),
                                  theirs.predict_proba(X))
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    w = np.ones(2) if weights is None else np.asarray(weights)
    expect = (w[0] * pair[0][1].predict_proba(X)
              + w[1] * pair[1][1].predict_proba(X)) / w.sum()
    np.testing.assert_allclose(ours.predict_proba(X), expect, atol=1e-12)


def test_weights_ties_and_dropped_members():
    X = np.zeros((4, 2))
    classes = np.array([0, 1, 2])
    a = _Stub([1, 1, 0, 2])
    b = _Stub([2, 1, 1, 0])
    c = _Stub([2, 0, 1, 0])
    cases = [
        ([("a", a), ("b", b), ("c", c)], [2.0, 0.9, 0.9], [1, 1, 0, 2]),
        ([("a", a), ("b", b)], None, [1, 1, 0, 0]),  # ties: lowest class
        ([("a", a), ("b", "drop"), ("c", c)], [1.0, 100.0, 3.0],
         [2, 0, 1, 0]),
        ([("a", a), ("b", None), ("c", c)], [1.0, 100.0, 3.0],
         [2, 0, 1, 0]),
    ]
    for est, weights, expect in cases:
        ours = SimpleVoter(est, classes, voting="hard", weights=weights)
        theirs = JaxVoter(est, classes, voting="hard", weights=weights)
        np.testing.assert_array_equal(ours.predict(X), expect)
        np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
        assert len(ours.estimators_) == len(theirs.estimators_)
    # one bincount, never a per-row loop
    with mock.patch("numpy.apply_along_axis",
                    side_effect=AssertionError("per-row vote loop")):
        ours.predict(X)


def test_string_labels_and_unseen_label():
    rng = np.random.RandomState(0)
    X = np.vstack([rng.normal(loc=c, scale=0.5, size=(40, 5))
                   for c in (-2.0, 2.0)]).astype(np.float32)
    y = np.repeat(["pizza", "tacos"], 40)
    m1 = LogisticRegression(max_iter=100, device="cpu").fit(X, y)
    m2 = RidgeClassifier(device="cpu").fit(X, y)
    for voting, est in (("hard", [("a", m1), ("b", m2)]),
                        ("soft", [("a", m1), ("b", m1)])):
        ours = SimpleVoter(est, classes=m1.classes_, voting=voting)
        theirs = JaxVoter(est, classes=m1.classes_, voting=voting)
        preds = ours.predict(X)
        assert preds.dtype == y.dtype and (preds == y).all()
        np.testing.assert_array_equal(preds, theirs.predict(X))
    bad = SimpleVoter([("a", _Stub(["pizza", "sushi"]))],
                      classes=m1.classes_)
    with pytest.raises(ValueError, match="unseen labels"):
        bad.predict(X[:2])
    bad_int = SimpleVoter([("a", _Stub([0, 5]))], classes=np.arange(3))
    with pytest.raises(ValueError, match="unseen labels"):
        bad_int.predict(X[:2])


def test_named_estimators_and_pickle(members):
    X, y, fitted = members
    voter = SimpleVoter(fitted, classes=np.arange(3))
    named = voter.named_estimators
    assert isinstance(named, Bunch) and named.lr is fitted[0][1]
    assert set(named) == {"lr", "rc", "nb"}
    loaded = pickle.loads(pickle.dumps(voter))
    np.testing.assert_array_equal(loaded.predict(X), voter.predict(X))


def test_voter_from_reference():
    rng = np.random.RandomState(1)
    X = rng.normal(size=(120, 4)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=120) > 0).astype(int)
    a = JaxLR(max_iter=50, C=0.1, engine="xla").fit(X, y)
    b = JaxLR(max_iter=50, C=10.0, engine="xla").fit(X, y)
    ref = JaxVoter([("a", a), ("x", "drop"), ("b", b)], classes=a.classes_,
                   voting="soft", weights=[1.0, 5.0, 2.0])
    ours = convert.voter_from_reference(ref, device="cpu")
    assert isinstance(ours, SimpleVoter) and len(ours.estimators_) == 2
    np.testing.assert_allclose(ours.predict_proba(X), ref.predict_proba(X),
                               atol=1e-6)
    np.testing.assert_array_equal(ours.predict(X), ref.predict(X))
