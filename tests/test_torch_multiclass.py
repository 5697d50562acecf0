"""The port's ``DistOneVsRestClassifier`` and ``DistOneVsOneClassifier``
against the JAX package's on the same seeded numpy inputs: the batched
path on its classic regime (5 classes: 5 class lanes, 10 pair lanes)
and its compacted regime (8 classes: 28 pair lanes; 25 classes: 25 class
lanes), dense and packed X, over ``LinearSVC``, ``LogisticRegression``
and ``RidgeClassifier``; the two-class (``binary_``), multilabel, string
label, degenerate-column, ``norm``, ``max_negatives``, ``sample_weight``
and dict ``class_weight`` (the generic loop) cases; the keep masks; the
pickle round trip; the port's own label binarizer and row normaliser
against scikit-learn's; and the conversion of fitted JAX models.

The JAX estimators are pinned to ``engine="xla"``: with dense X on a CPU
platform its meta-estimators would otherwise send them to the f64 host
engine, which the port does not have (ROADMAP Queue 3).

Tolerances: predictions equal; ``decision_function`` and
``predict_proba`` within 1e-5 (the binary fits agree to ~3e-7 of
max|coef_| at C = 0.03, tol = 1e-2, tests/test_torch_svc.py); converted
models' decisions within 1e-6. Packed X is held on the 5-class
one-vs-rest and one-vs-one, the ridge and the converted models. The
packed one-vs-rest runs at C = 0.01: at C = 0.03 each class's lane over
this small hashed text (1024 columns, 240 rows) sits near separability,
where the float32 summation order alone moves a decision by ~3e-4 in
either package; at C = 0.01 the two packages' decisions agree to ~1e-6
with equal ``n_iter_``.
Bitwise contracts of the port alone: the keep masks equal the JAX
package's, and compacted and classic fits give every pair the same
weights at equal round size, also when the pairs do not fill whole
rounds.
"""

import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.preprocessing import MultiLabelBinarizer, normalize

from bench import make_20news_sparse
from skdist_tpu.distribute import multiclass as jmc
from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import RidgeClassifier as JaxRidge
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.convert import multiclass_from_reference
from skdist_tpu_torch.distribute import multiclass as tmc
from skdist_tpu_torch.distribute.search import DistGridSearchCV
from skdist_tpu_torch.models import (
    DecisionTreeClassifier,
    LinearSVC,
    LogisticRegression,
    RidgeClassifier,
)

SVC = dict(C=0.03, tol=1e-2, max_iter=300)
LR = dict(C=0.1, tol=1e-2, max_iter=300)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run shares the host's cores among
    its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(k, sparse=False, n=240, seed=0):
    if sparse:
        return make_20news_sparse(seed=seed, n=n, d=1024, nnz_row=16, k=k)
    rng = np.random.RandomState(seed + k)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    y = (X @ rng.normal(size=(10, k)) + 0.5 * rng.normal(size=(n, k))).argmax(1)
    return X, y


def _port(kind, base):
    cls = (tmc.DistOneVsRestClassifier if kind == "ovr"
           else tmc.DistOneVsOneClassifier)
    return cls(base)


def _jax(kind, base, **kw):
    cls = jmc.DistOneVsRestClassifier if kind == "ovr" else \
        jmc.DistOneVsOneClassifier
    return cls(base, backend=TPUBackend(), **kw)


def _assert_same(port, ref, X, proba=False):
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_allclose(port.decision_function(X),
                               ref.decision_function(X), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    if proba:
        np.testing.assert_allclose(port.predict_proba(X),
                                   ref.predict_proba(X), rtol=0, atol=ATOL)


REGIMES = [  # (kind, classes, sparse X, the port's path)
    ("ovr", 5, False, "classic"),
    ("ovr", 5, True, "classic"),
    ("ovo", 5, True, "classic"),
    ("ovr", 8, False, "classic"),
    ("ovo", 8, False, "compacted"),
    ("ovr", 25, False, "compacted"),
]


@pytest.mark.parametrize("kind,k,sparse,mode", REGIMES)
def test_linear_svc_matches_jax(kind, k, sparse, mode):
    X, y = _data(k, sparse, n=400 if k == 25 else 240)
    svc = dict(SVC, C=0.01) if kind == "ovr" and sparse else SVC
    port = _port(kind, LinearSVC(device="cpu", **svc)).fit(X, y)
    ref = _jax(kind, JaxSVC(engine="xla", **svc)).fit(X, y)
    st = port.round_stats_[0]
    assert st["mode"] == mode
    assert st["x_format"] == ("packed" if sparse else "dense")
    assert len(port.estimators_) == (k if kind == "ovr" else k * (k - 1) // 2)
    for a, b in zip(port.estimators_, ref.estimators_):
        assert int(a.n_iter_) == int(b._params["n_iter"])
    _assert_same(port, ref, X)


@pytest.mark.parametrize("kind", ["ovr", "ovo"])
def test_logistic_regression_and_sample_weight_match_jax(kind):
    X, y = _data(4)
    sw = np.random.RandomState(1).uniform(0.5, 2.0, len(y)).astype(np.float32)
    port = _port(kind, LogisticRegression(device="cpu", **LR)).fit(
        X, y, sample_weight=sw)
    ref = _jax(kind, JaxLR(engine="xla", **LR)).fit(X, y, sample_weight=sw)
    _assert_same(port, ref, X, proba=kind == "ovr")


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_norm_and_binary_match_jax(norm):
    X, y = _data(3)
    port = tmc.DistOneVsRestClassifier(LogisticRegression(device="cpu", **LR),
                                       norm=norm).fit(X, y)
    ref = _jax("ovr", JaxLR(engine="xla", **LR), norm=norm).fit(X, y)
    _assert_same(port, ref, X, proba=True)
    np.testing.assert_allclose(np.abs(port.predict_proba(X)).sum(1)
                               if norm == "l1" else
                               np.sqrt((port.predict_proba(X) ** 2).sum(1)),
                               1.0, rtol=1e-6)
    yb = (y == 1).astype(np.int64)
    port = tmc.DistOneVsRestClassifier(LinearSVC(device="cpu", **SVC)).fit(X, yb)
    ref = _jax("ovr", JaxSVC(engine="xla", **SVC)).fit(X, yb)
    assert port.binary_ and len(port.estimators_) == 1
    assert port.decision_function(X).ndim == 1
    _assert_same(port, ref, X)


def test_ridge_classifier_matches_jax():
    X, y = _data(4, sparse=True)
    port = _port("ovr", RidgeClassifier(alpha=3.0, device="cpu")).fit(X, y)
    ref = _jax("ovr", JaxRidge(alpha=3.0)).fit(X, y)
    assert port.round_stats_[0]["x_format"] == "packed"
    _assert_same(port, ref, X)


def test_string_labels_and_multilabel_match_jax():
    X, y = _data(4)
    names = np.array(["ant", "bee", "cat", "dog"])[y]
    port = _port("ovo", LinearSVC(device="cpu", **SVC)).fit(X, names)
    ref = _jax("ovo", JaxSVC(engine="xla", **SVC)).fit(X, names)
    _assert_same(port, ref, X)
    assert port.predict(X).dtype.kind == "U"
    # an indicator matrix with an empty column, and sequences of labels
    Y = np.stack([y == 0, y == 1, np.zeros_like(y), (y == 2) | (y == 3)],
                 1).astype(int)
    with pytest.warns(UserWarning, match="present in no training examples"):
        port = _port("ovr", LinearSVC(device="cpu", **SVC)).fit(X, Y)
    with pytest.warns(UserWarning, match="present in no training examples"):
        ref = _jax("ovr", JaxSVC(engine="xla", **SVC)).fit(X, Y)
    assert port.multilabel_ and isinstance(port.estimators_[2],
                                           tmc._ConstantPredictor)
    _assert_same(port, ref, X)
    seqs = [tuple(np.flatnonzero(row) * 10) for row in Y]
    port = _port("ovr", LinearSVC(device="cpu", **SVC)).fit(X, seqs)
    ref = _jax("ovr", JaxSVC(engine="xla", **SVC)).fit(X, seqs)
    np.testing.assert_array_equal(port.classes_, [0, 10, 30])
    _assert_same(port, ref, X)


@pytest.mark.parametrize("max_negatives,method", [
    (0.3, "ratio"), (25, "ratio"), (2.0, "multiplier")])
def test_keep_masks_and_down_sampled_fits_match_jax(max_negatives, method):
    X, y = _data(5)
    Y, _, _ = tmc._label_matrix(y)
    live = np.arange(Y.shape[1])
    kw = dict(max_negatives=max_negatives, method=method, random_state=4)
    port = tmc.DistOneVsRestClassifier(LinearSVC(device="cpu", **SVC), **kw)
    ref = _jax("ovr", JaxSVC(engine="xla", **SVC), **kw)
    masks = port._exact_keep_masks(Y, live)
    assert masks.dtype == np.uint8 and masks.shape == Y.T.shape
    np.testing.assert_array_equal(masks, ref._exact_keep_masks(Y, live))
    assert (masks.sum(1) < len(y)).all()
    _assert_same(port.fit(X, y), ref.fit(X, y), X)


def test_dict_class_weight_takes_the_generic_loop():
    X, y = _data(3)
    cw = {0: 2.0, 1: 0.5}
    port = _port("ovr", LinearSVC(device="cpu", engine="xla",
                                  class_weight=cw, **SVC)).fit(X, y)
    ref = _jax("ovr", JaxSVC(engine="xla", class_weight=cw, **SVC)).fit(X, y)
    assert not hasattr(port, "round_stats_")
    _assert_same(port, ref, X)
    port = _port("ovo", LinearSVC(device="cpu", engine="xla",
                                  class_weight=cw, **SVC)).fit(X, y)
    ref = _jax("ovo", JaxSVC(engine="xla", class_weight=cw, **SVC)).fit(X, y)
    _assert_same(port, ref, X)


def test_a_tree_takes_the_generic_loop():
    X, y = _data(3)
    ovr = _port("ovr", DecisionTreeClassifier(max_depth=3, device="cpu"))
    ovr.fit(X, y)
    for c, est in enumerate(ovr.estimators_):
        alone = DecisionTreeClassifier(max_depth=3, device="cpu").fit(
            X, (y == c).astype(np.int32))
        np.testing.assert_array_equal(est.predict_proba(X),
                                      alone.predict_proba(X))
    np.testing.assert_array_equal(
        ovr.predict(X),
        np.argmax(np.column_stack([e.predict_proba(X)[:, 1]
                                   for e in ovr.estimators_]), 1))


def test_nested_search_is_unwrapped_with_string_results():
    X, y = _data(3)
    search = DistGridSearchCV(LinearSVC(device="cpu", **SVC),
                              {"C": [0.01, 0.03]}, cv=3,
                              backend=CUDABackend(device="cpu"))
    ovr = _port("ovr", search).fit(X, y)
    est = ovr.estimators_[0]
    assert isinstance(est, LinearSVC)
    fitted = DistGridSearchCV(LinearSVC(device="cpu", **SVC),
                              {"C": [0.01, 0.03]}, cv=3,
                              backend=CUDABackend(device="cpu")).fit(
        X, (y == 0).astype(np.int32))
    frame = pd.DataFrame(fitted.cv_results_)
    expect = {c: frame[c].astype(str).tolist() for c in frame.columns}
    assert tmc._cv_results_as_strings(fitted.cv_results_) == expect
    assert set(est.cv_results_) == set(expect)


@pytest.mark.parametrize("partitions", [7, 3])
def test_compacted_and_classic_are_bitwise_equal(monkeypatch, partitions):
    """28 pairs at 4 (whole rounds) and at 10 a round (a short last
    round, which the classic path pads to the round's shape)."""
    X, y = _data(8, sparse=True)
    fits = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SKDIST_COMPACTION", flag)
        ovo = tmc.DistOneVsOneClassifier(LinearSVC(device="cpu", **SVC),
                                         partitions=partitions).fit(X, y)
        fits[flag] = ovo
    comp, classic = fits["1"], fits["0"]
    assert comp.round_stats_[0]["mode"] == "compacted"
    assert classic.round_stats_[0]["mode"] == "classic"
    assert classic.round_stats_[0]["tasks_per_round"] == \
        comp.round_stats_[0]["chunk"]
    for a, b in zip(comp.estimators_, classic.estimators_):
        assert np.array_equal(a._params["W"], b._params["W"])


def test_pickle_round_trip():
    X, y = _data(4, sparse=True)
    for kind in ("ovr", "ovo"):
        model = _port(kind, LinearSVC(device="cpu", **SVC)).fit(X, y)
        loaded = pickle.loads(pickle.dumps(model))
        np.testing.assert_array_equal(loaded.predict(X), model.predict(X))
        np.testing.assert_array_equal(loaded.decision_function(X),
                                      model.decision_function(X))
        assert loaded.n_classes_ == 4


def test_binarizer_and_normaliser_match_sklearn():
    rng = np.random.RandomState(0)
    for labels in ([3, 1, 7], ["b", "a", "c"]):
        seqs = [set(rng.choice(labels, size=rng.randint(0, 3), replace=False))
                for _ in range(30)]
        Y, classes = tmc._binarize_multilabel(seqs)
        mlb = MultiLabelBinarizer()
        np.testing.assert_array_equal(Y, mlb.fit_transform(seqs))
        np.testing.assert_array_equal(classes, mlb.classes_)
        assert classes.dtype == mlb.classes_.dtype
    S = rng.rand(20, 5).astype(np.float32)
    S[3] = 0.0
    for norm in ("l1", "l2", "max"):
        for A in (S, S.astype(np.float64)):
            np.testing.assert_array_equal(tmc._normalize_rows(A, norm),
                                          normalize(A, norm=norm))
    with pytest.raises(ValueError, match="norm"):
        tmc._normalize_rows(S, "l3")


def test_converted_jax_models_decide_the_same():
    X, y = _data(4, sparse=True)
    Y = np.stack([y == 0, y == 1, np.ones_like(y), y == 3], 1).astype(int)
    cases = [
        ("ovr", JaxSVC(engine="xla", **SVC), y),
        ("ovo", JaxLR(engine="xla", **LR), y),
        ("ovr", JaxLR(engine="xla", **LR), Y),  # a constant column
    ]
    for kind, base, target in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = _jax(kind, base).fit(X, target)
        port = multiclass_from_reference(ref, device="cpu")
        assert type(port).__name__ == type(ref).__name__
        assert port.estimator.device == "cpu"
        np.testing.assert_allclose(port.decision_function(X),
                                   ref.decision_function(X), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))
        for attr in ("pairs_", "binary_", "multilabel_"):
            if hasattr(ref, attr):
                assert getattr(port, attr) == getattr(ref, attr)


def test_no_card_no_quiet_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the no-card path cannot run")
    X, y = _data(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmc.DistOneVsRestClassifier(LinearSVC()).fit(X, y)
