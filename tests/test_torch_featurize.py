"""The port's copies of scikit-learn's transformers (``featurize/``)
against scikit-learn's, on the CPU: ``DictVectorizer``,
``SimpleImputer``, ``StandardScaler``, ``normalize``, ``LabelEncoder``,
``MultiLabelBinarizer``, ``VarianceThreshold``, ``f_classif`` with the
univariate selectors, and ``Pipeline``. Outputs equal, or within 1e-12
where float64 arithmetic is involved.
"""

import warnings

import numpy as np
import pytest
from scipy import sparse
from sklearn import feature_selection as skfs
from sklearn.feature_extraction import DictVectorizer as SkDict
from sklearn.impute import SimpleImputer as SkImputer
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import LabelEncoder as SkLabel
from sklearn.preprocessing import MultiLabelBinarizer as SkMLB
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.preprocessing import normalize as sk_normalize

from skdist_tpu_torch import featurize as fz
from skdist_tpu_torch.base import clone


def _close(a, b, tol=1e-12):
    if sparse.issparse(a) or sparse.issparse(b):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        a, b = a.data, b.data
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(
        1.0, float(np.nanmax(np.abs(b))) if b.size else 1.0))


DICTS = [
    {"a": 1.0, "b": "x", "tags": ["p", "q"]},
    {"a": 2, "b": "y", "c": None},
    {"b": "x", "tags": ("q",), "d": 3.5},
    {},
]


@pytest.mark.parametrize("kw", [dict(), dict(sort=False),
                                dict(sparse=False), dict(separator="|")])
def test_dict_vectorizer_matches_sklearn(kw):
    ours, theirs = fz.DictVectorizer(**kw), SkDict(**kw)
    a, b = ours.fit_transform(DICTS), theirs.fit_transform(DICTS)
    assert ours.feature_names_ == theirs.feature_names_
    assert ours.vocabulary_ == theirs.vocabulary_
    _close(a, b, tol=0)
    later = [{"a": 5.0, "b": "z", "tags": ["p", "new"]}, {"e": 1.0}]
    _close(ours.transform(later), theirs.transform(later), tol=0)
    fitted = fz.DictVectorizer(**kw).fit(DICTS)
    assert fitted.feature_names_ == theirs.feature_names_
    with pytest.raises(TypeError, match="Mapping"):
        fz.DictVectorizer().fit([{"a": {"nested": 1}}])


def _numeric(rng, dtype=np.float64):
    X = rng.normal(size=(40, 6)).astype(dtype)
    X[rng.rand(40, 6) < 0.2] = np.nan
    X[:, 2] = 3.25                     # a constant column
    X[:, 3] = np.nan                   # an all-NaN column
    X[:, 4] = 0.1 * np.ones(40) + rng.normal(size=40) * 1e-17  # float noise
    return X


@pytest.mark.parametrize("strategy", ["median", "mean"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_simple_imputer_matches_sklearn(strategy, dtype):
    X = _numeric(np.random.RandomState(0), dtype)
    ours = fz.SimpleImputer(strategy=strategy).fit(X)
    theirs = SkImputer(strategy=strategy).fit(X)
    np.testing.assert_array_equal(ours.statistics_, theirs.statistics_)
    with warnings.catch_warnings(record=True) as w_ours:
        warnings.simplefilter("always")
        a = ours.transform(X)
    with warnings.catch_warnings(record=True) as w_theirs:
        warnings.simplefilter("always")
        b = theirs.transform(X)
    assert a.shape == (40, 5)  # the all-NaN column dropped
    assert [str(w.message)[:40] for w in w_ours] == [
        str(w.message)[:40] for w in w_theirs]
    _close(a, b, tol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_standard_scaler_matches_sklearn(dtype):
    rng = np.random.RandomState(1)
    X = (rng.normal(size=(50, 5)) * [1, 10, 1e-3, 0, 5] + [0, 3, 7, 2, -1])
    X = X.astype(dtype)
    ours, theirs = fz.StandardScaler().fit(X), SkScaler().fit(X)
    for key in ("mean_", "var_", "scale_", "n_samples_seen_"):
        _close(np.asarray(getattr(ours, key)),
               np.asarray(getattr(theirs, key)))
    assert ours.scale_[3] == 1.0  # zero variance: scale 1
    _close(ours.transform(X), theirs.transform(X))
    Y = X.astype(np.float64)
    inplace = fz.StandardScaler(copy=False).fit(Y)
    out = inplace.transform(Y)
    assert out is Y
    Xn = X.astype(np.float64)
    Xn[::7, 1] = np.nan
    _close(fz.StandardScaler().fit(Xn).var_, SkScaler().fit(Xn).var_)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_normalize_matches_sklearn(norm):
    rng = np.random.RandomState(2)
    D = rng.normal(size=(12, 7))
    D[3] = 0.0
    D[4] = 1e-17  # below ten epsilons: left as it is
    S = sparse.random(12, 30, density=0.2, random_state=rng, format="csr")
    S = S.astype(np.float64)
    for A in (D, D.astype(np.float32), S, S.astype(np.float32),
              np.arange(6).reshape(2, 3)):
        _close(fz.normalize(A, norm=norm), sk_normalize(A, norm=norm),
               tol=0)
    S2 = S.copy()
    out = fz.normalize(S2, norm=norm, copy=False)
    assert out is S2


@pytest.mark.parametrize("y", [
    ["b", "a", "c", "a"],
    [3, 1, 7, 1],
    [2.5, 0.5, 2.5],
    np.array(["x", "y", "x"], dtype=object),
])
def test_label_encoder_matches_sklearn(y):
    ours, theirs = fz.LabelEncoder().fit(y), SkLabel().fit(y)
    np.testing.assert_array_equal(ours.classes_, theirs.classes_)
    assert ours.classes_.dtype == theirs.classes_.dtype
    a, b = ours.transform(y), theirs.transform(y)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(ours.inverse_transform(a),
                                  theirs.inverse_transform(b))
    with pytest.raises(ValueError, match="unseen labels"):
        ours.transform([np.asarray(y)[0], "zz" if isinstance(
            np.asarray(y)[0], str) else 99])
    assert ours.transform([]).shape == theirs.transform([]).shape


def test_multilabel_binarizer_matches_sklearn():
    y = [["a", "b"], ["b"], [], ("c", "a")]
    ours, theirs = fz.MultiLabelBinarizer(), SkMLB()
    np.testing.assert_array_equal(ours.fit_transform(y),
                                  theirs.fit_transform(y))
    np.testing.assert_array_equal(ours.classes_, theirs.classes_)
    with pytest.warns(UserWarning, match="unknown class"):
        a = ours.transform([["a", "zzz"]])
    with pytest.warns(UserWarning, match="unknown class"):
        b = theirs.transform([["a", "zzz"]])
    np.testing.assert_array_equal(a, b)
    ints = [[3, 1], [2]]
    assert fz.MultiLabelBinarizer().fit(ints).classes_.dtype == \
        SkMLB().fit(ints).classes_.dtype
    sp_out = fz.MultiLabelBinarizer(sparse_output=True).fit_transform(y)
    np.testing.assert_array_equal(sp_out.toarray(), theirs.transform(y))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_variance_threshold_matches_sklearn(threshold, fmt):
    rng = np.random.RandomState(3)
    X = rng.normal(size=(30, 6))
    X[:, 4] = rng.rand(30) < 0.1                       # mostly zero
    X[rng.rand(30, 6) < 0.3] = 0.0
    X[:, 1] = 2.0                                      # constant
    X[:, 2] = 0.1                                      # float-noise constant
    if fmt == "csr":
        X = sparse.csr_matrix(X)
    ours = fz.VarianceThreshold(threshold).fit(X)
    theirs = skfs.VarianceThreshold(threshold).fit(X)
    _close(ours.variances_, theirs.variances_)
    np.testing.assert_array_equal(ours.get_support(), theirs.get_support())
    if threshold == 0:
        assert not ours.get_support()[[1, 2]].any()
    _close(ours.transform(X), theirs.transform(X), tol=0)


def test_variance_threshold_noise_constant_goes():
    """A column constant apart from float noise has a small positive
    variance, but a zero range: threshold 0 drops it, as scikit-learn."""
    col = np.full(13, 0.1)
    assert np.var(col) > 0  # the plain variance test would keep it
    X = np.column_stack([col, np.arange(13.0)])
    for A in (X, sparse.csr_matrix(X)):
        np.testing.assert_array_equal(
            fz.VarianceThreshold().fit(A).get_support(), [False, True])
    with pytest.raises(ValueError, match="variance threshold"):
        fz.VarianceThreshold().fit(np.ones((4, 2)))


def _selection_data():
    rng = np.random.RandomState(4)
    y = rng.randint(0, 3, 60)
    X = rng.normal(size=(60, 12))
    X[:, 0] += y                  # informative
    X[:, 1] = X[:, 0]             # an exact tie with 0
    X[:, 5] = 1.0                 # constant: NaN score
    X[:, 7] = X[:, 6]             # another tie
    return X, y


def test_f_classif_matches_sklearn():
    X, y = _selection_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f, p = fz.f_classif(X, y)
        sf, sp_ = skfs.f_classif(X, y)
        fs, ps = fz.f_classif(sparse.csr_matrix(X), y)
        sfs, sps = skfs.f_classif(sparse.csr_matrix(X), y)
    for a, b in ((f, sf), (p, sp_), (fs, sfs), (ps, sps)):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    assert np.isnan(f[5])


@pytest.mark.parametrize("name,kw", [
    ("SelectKBest", dict(k=1)), ("SelectKBest", dict(k=4)),
    ("SelectKBest", dict(k="all")), ("SelectKBest", dict(k=0)),
    ("SelectPercentile", dict(percentile=10)),
    ("SelectPercentile", dict(percentile=25)),
    ("SelectPercentile", dict(percentile=100)),
    ("SelectFpr", dict(alpha=0.05)), ("SelectFdr", dict(alpha=0.2)),
    ("SelectFwe", dict(alpha=0.5)), ("SelectFdr", dict(alpha=1e-30)),
])
def test_selectors_match_sklearn(name, kw):
    X, y = _selection_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = getattr(fz, name)(fz.f_classif, **kw).fit(X, y)
        theirs = getattr(skfs, name)(skfs.f_classif, **kw).fit(X, y)
        np.testing.assert_array_equal(ours.get_support(),
                                      theirs.get_support())
        np.testing.assert_array_equal(ours.get_support(indices=True),
                                      theirs.get_support(indices=True))
        a, b = ours.transform(X), theirs.transform(X)
    np.testing.assert_array_equal(a, b)


def test_pipeline_clone_params_and_fit():
    def make(mod_pipe, imputer, scaler):
        return mod_pipe([("imp", imputer(strategy="median")),
                         ("sc", scaler(copy=False))])

    ours = make(fz.Pipeline, fz.SimpleImputer, fz.StandardScaler)
    theirs = make(SkPipeline, SkImputer, SkScaler)
    keys = {k for k in theirs.get_params(deep=True)
            if k.startswith(("imp__", "sc__")) and k.split("__")[1] in
            ours.get_params(deep=True).get(k.split("__")[0]).get_params()}
    assert keys <= set(ours.get_params(deep=True))
    assert set(ours.get_params(deep=True)["imp"].get_params()) <= set(
        theirs.get_params(deep=True)["imp"].get_params())
    ours.set_params(imp__strategy="mean", sc__with_mean=False)
    theirs.set_params(imp__strategy="mean", sc__with_mean=False)
    assert ours.named_steps.imp.strategy == "mean"
    twin = clone(ours)
    assert twin is not ours and twin.steps[0][1] is not ours.steps[0][1]
    assert twin.get_params()["imp__strategy"] == "mean"
    X = _numeric(np.random.RandomState(5))[:, [0, 1, 2, 5]]
    _close(ours.fit(X).transform(X), theirs.fit(X).transform(X))
    _close(twin.fit_transform(X), theirs.fit_transform(X))
    ours.set_params(sc="passthrough")
    np.testing.assert_array_equal(ours.fit_transform(X),
                                  fz.SimpleImputer(strategy="mean")
                                  .fit_transform(X))
    with pytest.raises(ValueError, match="Invalid parameter"):
        ours.set_params(nope__x=1)
