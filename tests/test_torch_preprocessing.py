"""Every class of ``skdist_tpu/preprocessing.py`` against the port's, on
the same inputs (a pandas frame for both, and the port's dict form too),
with the JAX package's own cases; ``TruncatedSVDTransformer(device=
"cpu")`` against the JAX one with the same ``random_state``.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

import skdist_tpu.preprocessing as jp
import skdist_tpu_torch.preprocessing as tp


@pytest.fixture
def frame_data():
    return {
        "a": [1.0, 2.0, None],
        "b": ["x", None, "z"],
        "c": [10, 20, 30],
        "d": [True, False, True],
    }


def _equal(a, b):
    if sparse.issparse(a) or sparse.issparse(b):
        assert sparse.issparse(a) and sparse.issparse(b)
        assert a.shape == b.shape and (a != b).nnz == 0
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind in "fc":
        np.testing.assert_array_equal(a, b)
    else:
        assert a.tolist() == b.tolist() or all(
            (x == y) or (x != x and y != y)
            for x, y in zip(a.ravel().tolist(), b.ravel().tolist()))


@pytest.mark.parametrize("kw", [
    dict(cols=["a", "c"]), dict(cols=["b"], single_dimension=True),
    dict(cols=["b"]), dict(cols=["a"]), dict(cols=["c", "d"]),
    dict(cols=["a"], single_dimension=True), dict()])
def test_select_field(frame_data, kw):
    df = pd.DataFrame.from_dict(frame_data)
    want = jp.SelectField(**kw).fit_transform(df)
    for X in (df, frame_data):
        got = tp.SelectField(**kw).fit_transform(X)
        assert np.asarray(got).shape == np.asarray(want).shape
        _equal(got, np.asarray(want, dtype=object)
               if np.asarray(want).dtype == object else want)


def test_feature_cast_impute_null_chain(frame_data):
    """SelectField -> FeatureCast(str) -> ImputeNull(''): a string column's
    missing entry stays missing through the cast (pandas' string column),
    so it becomes ''; a numeric column's NaN becomes 'nan'."""
    df = pd.DataFrame.from_dict(frame_data)
    for col in ("a", "b", "c"):
        def run(mod, X):
            out = mod.SelectField(cols=[col], single_dimension=True) \
                .fit_transform(X)
            out = mod.FeatureCast(cast_type=str).fit_transform(out)
            return list(mod.ImputeNull("").fit_transform(out))
        want = run(jp, df)
        assert run(tp, df) == want and run(tp, frame_data) == want
    X = np.array([["1", "2"], ["3", "4"]])
    out = tp.FeatureCast(cast_type=float).fit_transform(X)
    assert out.dtype == np.float64
    assert tp.FeatureCast().fit_transform(X) is X


def test_impute_null():
    X = np.array([1.0, np.nan, 3.0, None], dtype=object)
    for val in (0.0, "", {}):
        a = jp.ImputeNull(val).fit_transform(X)
        b = tp.ImputeNull(val).fit_transform(X)
        assert list(a) == list(b)
    assert tp.ImputeNull().fit_transform(X) is X
    F = np.array([1.0, np.nan], dtype=np.float32)
    _equal(tp.ImputeNull(-1.0).fit_transform(F),
           jp.ImputeNull(-1.0).fit_transform(F))


def test_dense_sparse_roundtrip():
    X = np.eye(3)
    for mod in (jp, tp):
        sp_ = mod.SparseTransformer().fit_transform(X)
        assert sparse.issparse(sp_)
        back = mod.DenseTransformer().fit_transform(sp_)
        np.testing.assert_array_equal(back, X)
        assert mod.DenseTransformer().fit_transform(X) is X
        assert mod.SparseTransformer().fit_transform(sp_) is sp_


def test_label_encoder_pipe():
    for y in (["b", "a", "b"], [3, 1, 3, 2]):
        a = jp.LabelEncoderPipe().fit_transform(y)
        b = tp.LabelEncoderPipe().fit_transform(y)
        assert b.shape == (len(y), 1)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("selector,threshold", [
    ("kbest", 4), ("fpr", 0.05), ("fdr", 0.05), ("fwe", 0.05),
    ("percentile", 30)])
def test_selector_mem(clf_data, selector, threshold):
    X, y = clf_data
    a = jp.SelectorMem(selector=selector, threshold=threshold).fit(X, y)
    b = tp.SelectorMem(selector=selector, threshold=threshold).fit(X, y)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert np.asarray(a.mask).dtype == np.asarray(b.mask).dtype
    np.testing.assert_array_equal(a.transform(X), b.transform(X))


def test_hashing_vectorizer_chunked():
    docs = ["hello world", "foo bar baz", "hello again héllo"] * 10
    for kw in (dict(n_features=64, alternate_sign=False),
               dict(n_features=2 ** 12, ngram_range=(1, 2)),
               dict(n_features=2 ** 8, analyzer="char_wb",
                    ngram_range=(2, 5), norm="l1")):
        for chunk in (7, None):
            a = jp.HashingVectorizerChunked(chunksize=chunk, **kw)
            b = tp.HashingVectorizerChunked(chunksize=chunk, **kw)
            A, B = a.transform(docs), b.transform(docs)
            np.testing.assert_array_equal(A.indptr, B.indptr)
            np.testing.assert_array_equal(A.indices, B.indices)
            np.testing.assert_allclose(A.data, B.data, rtol=0, atol=1e-15)
    with pytest.raises(ValueError):
        tp.HashingVectorizerChunked().transform("a single string")


@pytest.mark.parametrize("kw", [
    dict(n_features=128, ngram_range=(1, 2), norm="l2"),
    dict(n_features=64, norm=None, binary=True),
    dict(n_features=256, analyzer="char_wb", ngram_range=(2, 4), norm="l1",
         chunksize=2),
])
def test_fast_hashing_vectorizer(kw):
    docs = ["Hello world foo", "the quick brown Fox", "héllo wörld 日本語",
            "", "a"]
    a = jp.FastHashingVectorizer(**kw).fit_transform(docs)
    b = tp.FastHashingVectorizer(**kw).fit_transform(docs)
    c = tp.FastHashingVectorizer(force_python=True, **kw).fit_transform(docs)
    for other in (b, c):
        np.testing.assert_array_equal(a.indptr, other.indptr)
        np.testing.assert_array_equal(a.indices, other.indices)
        np.testing.assert_array_equal(a.data, other.data)
        assert other.dtype == a.dtype
    with pytest.raises(ValueError):
        tp.FastHashingVectorizer().transform("just a string")


def test_multihot_encoder():
    X = [["a", "b"], ["b"], ["c"]]
    for mod in (jp, tp):
        enc = mod.MultihotEncoder().fit(X)
        assert enc.transform(X).shape == (3, 3)
        assert enc.transform([["a", "zzz"]]).sum() == 1
        assert sparse.issparse(
            mod.MultihotEncoder(sparse_output=True).fit_transform(X))
    a, b = jp.MultihotEncoder().fit(X), tp.MultihotEncoder().fit(X)
    np.testing.assert_array_equal(a.classes_, b.classes_)
    np.testing.assert_array_equal(a.transform(X + [["a", "q"]]),
                                  b.transform(X + [["a", "q"]]))


def _low_rank(seed=0, n=300, d=80, k=6):
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(n, k)).astype(np.float32)
    B = rng.normal(size=(k, d)).astype(np.float32)
    X = A @ B + 0.01 * rng.normal(size=(n, d)).astype(np.float32)
    return X


def _same_up_to_sign(a, b, atol):
    signs = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * signs, b, atol=atol)


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_truncated_svd_matches_jax(fmt):
    X = _low_rank()
    if fmt == "csr":
        X[np.abs(X) < 1.0] = 0.0
        X = sparse.csr_matrix(X)
    k = 6
    a = jp.TruncatedSVDTransformer(n_components=k, random_state=3).fit(X)
    b = tp.TruncatedSVDTransformer(n_components=k, random_state=3,
                                   device="cpu").fit(X)
    np.testing.assert_allclose(b.singular_values_, a.singular_values_,
                               rtol=1e-4)
    _same_up_to_sign(b.components_, a.components_, atol=1e-3)
    np.testing.assert_allclose(b.explained_variance_ratio_,
                               a.explained_variance_ratio_, rtol=1e-3)
    Xt = b.transform(X)
    assert Xt.shape == (X.shape[0], k) and Xt.dtype == np.float32
    _same_up_to_sign(Xt.T, a.transform(X).T,
                     atol=1e-3 * float(np.abs(Xt).max()))
    loaded = pickle.loads(pickle.dumps(b))
    np.testing.assert_array_equal(loaded.transform(X), Xt)
    with pytest.raises(ValueError):
        tp.TruncatedSVDTransformer(n_components=X.shape[1] + 1,
                                   device="cpu").fit(X)
    with pytest.raises(ValueError):
        b.transform(X[:, :10])


def test_truncated_svd_no_quiet_cpu_fallback():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.TruncatedSVDTransformer(n_components=2).fit(_low_rank(n=20))
