"""The port's copies of the JAX package's text-hashing and densify C
sources, on the CPU (the host's C compiler builds them): ``hash_documents``
C = Python = the JAX package's, bitwise; ``csr_to_dense_f32`` = scipy's
``toarray``, bitwise; ``sparse_to_dense_f32`` taking the C route from
2**22 elements; the MurmurHash3 kernel refusing to fall back quietly;
and the new modules importing none of jax, skdist_tpu, sklearn, pandas.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import sparse

import skdist_tpu.native as jax_native
import skdist_tpu_torch.native as native
from skdist_tpu_torch import sparse as tsparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = [
    "Hello world foo",
    "the quick brown Fox jumps over",
    "hashing text 123 fast_tokens",
    "",
    "a",
    "héllo wörld ünïcode 日本語 テスト text",
    "emoji 🙂 doc   with\ttabs",
]


def test_c_kernels_built():
    assert native.native_available(), native.build_error("fasthash")
    assert native.build_error("murmurhash") is None
    assert native.build_error("densify") is None


@pytest.mark.parametrize("kw", [
    dict(analyzer="word", ngram_range=(1, 1)),
    dict(analyzer="word", ngram_range=(1, 3), binary=True),
    dict(analyzer="char_wb", ngram_range=(2, 4)),
    dict(analyzer="word", ngram_range=(1, 2), lowercase=False),
    dict(analyzer="char_wb", ngram_range=(1, 5), n_features=7),
])
def test_hash_documents_c_python_and_jax_agree(kw):
    kw = {"n_features": 512, **kw}
    a = native.hash_documents(DOCS, **kw)
    b = native.hash_documents(DOCS, force_python=True, **kw)
    c = jax_native.hash_documents(DOCS, **kw)
    for other in (b, c):
        np.testing.assert_array_equal(a.indptr, other.indptr)
        np.testing.assert_array_equal(a.indices, other.indices)
        np.testing.assert_array_equal(a.data, other.data)
        assert a.dtype == other.dtype == np.float32
    assert a.shape == (len(DOCS), kw["n_features"])


def _with_duplicates(rng, n, d, dtype=np.float32):
    """A CSR with explicit duplicate (row, column) entries."""
    base = sparse.random(n, d, density=0.05, random_state=rng, format="csr",
                         dtype=np.float64)
    rows = np.repeat(np.arange(n), np.diff(base.indptr))
    pick = rng.rand(len(rows)) < 0.2
    r = np.concatenate([rows, rows[pick]])
    c = np.concatenate([base.indices, base.indices[pick]])
    v = np.concatenate([base.data, base.data[pick] * 0.3]).astype(dtype)
    order = np.argsort(r, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return sparse.csr_matrix((v[order], c[order], indptr), shape=(n, d))


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_csr_to_dense_matches_scipy(index_dtype):
    rng = np.random.RandomState(7)
    X = _with_duplicates(rng, 300, 90)
    assert not X.has_canonical_format
    X.indices = X.indices.astype(index_dtype)
    X.indptr = X.indptr.astype(index_dtype)
    want = np.ascontiguousarray(X.toarray(), dtype=np.float32)
    out = native.csr_to_dense_f32(X)
    assert out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
    assert np.array_equal(out.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(native.csr_to_dense_f32(X, n_threads=3),
                                  want)
    np.testing.assert_array_equal(
        native.csr_to_dense_f32(X, force_python=True), want)
    for shape in ((0, 5), (4, 0), (0, 0)):
        empty = sparse.csr_matrix(shape, dtype=np.float32)
        assert native.csr_to_dense_f32(empty).shape == shape


def test_sparse_to_dense_routes_large_inputs_through_c(monkeypatch):
    calls = []
    real = native.csr_to_dense_f32

    def spy(X, **kw):
        calls.append(X.shape)
        return real(X, **kw)

    monkeypatch.setattr(native, "csr_to_dense_f32", spy)
    rng = np.random.RandomState(8)
    big = sparse.random(2048, 2048, density=0.002, random_state=rng,
                        format="csr", dtype=np.float64)
    assert big.shape[0] * big.shape[1] == 2 ** 22
    out = tsparse.sparse_to_dense_f32(big)
    assert calls == [(2048, 2048)]
    np.testing.assert_array_equal(out, big.toarray().astype(np.float32))
    small = sparse.random(2047, 2048, density=0.002, random_state=rng,
                          format="csr", dtype=np.float32)
    np.testing.assert_array_equal(tsparse.sparse_to_dense_f32(small),
                                  small.toarray())
    assert calls == [(2048, 2048)]


def test_murmurhash_build_failure_raises(monkeypatch):
    """A failed build of the MurmurHash3 kernel raises at the vectorizer;
    it never falls back to a Python loop quietly."""
    from skdist_tpu_torch.featurize.text import HashingVectorizer

    monkeypatch.setitem(native._EXTS, "murmurhash", None)
    monkeypatch.setitem(native._ERRORS, "murmurhash", "cc failed (1)")
    with pytest.raises(RuntimeError, match="murmurhash.c"):
        HashingVectorizer(n_features=16).transform(["some text"])


def test_new_modules_import_none_of_the_reference():
    code = (
        "import sys\n"
        "import skdist_tpu_torch as p\n"
        "from skdist_tpu_torch import featurize, preprocessing, native\n"
        "from skdist_tpu_torch.distribute import encoder, _defaults\n"
        "from skdist_tpu_torch.utils import frame\n"
        "from skdist_tpu_torch.convert import encoderizer_from_reference\n"
        "p.Encoderizer, p.EncoderizerExtractor, p.TruncatedSVDTransformer\n"
        "enc = p.Encoderizer(size='large').fit({'t': ['aa bb', 'bb cc',"
        " 'cc dd'], 'n': [1.0, None, 3.0]})\n"
        "enc.transform({'t': ['aa dd'], 'n': [2.0]})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'skdist_tpu', 'sklearn', 'pandas')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
