"""The port's text vectorizers against scikit-learn's, on the CPU.

MurmurHash3 (the C kernel and its Python form) against
``sklearn.utils.murmurhash3_32(..., positive=False)``, bitwise;
``HashingVectorizer`` over analyzer x n-gram range x sign x norm x
binary, indices bitwise and data within 1e-15; ``CountVectorizer``
(default, and the identity tokenizer of the one-hot default, whose
vocabulary is the characters), bitwise; the analyzers feature for
feature.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.feature_extraction.text import CountVectorizer as SkCount
from sklearn.feature_extraction.text import HashingVectorizer as SkHashing
from sklearn.utils import murmurhash3_32

from skdist_tpu_torch import native
from skdist_tpu_torch.featurize.text import CountVectorizer, HashingVectorizer

#: a token whose signed MurmurHash3 is -2**31: found by fixing its first
#: four bytes and solving the second block's input from the inverted
#: finalisation mix, until all eight bytes were lowercase letters or
#: digits (a word token of the default pattern)
MIN_HASH_TOKEN = "ad1u66pi"

CORPUS = [
    "The quick brown Fox jumps over the lazy dog",
    "",
    "héllo wörld ünïcode 日本語 テスト text 🙂 emoji",
    f"tabs\tand  double  spaces\n\nnew lines {MIN_HASH_TOKEN} again",
    "a",
    "punctuation, commas; and: colons! x_y z9 9z",
    f"{MIN_HASH_TOKEN} {MIN_HASH_TOKEN.upper()} the the the",
    "   ",
]


def _same_csr(ours, theirs, atol=1e-15):
    assert ours.shape == theirs.shape
    assert ours.dtype == theirs.dtype
    ours, theirs = ours.tocsr(), theirs.tocsr()
    np.testing.assert_array_equal(ours.indptr, theirs.indptr)
    np.testing.assert_array_equal(ours.indices, theirs.indices)
    np.testing.assert_allclose(ours.data, theirs.data, rtol=0, atol=atol)


def test_min_hash_token_is_what_it_claims():
    assert murmurhash3_32(MIN_HASH_TOKEN, positive=False) == -2 ** 31


@settings(max_examples=150, deadline=None)
@given(st.lists(st.one_of(st.binary(max_size=40),
                          st.text(max_size=20).map(
                              lambda s: s.encode("utf-8", "surrogatepass"))),
                min_size=1, max_size=8))
def test_murmurhash_c_and_python_match_sklearn(items):
    want = [murmurhash3_32(b, seed=0, positive=False) for b in items]
    assert [native.murmurhash3_32_py(b) for b in items] == want
    lengths = np.array([len(b) for b in items], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    out = native.murmurhash3_32_spans(b"".join(items), starts, lengths)
    assert out.dtype == np.int32 and out.tolist() == want


def test_murmurhash_unicode_empty_and_seed():
    for s in ["", "a", "ab", "abc", "abcd", "日本語", "🙂", MIN_HASH_TOKEN,
              "héllo wörld"]:
        want = murmurhash3_32(s, positive=False)
        assert native.murmurhash3_32_py(s) == want
        data = s.encode("utf-8")
        got = native.murmurhash3_32_spans(data, [0], [len(data)])
        assert int(got[0]) == want
    assert native.murmurhash3_32_py("abc", seed=42) == murmurhash3_32(
        "abc", seed=42, positive=False)
    with pytest.raises(ValueError, match="outside"):
        native.murmurhash3_32_spans(b"abc", [2], [5])


NGRAMS = [(1, 1), (1, 2), (1, 3), (2, 5), (3, 4)]


@pytest.mark.parametrize("n_features", [7, 1024])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("norm", ["l1", "l2", None])
@pytest.mark.parametrize("alternate_sign", [True, False])
@pytest.mark.parametrize("ngram_range", NGRAMS)
@pytest.mark.parametrize("analyzer", ["word", "char", "char_wb"])
def test_hashing_vectorizer_matches_sklearn(analyzer, ngram_range,
                                            alternate_sign, norm, binary,
                                            n_features):
    kw = dict(analyzer=analyzer, ngram_range=ngram_range,
              alternate_sign=alternate_sign, norm=norm, binary=binary,
              n_features=n_features)
    _same_csr(HashingVectorizer(**kw).fit_transform(CORPUS),
              SkHashing(**kw).fit_transform(CORPUS))


@pytest.mark.parametrize("kw", [
    dict(dtype=np.float32),
    dict(lowercase=False, ngram_range=(1, 2)),
    dict(stop_words=["the", "and"], ngram_range=(1, 2)),
    dict(strip_accents="unicode", analyzer="char_wb", ngram_range=(2, 3)),
    dict(strip_accents="ascii"),
    dict(token_pattern=r"(?u)\b\w+\b", ngram_range=(1, 3)),
    dict(tokenizer=str.split, token_pattern=None, ngram_range=(1, 2)),
    dict(tokenizer=lambda s: s, token_pattern=None, ngram_range=(1, 2)),
    dict(analyzer=lambda s: s.split() + [s[:3]]),
    dict(decode_error="ignore", ngram_range=(1, 2)),
])
def test_hashing_vectorizer_options_match_sklearn(kw):
    docs = CORPUS + [b"bytes doc \xff\xfe with bad utf-8"] * (
        kw.get("decode_error") == "ignore")
    _same_csr(HashingVectorizer(n_features=64, **kw).transform(docs),
              SkHashing(n_features=64, **kw).transform(docs))


@pytest.mark.parametrize("kw", [
    dict(analyzer="word", ngram_range=(1, 3)),
    dict(analyzer="char", ngram_range=(1, 4)),
    dict(analyzer="char_wb", ngram_range=(2, 5)),
    dict(analyzer="char_wb", ngram_range=(5, 7)),
    dict(tokenizer=lambda s: s, token_pattern=None),
])
def test_analyzers_give_sklearns_features(kw):
    ours = CountVectorizer(**kw).build_analyzer()
    theirs = SkCount(**kw).build_analyzer()
    for doc in CORPUS:
        assert ours(doc) == theirs(doc)


def test_hashing_vectorizer_refusals():
    with pytest.raises(ValueError, match="string object received"):
        HashingVectorizer().transform("one string")
    with pytest.raises(ValueError, match="empty sequence"):
        HashingVectorizer().transform([])
    with pytest.raises(ValueError, match="ngram_range"):
        HashingVectorizer(ngram_range=(3, 2)).transform(["a b"])


def _same_count(ours, theirs):
    _same_csr(ours, theirs, atol=0)
    assert ours.data.dtype == theirs.data.dtype


@pytest.mark.parametrize("kw", [
    dict(),
    dict(binary=True, ngram_range=(1, 2)),
    dict(analyzer="char_wb", ngram_range=(2, 3)),
    dict(min_df=2),
    dict(max_df=0.5, max_features=5),
    dict(token_pattern=None, tokenizer=lambda s: s, binary=True,
         decode_error="ignore"),
])
def test_count_vectorizer_matches_sklearn(kw):
    ours, theirs = CountVectorizer(**kw), SkCount(**kw)
    _same_count(ours.fit_transform(CORPUS), theirs.fit_transform(CORPUS))
    assert ours.vocabulary_ == theirs.vocabulary_
    later = ["the fox", "héllo 日本語", ""]
    _same_count(ours.transform(later), theirs.transform(later))


def test_one_hot_default_counts_characters():
    """The one-hot default's identity tokenizer makes the vocabulary the
    column's lowercased characters (scikit-learn iterates over the
    string): kept, because it is what the JAX package computes."""
    values = np.array(["Red", "blue", "red", "Green"]).astype(str)
    kw = dict(token_pattern=None, tokenizer=lambda s: s, binary=True,
              decode_error="ignore")
    ours = CountVectorizer(**kw).fit(values)
    theirs = SkCount(**kw).fit(values)
    assert sorted(ours.vocabulary_) == list("bdeglnru")
    assert ours.vocabulary_ == theirs.vocabulary_
    _same_count(ours.transform(values), theirs.transform(values))
