"""
``CountVectorizer`` and ``HashingVectorizer``: copies of scikit-learn's
(``sklearn/feature_extraction/text.py``, ``_hash.py``,
``_hashing_fast.pyx``).

Both share scikit-learn's analyzers: decode (``decode_error``), the
preprocessor (``lowercase``, ``strip_accents``), then ``word`` n-grams
of the ``token_pattern`` tokens (``(?u)\\b\\w\\w+\\b`` by default, or a
``tokenizer``) joined by one space, ``char`` n-grams of the text with
whitespace runs folded to one space, or ``char_wb`` n-grams of each
word padded with a space (a word shorter than ``n`` counted once,
whole), or a callable ``analyzer``.

``CountVectorizer`` counts the analyzer's features against a sorted
vocabulary (int64 counts, ``binary``). With ``tokenizer`` returning its
input and ``token_pattern=None`` (the one-hot default of
``distribute/_defaults.py``) a string's features are its characters,
as scikit-learn's are: a kept quirk of the reference.

``HashingVectorizer`` hashes every feature's UTF-8 bytes with the
signed 32-bit MurmurHash3 (seed 0) of ``native/murmurhash.c``: index
``abs(h) % n_features`` (``h = -2**31`` maps where scikit-learn maps
it), sign ``h >= 0`` when ``alternate_sign``; duplicates summed,
indices sorted, then ``binary`` and the row ``norm``. The built-in
analyzers give their n-grams as spans of one UTF-8 buffer of the whole
batch, computed with numpy, so that hashing runs in C over the buffer
and no n-gram string is built in Python.
"""

import re
import unicodedata
import warnings
from collections import defaultdict
from functools import partial
from itertools import chain
from numbers import Integral

import numpy as np
from scipy import sparse

from ..base import BaseEstimator, TransformerMixin
from .scale import normalize

__all__ = ["CountVectorizer", "HashingVectorizer"]

_DEFAULT_TOKEN_PATTERN = r"(?u)\b\w\w+\b"


def _preprocess(doc, accent_function=None, lower=False):
    if lower:
        doc = doc.lower()
    if accent_function is not None:
        doc = accent_function(doc)
    return doc


def _analyze(doc, analyzer=None, tokenizer=None, ngrams=None,
             preprocessor=None, decoder=None, stop_words=None):
    if decoder is not None:
        doc = decoder(doc)
    if analyzer is not None:
        return analyzer(doc)
    if preprocessor is not None:
        doc = preprocessor(doc)
    if tokenizer is not None:
        doc = tokenizer(doc)
    if ngrams is not None:
        doc = ngrams(doc, stop_words) if stop_words is not None else ngrams(doc)
    return doc


def strip_accents_unicode(s):
    """``s`` with combining marks removed after NFKD normalisation."""
    try:
        s.encode("ASCII", errors="strict")
        return s
    except UnicodeEncodeError:
        normalized = unicodedata.normalize("NFKD", s)
        return "".join(c for c in normalized if not unicodedata.combining(c))


def strip_accents_ascii(s):
    """``s`` transliterated to ASCII, dropping what has no equivalent."""
    return unicodedata.normalize("NFKD", s).encode(
        "ASCII", "ignore").decode("ASCII")


class _VectorizerMixin:
    """The analyzers shared by the vectorizers."""

    _white_spaces = re.compile(r"\s\s+")

    def decode(self, doc):
        if self.input == "filename":
            with open(doc, "rb") as fh:
                doc = fh.read()
        elif self.input == "file":
            doc = doc.read()
        if isinstance(doc, bytes):
            doc = doc.decode(self.encoding, self.decode_error)
        if doc is np.nan:
            raise ValueError("np.nan is an invalid document, expected byte "
                             "or unicode string.")
        return doc

    def _word_ngrams(self, tokens, stop_words=None):
        if stop_words is not None:
            tokens = [w for w in tokens if w not in stop_words]
        min_n, max_n = self.ngram_range
        if max_n != 1:
            original = tokens
            if min_n == 1:
                tokens = list(original)
                min_n += 1
            else:
                tokens = []
            n_orig = len(original)
            for n in range(min_n, min(max_n + 1, n_orig + 1)):
                for i in range(n_orig - n + 1):
                    tokens.append(" ".join(original[i:i + n]))
        return tokens

    def _char_ngrams(self, text):
        text = self._white_spaces.sub(" ", text)
        text_len = len(text)
        min_n, max_n = self.ngram_range
        if min_n == 1:
            ngrams = list(text)
            min_n += 1
        else:
            ngrams = []
        for n in range(min_n, min(max_n + 1, text_len + 1)):
            for i in range(text_len - n + 1):
                ngrams.append(text[i:i + n])
        return ngrams

    def _char_wb_ngrams(self, text):
        text = self._white_spaces.sub(" ", text)
        min_n, max_n = self.ngram_range
        ngrams = []
        for w in text.split():
            w = " " + w + " "
            w_len = len(w)
            for n in range(min_n, max_n + 1):
                offset = 0
                ngrams.append(w[offset:offset + n])
                while offset + n < w_len:
                    offset += 1
                    ngrams.append(w[offset:offset + n])
                if offset == 0:  # a short word (w_len <= n) counts once
                    break
        return ngrams

    def build_preprocessor(self):
        if self.preprocessor is not None:
            return self.preprocessor
        if not self.strip_accents:
            strip = None
        elif callable(self.strip_accents):
            strip = self.strip_accents
        elif self.strip_accents == "ascii":
            strip = strip_accents_ascii
        elif self.strip_accents == "unicode":
            strip = strip_accents_unicode
        else:
            raise ValueError(
                f'Invalid value for "strip_accents": {self.strip_accents}')
        return partial(_preprocess, accent_function=strip,
                       lower=self.lowercase)

    def build_tokenizer(self):
        if self.tokenizer is not None:
            return self.tokenizer
        pattern = re.compile(self.token_pattern)
        if pattern.groups > 1:
            raise ValueError("More than 1 capturing group in token pattern. "
                             "Only a single group should be captured.")
        return pattern.findall

    def get_stop_words(self):
        stop = self.stop_words
        if stop is None:
            return None
        if isinstance(stop, str):
            raise ValueError(
                f"not a built-in stop list: {stop} (skdist_tpu_torch "
                "carries no built-in stop list; pass the words)")
        return frozenset(stop)

    def build_analyzer(self):
        """The callable from one document to its list of features."""
        if callable(self.analyzer):
            return partial(_analyze, analyzer=self.analyzer,
                           decoder=self.decode)
        preprocess = self.build_preprocessor()
        if self.analyzer == "char":
            return partial(_analyze, ngrams=self._char_ngrams,
                           preprocessor=preprocess, decoder=self.decode)
        if self.analyzer == "char_wb":
            return partial(_analyze, ngrams=self._char_wb_ngrams,
                           preprocessor=preprocess, decoder=self.decode)
        if self.analyzer == "word":
            return partial(_analyze, ngrams=self._word_ngrams,
                           tokenizer=self.build_tokenizer(),
                           preprocessor=preprocess, decoder=self.decode,
                           stop_words=self.get_stop_words())
        raise ValueError(
            f"{self.analyzer} is not a valid tokenization scheme/analyzer")

    def _validate_ngram_range(self):
        min_n, max_n = self.ngram_range
        if min_n > max_n or min_n < 1:
            raise ValueError(
                f"Invalid value for ngram_range={self.ngram_range} lower "
                "boundary larger than the upper boundary.")

    def _warn_for_unused_params(self):
        if self.tokenizer is not None and self.token_pattern is not None:
            warnings.warn("The parameter 'token_pattern' will not be used "
                          "since 'tokenizer' is not None'")
        if self.preprocessor is not None and callable(self.analyzer):
            warnings.warn("The parameter 'preprocessor' will not be used "
                          "since 'analyzer' is callable'")
        if (self.ngram_range != (1, 1) and self.ngram_range is not None
                and callable(self.analyzer)):
            warnings.warn("The parameter 'ngram_range' will not be used "
                          "since 'analyzer' is callable'")
        if self.analyzer != "word" or callable(self.analyzer):
            if self.stop_words is not None:
                warnings.warn("The parameter 'stop_words' will not be used "
                              "since 'analyzer' != 'word'")
            if (self.token_pattern is not None
                    and self.token_pattern != _DEFAULT_TOKEN_PATTERN):
                warnings.warn("The parameter 'token_pattern' will not be "
                              "used since 'analyzer' != 'word'")
            if self.tokenizer is not None:
                warnings.warn("The parameter 'tokenizer' will not be used "
                              "since 'analyzer' != 'word'")

    # ---- n-grams as spans of one buffer (the hashing path) -------------
    def _feature_spans(self, docs):
        """Every document's features as byte spans of one UTF-8 buffer:
        ``(buf, starts, lengths, rows, n_docs)``, ``rows`` the document
        of each span. The same multiset of features a document as
        :meth:`build_analyzer` gives it."""
        if callable(self.analyzer) or self.analyzer not in (
                "word", "char", "char_wb"):
            return _string_spans(self.build_analyzer(), docs)
        preprocess = self.build_preprocessor()
        texts = [preprocess(self.decode(doc)) for doc in docs]
        min_n, max_n = self.ngram_range
        if self.analyzer == "word":
            tokenize = self.build_tokenizer()
            stop = self.get_stop_words()
            units = [list(tokenize(t)) for t in texts]
            if stop is not None:
                units = [[w for w in u if w not in stop] for u in units]
            if max_n == 1:
                min_n = 1  # scikit-learn keeps the tokens as they are
            return _word_spans(units, min_n, max_n)
        texts = [self._white_spaces.sub(" ", t) for t in texts]
        if self.analyzer == "char":
            return _char_spans(texts, range(len(texts)), min_n, max_n,
                               len(texts), whole_below=False)
        words = [t.split() for t in texts]
        owner = np.repeat(np.arange(len(texts)),
                          [len(w) for w in words])
        padded = [" " + w + " " for w in chain.from_iterable(words)]
        return _char_spans(padded, owner, min_n, max_n, len(texts),
                           whole_below=True)


def _utf8_offsets(joined, buf):
    """Byte offset of every code point of ``joined`` (and its end) in its
    UTF-8 encoding ``buf``."""
    if len(buf) == len(joined):
        return np.arange(len(joined) + 1, dtype=np.int64)
    cps = np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32)
    nbytes = (1 + (cps >= 0x80) + (cps >= 0x800)
              + (cps >= 0x10000)).astype(np.int64)
    out = np.zeros(len(cps) + 1, dtype=np.int64)
    np.cumsum(nbytes, out=out[1:])
    return out


def _span_arrays(starts, ends, rows, buf, n_docs):
    if starts:
        starts = np.concatenate(starts)
        lengths = np.concatenate(ends) - starts
        rows = np.concatenate(rows)
    else:
        starts = lengths = rows = np.zeros(0, dtype=np.int64)
    return buf, starts, lengths, rows, n_docs


def _word_spans(units, min_n, max_n):
    """Word n-grams of each document's token list ``units``, as spans of
    the tokens joined by single spaces."""
    n_docs = len(units)
    counts = np.fromiter((len(u) for u in units), dtype=np.int64,
                         count=n_docs)
    flat = list(chain.from_iterable(units))
    joined = " ".join(flat)
    buf = joined.encode("utf-8")
    if len(buf) == len(joined):
        blen = np.fromiter(map(len, flat), dtype=np.int64, count=len(flat))
    else:
        blen = np.fromiter((len(t.encode("utf-8")) for t in flat),
                           dtype=np.int64, count=len(flat))
    tstart = np.zeros(len(flat), dtype=np.int64)
    np.cumsum(blen[:-1] + 1, out=tstart[1:])
    tend = tstart + blen
    owner = np.repeat(np.arange(n_docs), counts)
    starts, ends, rows = [], [], []
    for n in range(min_n, max_n + 1):
        if n > len(flat):
            break
        j = np.arange(len(flat) - n + 1)
        ok = owner[j] == owner[j + n - 1]
        j = j[ok]
        starts.append(tstart[j])
        ends.append(tend[j + n - 1])
        rows.append(owner[j])
    return _span_arrays(starts, ends, rows, buf, n_docs)


def _char_spans(units, owner, min_n, max_n, n_docs, whole_below):
    """Character n-grams of each string of ``units`` (a document's text,
    or a padded word), as spans of the strings concatenated; ``owner``
    maps a unit to its document. With ``whole_below`` a unit shorter
    than ``min_n`` is one feature, whole (``char_wb``'s short words)."""
    owner = np.asarray(owner, dtype=np.int64)
    joined = "".join(units)
    buf = joined.encode("utf-8")
    off = _utf8_offsets(joined, buf)
    lens = np.fromiter(map(len, units), dtype=np.int64, count=len(units))
    ustart = np.zeros(len(units), dtype=np.int64)
    np.cumsum(lens[:-1], out=ustart[1:])
    unit_of = np.repeat(np.arange(len(units)), lens)
    total = len(joined)
    starts, ends, rows = [], [], []
    for n in range(min_n, max_n + 1):
        if n > total:
            break
        g = np.arange(total - n + 1)
        ok = unit_of[g] == unit_of[g + n - 1]
        g = g[ok]
        starts.append(off[g])
        ends.append(off[g + n])
        rows.append(owner[unit_of[g]])
    if whole_below:
        short = np.flatnonzero(lens < min_n)
        starts.append(off[ustart[short]])
        ends.append(off[ustart[short] + lens[short]])
        rows.append(owner[short])
    return _span_arrays(starts, ends, rows, buf, n_docs)


def _string_spans(analyze, docs):
    """The spans of features that ``analyze`` gives as strings (or
    bytes), one document at a time."""
    parts, rows = [], []
    n_docs = 0
    for i, doc in enumerate(docs):
        n_docs += 1
        for f in analyze(doc):
            if isinstance(f, str):
                f = f.encode("utf-8")
            elif not isinstance(f, bytes):
                raise TypeError("feature names must be strings")
            parts.append(f)
            rows.append(i)
    lengths = np.fromiter(map(len, parts), dtype=np.int64, count=len(parts))
    starts = np.zeros(len(parts), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return (b"".join(parts), starts, lengths,
            np.asarray(rows, dtype=np.int64), n_docs)


def hash_features(buf, starts, lengths, rows, n_docs, n_features,
                  alternate_sign=True, dtype=np.float64):
    """The ``(n_docs, n_features)`` CSR of hashed features: scikit-learn's
    ``FeatureHasher`` over strings (duplicates summed, indices sorted,
    explicit zeros of cancelled signs kept)."""
    from ..native import murmurhash3_32_spans

    if n_docs == 0:
        raise ValueError("Cannot vectorize empty sequence.")
    h = murmurhash3_32_spans(buf, starts, lengths).astype(np.int64)
    index = np.abs(h) % n_features  # -2**31 -> 2**31 % n, as sklearn
    if alternate_sign:
        values = np.where(h >= 0, 1, -1).astype(dtype)
    else:
        values = np.ones(len(h), dtype=dtype)
    out = sparse.coo_matrix((values, (rows, index)),
                            shape=(n_docs, n_features)).tocsr()
    out.sum_duplicates()
    return out


def _check_docs(X):
    if isinstance(X, str):
        raise ValueError("Iterable over raw text documents expected, string "
                         "object received.")


class HashingVectorizer(TransformerMixin, _VectorizerMixin, BaseEstimator):
    """Documents to a ``(n, n_features)`` CSR of hashed n-gram counts,
    stateless: scikit-learn's ``HashingVectorizer``."""

    def __init__(self, *, input="content", encoding="utf-8",
                 decode_error="strict", strip_accents=None, lowercase=True,
                 preprocessor=None, tokenizer=None, stop_words=None,
                 token_pattern=_DEFAULT_TOKEN_PATTERN, ngram_range=(1, 1),
                 analyzer="word", n_features=(2 ** 20), binary=False,
                 norm="l2", alternate_sign=True, dtype=np.float64):
        self.input = input
        self.encoding = encoding
        self.decode_error = decode_error
        self.strip_accents = strip_accents
        self.preprocessor = preprocessor
        self.tokenizer = tokenizer
        self.analyzer = analyzer
        self.lowercase = lowercase
        self.token_pattern = token_pattern
        self.stop_words = stop_words
        self.n_features = n_features
        self.ngram_range = ngram_range
        self.binary = binary
        self.norm = norm
        self.alternate_sign = alternate_sign
        self.dtype = dtype

    def fit(self, X, y=None):
        _check_docs(X)
        self._warn_for_unused_params()
        self._validate_ngram_range()
        return self

    def transform(self, X):
        _check_docs(X)
        self._validate_ngram_range()
        if not isinstance(self.n_features, Integral) or self.n_features < 1:
            raise ValueError(f"n_features must be a positive int; got "
                             f"{self.n_features!r}")
        spans = self._feature_spans(X)
        out = hash_features(*spans, int(self.n_features),
                            alternate_sign=self.alternate_sign,
                            dtype=self.dtype)
        if self.binary:
            out.data.fill(1)
        if self.norm is not None:
            out = normalize(out, norm=self.norm, copy=False)
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


class CountVectorizer(TransformerMixin, _VectorizerMixin, BaseEstimator):
    """Documents to a ``(n, len(vocabulary_))`` CSR of feature counts over
    the sorted vocabulary learnt at fit: scikit-learn's
    ``CountVectorizer`` (``max_df``, ``min_df`` and ``max_features``
    prune it; a given ``vocabulary`` fixes it)."""

    def __init__(self, *, input="content", encoding="utf-8",
                 decode_error="strict", strip_accents=None, lowercase=True,
                 preprocessor=None, tokenizer=None, stop_words=None,
                 token_pattern=_DEFAULT_TOKEN_PATTERN, ngram_range=(1, 1),
                 analyzer="word", max_df=1.0, min_df=1, max_features=None,
                 vocabulary=None, binary=False, dtype=np.int64):
        self.input = input
        self.encoding = encoding
        self.decode_error = decode_error
        self.strip_accents = strip_accents
        self.preprocessor = preprocessor
        self.tokenizer = tokenizer
        self.analyzer = analyzer
        self.lowercase = lowercase
        self.token_pattern = token_pattern
        self.stop_words = stop_words
        self.max_df = max_df
        self.min_df = min_df
        self.max_features = max_features
        self.ngram_range = ngram_range
        self.vocabulary = vocabulary
        self.binary = binary
        self.dtype = dtype

    def _validate_vocabulary(self):
        vocabulary = self.vocabulary
        if vocabulary is None:
            self.fixed_vocabulary_ = False
            return
        if isinstance(vocabulary, set):
            vocabulary = sorted(vocabulary)
        if not isinstance(vocabulary, dict):
            vocab = {}
            for i, t in enumerate(vocabulary):
                if vocab.setdefault(t, i) != i:
                    raise ValueError(f"Duplicate term in vocabulary: {t!r}")
            vocabulary = vocab
        elif sorted(vocabulary.values()) != list(range(len(vocabulary))):
            raise ValueError("Vocabulary indices must be 0 .. n-1, each once.")
        if not vocabulary:
            raise ValueError("empty vocabulary passed to fit")
        self.fixed_vocabulary_ = True
        self.vocabulary_ = dict(vocabulary)

    def _count_vocab(self, raw_documents, fixed_vocab):
        if fixed_vocab:
            vocabulary = self.vocabulary_
        else:
            vocabulary = defaultdict()
            vocabulary.default_factory = vocabulary.__len__
        analyze = self.build_analyzer()
        j_indices, values, indptr = [], [], [0]
        for doc in raw_documents:
            counter = {}
            for feature in analyze(doc):
                try:
                    idx = vocabulary[feature]
                except KeyError:
                    continue
                counter[idx] = counter.get(idx, 0) + 1
            j_indices.extend(counter.keys())
            values.extend(counter.values())
            indptr.append(len(j_indices))
        if not fixed_vocab:
            vocabulary = dict(vocabulary)
            if not vocabulary:
                raise ValueError("empty vocabulary; perhaps the documents "
                                 "only contain stop words")
        itype = np.int64 if indptr[-1] > np.iinfo(np.int32).max else np.int32
        X = sparse.csr_matrix(
            (np.asarray(values, dtype=np.intc),
             np.asarray(j_indices, dtype=itype),
             np.asarray(indptr, dtype=itype)),
            shape=(len(indptr) - 1, len(vocabulary)), dtype=self.dtype)
        X.sort_indices()
        return vocabulary, X

    @staticmethod
    def _sort_features(X, vocabulary):
        sorted_features = sorted(vocabulary.items())
        map_index = np.empty(len(sorted_features), dtype=X.indices.dtype)
        for new, (term, old) in enumerate(sorted_features):
            vocabulary[term] = new
            map_index[old] = new
        X.indices = map_index.take(X.indices, mode="clip")
        return X

    @staticmethod
    def _limit_features(X, vocabulary, high, low, limit):
        dfs = np.bincount(X.indices, minlength=X.shape[1])
        mask = np.ones(len(dfs), dtype=bool)
        if high is not None:
            mask &= dfs <= high
        if low is not None:
            mask &= dfs >= low
        if limit is not None and mask.sum() > limit:
            tfs = np.asarray(X.sum(axis=0)).ravel()
            mask_inds = (-tfs[mask]).argsort()[:limit]
            new_mask = np.zeros(len(dfs), dtype=bool)
            new_mask[np.where(mask)[0][mask_inds]] = True
            mask = new_mask
        new_indices = np.cumsum(mask) - 1
        for term, old in list(vocabulary.items()):
            if mask[old]:
                vocabulary[term] = new_indices[old]
            else:
                del vocabulary[term]
        kept = np.where(mask)[0]
        if len(kept) == 0:
            raise ValueError("After pruning, no terms remain. Try a lower "
                             "min_df or a higher max_df.")
        return X[:, kept]

    def fit(self, raw_documents, y=None):
        self.fit_transform(raw_documents)
        return self

    def fit_transform(self, raw_documents, y=None):
        _check_docs(raw_documents)
        self._validate_ngram_range()
        self._warn_for_unused_params()
        self._validate_vocabulary()
        vocabulary, X = self._count_vocab(raw_documents,
                                          self.fixed_vocabulary_)
        if self.binary:
            X.data.fill(1)
        if not self.fixed_vocabulary_:
            n_doc = X.shape[0]
            max_df, min_df = self.max_df, self.min_df
            high = max_df if isinstance(max_df, Integral) else max_df * n_doc
            low = min_df if isinstance(min_df, Integral) else min_df * n_doc
            if high < low:
                raise ValueError(
                    "max_df corresponds to < documents than min_df")
            if self.max_features is not None:
                X = self._sort_features(X, vocabulary)
            X = self._limit_features(X, vocabulary, high, low,
                                     self.max_features)
            if self.max_features is None:
                X = self._sort_features(X, vocabulary)
            self.vocabulary_ = vocabulary
        return X

    def transform(self, raw_documents):
        _check_docs(raw_documents)
        if not hasattr(self, "vocabulary_"):
            self._validate_vocabulary()
            if not self.fixed_vocabulary_:
                raise ValueError("Vocabulary not fitted or provided")
        if len(self.vocabulary_) == 0:
            raise ValueError("Vocabulary is empty")
        _, X = self._count_vocab(raw_documents, fixed_vocab=True)
        if self.binary:
            X.data.fill(1)
        return X
