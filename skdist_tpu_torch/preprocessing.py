"""
Pipeline-compatible preprocessing transformers: the port of
``skdist_tpu/preprocessing.py``.

Column selection, dtype casting, null imputation, dense/sparse
conversion, pipeline-safe label encoding, memory-efficient univariate
selection, chunked hashing vectorisation, the native FNV hashing
vectorizer, multi-hot encoding and randomized truncated SVD. All but the
SVD are host work, as in the JAX package; they run on the port's own
copies of the scikit-learn pieces (``featurize/``) and read frames
through ``utils/frame.py`` (a pandas frame is taken by duck typing).
``TruncatedSVDTransformer``'s dense products run on ``device`` (the
card unless ``device="cpu"``) in true float32.
"""

import warnings

import numpy as np
from scipy import sparse

from .base import BaseEstimator, TransformerMixin
from .featurize import labels as _labels
from .featurize import selection as _selection
from .featurize.scale import normalize
from .featurize.text import HashingVectorizer
from .utils.frame import Frame, as_frame, isnull

__all__ = [
    "SelectField",
    "FeatureCast",
    "ImputeNull",
    "DenseTransformer",
    "SparseTransformer",
    "LabelEncoderPipe",
    "SelectorMem",
    "HashingVectorizerChunked",
    "FastHashingVectorizer",
    "MultihotEncoder",
    "TruncatedSVDTransformer",
]

def _check_docs_iterable(X):
    if isinstance(X, str):
        raise ValueError(
            "Iterable over raw text documents expected, "
            "string object received."
        )


def _doc_chunks(X, chunksize):
    """Split a document list into transform chunks (shared by the
    chunked vectorizers)."""
    if chunksize is None or len(X) <= chunksize:
        return [X]
    return [X[i:i + chunksize] for i in range(0, len(X), chunksize)]


_SELECTOR_LOOKUP = {
    "fpr": _selection.SelectFpr,
    "fdr": _selection.SelectFdr,
    "kbest": _selection.SelectKBest,
    "percentile": _selection.SelectPercentile,
    "fwe": _selection.SelectFwe,
}


class SelectField(BaseEstimator, TransformerMixin):
    """Select columns of a frame as numpy values: one column's 1-D values
    with ``single_dimension``, else a 2-D array (a pandas frame or a dict
    of columns is read as a :class:`~skdist_tpu_torch.utils.frame.Frame`)."""

    def __init__(self, cols=None, single_dimension=False):
        self.cols = cols
        self.single_dimension = single_dimension

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        if not isinstance(X, Frame):
            X = as_frame(X)
        if self.cols is None:
            return X.values
        if len(self.cols) == 1 and self.single_dimension:
            return X[self.cols[0]].values
        return X[list(self.cols)].values


class FeatureCast(BaseEstimator, TransformerMixin):
    """Cast an array's dtype (``astype(cast_type)``)."""

    def __init__(self, cast_type=None):
        self.cast_type = cast_type

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        if self.cast_type is None:
            return X
        return X.astype(self.cast_type)


class ImputeNull(BaseEstimator, TransformerMixin):
    """Replace nulls (None, NaN, NaT: ``utils.frame.isnull``, pandas'
    ``isnull``) with a constant."""

    def __init__(self, impute_val=None):
        self.impute_val = impute_val

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        if self.impute_val is None:
            return X
        X = np.asarray(X, dtype=object) if not isinstance(X, np.ndarray) else X.copy()
        X[isnull(X)] = self.impute_val
        return X


class DenseTransformer(BaseEstimator, TransformerMixin):
    """Densify sparse input."""

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        return np.asarray(X.todense()) if sparse.issparse(X) else X


class SparseTransformer(BaseEstimator, TransformerMixin):
    """Sparsify dense input (CSR)."""

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        return X if sparse.issparse(X) else sparse.csr_matrix(X)


class LabelEncoderPipe(BaseEstimator, TransformerMixin):
    """Pipeline-safe label encoder producing a column vector."""

    def fit(self, X, y=None):
        self.le_ = _labels.LabelEncoder().fit(X)
        return self

    def transform(self, X, y=None):
        return self.le_.transform(X).reshape(-1, 1)


class SelectorMem(BaseEstimator, TransformerMixin):
    """Univariate feature selection storing only the cheaper of
    bool-mask vs int-indices (``mask``)."""

    def __init__(self, selector="fpr",
                 score_func=_selection.f_classif, threshold=0.05):
        self.selector = selector
        self.score_func = score_func
        self.threshold = threshold

    def fit(self, X, y=None):
        sel = _SELECTOR_LOOKUP[self.selector.lower()](
            score_func=self.score_func, **self._threshold_kw()
        )
        sel.fit(X, y)
        mask_idx = sel.get_support(indices=True)
        mask_bool = sel.get_support(indices=False)
        self.mask = (
            mask_idx
            if np.asarray(mask_bool).nbytes > np.asarray(mask_idx).nbytes
            else mask_bool
        )
        return self

    def _threshold_kw(self):
        name = self.selector.lower()
        if name == "kbest":
            return {"k": self.threshold}
        if name == "percentile":
            return {"percentile": self.threshold}
        return {"alpha": self.threshold}

    def transform(self, X, y=None):
        return X[:, self.mask]


class HashingVectorizerChunked(HashingVectorizer):
    """``HashingVectorizer`` (``featurize/text.py``, scikit-learn's) with
    a chunked transform to bound peak memory."""

    def __init__(self, chunksize=100000, n_features=2**20, norm="l2",
                 binary=False, alternate_sign=True, analyzer="word",
                 ngram_range=(1, 1), lowercase=True, stop_words=None,
                 token_pattern=r"(?u)\b\w\w+\b", strip_accents=None,
                 decode_error="strict", input="content", encoding="utf-8",
                 preprocessor=None, tokenizer=None, dtype=np.float64):
        self.chunksize = chunksize
        HashingVectorizer.__init__(
            self, n_features=n_features, norm=norm, binary=binary,
            alternate_sign=alternate_sign, analyzer=analyzer,
            ngram_range=ngram_range, lowercase=lowercase,
            stop_words=stop_words, token_pattern=token_pattern,
            strip_accents=strip_accents, decode_error=decode_error,
            input=input, encoding=encoding, preprocessor=preprocessor,
            tokenizer=tokenizer, dtype=dtype,
        )

    def transform(self, X):
        _check_docs_iterable(X)
        chunks = _doc_chunks(X, self.chunksize)
        if len(chunks) == 1:
            return HashingVectorizer.transform(self, chunks[0])
        return sparse.vstack([
            HashingVectorizer.transform(self, c) for c in chunks
        ]).tocsr()


class FastHashingVectorizer(BaseEstimator, TransformerMixin):
    """Text hashing through the native C kernel
    (``skdist_tpu_torch/native/fasthash.c``), with a byte-identical
    pure-Python fallback when no compiler is available.

    Word or char_wb n-grams, FNV-1a hashed into ``n_features`` buckets,
    optional binary counts and L1/L2 row normalisation. Stateless (fit is
    a no-op); a chunked transform bounds peak memory like
    ``HashingVectorizerChunked``.
    """

    def __init__(self, n_features=2**12, ngram_range=(1, 1),
                 analyzer="word", lowercase=True, binary=False, norm="l2",
                 chunksize=100000, force_python=False):
        self.n_features = n_features
        self.ngram_range = ngram_range
        self.analyzer = analyzer
        self.lowercase = lowercase
        self.binary = binary
        self.norm = norm
        self.chunksize = chunksize
        self.force_python = force_python

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        from .native import hash_documents

        _check_docs_iterable(X)
        X = list(X)
        chunks = _doc_chunks(X, self.chunksize)
        outs = [
            hash_documents(
                c, n_features=self.n_features, ngram_range=self.ngram_range,
                analyzer=self.analyzer, lowercase=self.lowercase,
                binary=self.binary, force_python=self.force_python,
            )
            for c in chunks
        ]
        out = outs[0] if len(outs) == 1 else sparse.vstack(outs).tocsr()
        if self.norm is not None and out.shape[0] > 0:
            out = normalize(out, norm=self.norm, copy=False)
        return out


class MultihotEncoder(BaseEstimator, TransformerMixin):
    """Pipeline-safe multi-label binarizer ignoring unseen labels."""

    def __init__(self, sparse_output=False):
        self.sparse_output = sparse_output

    def fit(self, X, y=None):
        self.transformer_ = _labels.MultiLabelBinarizer().fit(X)
        return self

    def transform(self, X, y=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            X_t = self.transformer_.transform(X)
        return sparse.csr_matrix(X_t) if self.sparse_output else X_t

    @property
    def classes_(self):
        return self.transformer_.classes_


class TruncatedSVDTransformer(BaseEstimator, TransformerMixin):
    """Randomized truncated SVD (Halko-Martinsson-Tropp) for feature
    reduction ahead of the dense path.

    ``X`` (sparse or dense, width ``d``) is projected onto its top
    ``n_components`` right-singular directions; the ``(n,
    n_components)`` output is narrow enough for the dense kernels. The
    range finder's products against the full-width X: a sparse X stays
    in scipy's CSR kernels on the host; a dense X's products run on
    ``device`` (the card unless ``device="cpu"``) through
    ``torch.matmul`` in true float32 (TF32 off). QR and the small SVD
    stay numpy on the host. No centering is applied (scikit-learn
    ``TruncatedSVD`` semantics, which keep X sparse). The fitted state
    (``components_``, ``singular_values_``, ``explained_variance_``,
    ``explained_variance_ratio_``) is numpy and pickles clean.
    """

    def __init__(self, n_components=128, n_iter=4, n_oversamples=10,
                 random_state=0, device=None):
        self.n_components = n_components
        self.n_iter = n_iter
        self.n_oversamples = n_oversamples
        self.random_state = random_state
        self.device = device

    def _matmul(self, A, B):
        """``A @ B`` as float32 numpy: scipy on the host for a sparse
        ``A``, else ``torch.matmul`` on ``device``."""
        if sparse.issparse(A):
            return np.asarray(A @ B)
        import torch

        from .utils.device import exact_matmuls, resolve_device

        dev = resolve_device(self.device)
        with exact_matmuls():
            out = torch.matmul(
                torch.as_tensor(np.asarray(A, dtype=np.float32), device=dev),
                torch.as_tensor(np.asarray(B, dtype=np.float32), device=dev))
        return out.cpu().numpy()

    def fit(self, X, y=None):
        n, d = X.shape
        k = int(self.n_components)
        if not 1 <= k <= min(n, d):
            raise ValueError(
                f"n_components={k} must be in [1, min(n, d)="
                f"{min(n, d)}]"
            )
        sketch = min(k + int(self.n_oversamples), min(n, d))
        rng = np.random.RandomState(self.random_state)
        G = rng.normal(size=(d, sketch)).astype(np.float32)
        Y = self._matmul(X, G)
        # power iterations with QR re-orthonormalisation each half-step
        # (f32 range-finding loses the small singular directions
        # without it)
        XT = X.T.tocsr() if sparse.issparse(X) else X.T
        for _ in range(int(self.n_iter)):
            Q, _ = np.linalg.qr(Y)
            Z = self._matmul(XT, Q)
            Q, _ = np.linalg.qr(Z)
            Y = self._matmul(X, Q)
        Q, _ = np.linalg.qr(Y)
        B = self._matmul(XT, Q).T  # (sketch, d)
        _, s, Vt = np.linalg.svd(B, full_matrices=False)
        self.components_ = np.ascontiguousarray(Vt[:k])
        self.singular_values_ = s[:k]
        self.n_features_in_ = d
        # scikit-learn's surface: variance of the projected columns over
        # the training rows, and its share of the total feature variance
        Xt = self._matmul(X, self.components_.T)
        self.explained_variance_ = Xt.var(axis=0)
        if sparse.issparse(X):
            mean = np.asarray(X.mean(axis=0)).ravel()
            sq = np.asarray(X.multiply(X).mean(axis=0)).ravel()
            full_var = float((sq - mean ** 2).sum())
        else:
            full_var = float(np.asarray(X).var(axis=0).sum())
        self.explained_variance_ratio_ = (
            self.explained_variance_ / full_var if full_var > 0
            else np.zeros_like(self.explained_variance_)
        )
        return self

    def transform(self, X, y=None):
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; TruncatedSVDTransformer "
                f"was fitted with {self.n_features_in_}"
            )
        return self._matmul(X, self.components_.T)
