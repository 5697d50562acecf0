"""
Encoderizer: mixed-type feature encoding with per-transformer fan-out,
the port of ``skdist_tpu/distribute/encoder.py``.

A FeatureUnion-style encoder that accepts a dict of columns, a 2-D
numpy array or a list of rows with ``col_names``, a pandas frame (read
by duck typing; pandas is never imported) or anything with
``toPandas``. It infers a pipeline a column from its values and
cardinality (or takes an explicit ``config``), fits each pipeline as
one host task (``backend.run_tasks`` over a host ``LocalBackend`` by
default), records each one's output width, maps a feature index to the
step that made it, and can ``extract`` a fitted slice of itself. The
work is host numpy/scipy, as in the JAX package; the card's part starts
at the matrix it returns (CSR when any step is sparse).
"""

import ast
import copy as _copy

import numpy as np
from scipy import sparse

from ..base import BaseEstimator, TransformerMixin, clone, strip_runtime
from ..parallel import LocalBackend, resolve_backend
from ..utils.frame import as_frame
from ..utils.validation import check_is_fitted

__all__ = ["Encoderizer", "EncoderizerExtractor"]


class Encoderizer(BaseEstimator, TransformerMixin):
    """Flexible-input feature encoder with inferred or configured
    per-column pipelines."""

    def __init__(self, transformer_list=None, transformer_weights=None,
                 n_jobs=None, size="small", config=None, col_names=None,
                 backend=None, partitions="auto", verbose=0):
        self.transformer_list = transformer_list
        self.transformer_weights = transformer_weights
        self.n_jobs = n_jobs
        self.size = size
        self.config = config
        self.col_names = col_names
        self.backend = backend
        self.partitions = partitions
        self.verbose = verbose

    # ------------------------------------------------------------------
    def fit(self, X, y=None):
        # host tasks: the default LocalBackend never touches a device
        backend = (LocalBackend(n_jobs=self.n_jobs, device="cpu")
                   if self.backend is None
                   else resolve_backend(self.backend, n_jobs=self.n_jobs))
        X = self._process_input(X)
        # the constructor param is never mutated (clone(fitted) must
        # reproduce the unfitted config): transformers are cloned, fit,
        # and stored in the fitted-state `transformer_list_`
        templates = self.transformer_list
        if templates is None:
            templates = self._infer_transformers(X)
        templates = list(templates)
        if not templates:
            raise ValueError("No transformers to fit (all columns null?)")

        def fit_one(item):
            name, trans = item
            t = clone(trans, safe=False)
            return t.fit(X, y) if y is not None else t.fit(X)

        fitted = backend.run_tasks(
            fit_one,
            [(name, trans) for name, trans in templates],
            verbose=self.verbose,
        )
        self.transformer_list_ = [
            (name, fit_t)
            for (name, _), fit_t in zip(templates, fitted)
        ]
        self._feature_indices(X)
        strip_runtime(self)
        return self

    @property
    def _steps(self):
        """Fitted (name, transformer) pairs when fit has run, else the
        constructor's template list — so ``step_names`` answers both
        pre- and post-fit, as before."""
        fitted = getattr(self, "transformer_list_", None)
        return fitted if fitted is not None else (self.transformer_list or [])

    def transform(self, X):
        check_is_fitted(self, "transformer_lengths")
        if type(X).__name__ == "ChunkedDataset":
            raise NotImplementedError(
                "Encoderizer.transform over a ChunkedDataset (the streamed "
                "encode) is not ported to skdist_tpu_torch yet (see "
                "ROADMAP.md, queue 1 item 9)")
        X = self._process_input(X, fit=False)
        weights = self.transformer_weights or {}
        Xs = []
        for name, trans in self.transformer_list_:
            out = trans.transform(X)
            w = weights.get(name)
            if w is not None:
                out = out * w
            Xs.append(out)
        if not Xs:
            return np.zeros((len(X), 0))
        if any(sparse.issparse(f) for f in Xs):
            return sparse.hstack(Xs).tocsr()
        return np.hstack([np.asarray(f) for f in Xs])

    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y).transform(X)

    # ------------------------------------------------------------------
    def extract(self, step_names):
        """Fitted copy holding only the requested steps."""
        check_is_fitted(self, "transformer_lengths")
        enc = _copy.copy(self)
        keep = [i for i, n in enumerate(self.step_names) if n in step_names]
        enc.transformer_list_ = [self.transformer_list_[i] for i in keep]
        enc.transformer_lengths = [self.transformer_lengths[i] for i in keep]
        return enc

    def feature_origin(self, index, mask=None):
        """Step name owning transformed-feature ``index``."""
        cumulative = np.cumsum(self.transformer_lengths)
        if mask is not None:
            cumulative = np.array([mask[x - 1] for x in cumulative])
        return self.step_names[int(np.argmax(cumulative > index))]

    @property
    def step_names(self):
        return [name for name, _ in self._steps]

    # ------------------------------------------------------------------
    def _process_input(self, X, fit=True):
        """dict / numpy / list / pandas-like / spark-like -> the port's
        :class:`~skdist_tpu_torch.utils.frame.Frame`."""
        if isinstance(X, (np.ndarray, list)):
            if fit and self.col_names is None:
                raise ValueError("Must supply col_names with numpy array input")
            out = as_frame(X, list(self.col_names if fit else self.fields_))
        elif isinstance(X, dict):
            try:
                out = as_frame(X)
            except Exception as exc:
                raise ValueError("Cannot parse input") from exc
        elif hasattr(X, "toPandas") and not hasattr(X, "to_numpy"):
            out = as_frame(X.toPandas())
        else:
            out = as_frame(X)
        if fit:
            self.fields_ = list(out.columns)
        return out

    def _infer_transformers(self, X):
        from ._defaults import _default_encoders

        if self.config is not None:
            lst = [
                _default_encoders[self.size][v](c)
                for c, v in self.config.items()
            ]
        else:
            lst = [self._infer_column(c, X[c]) for c in X.columns]
        return [item for sub in lst if sub is not None for item in sub]

    @staticmethod
    def _first_non_null(col):
        vals = col.values
        for v in vals:
            if v is not None and not (isinstance(v, float) and np.isnan(v)):
                return v
        return None

    @classmethod
    def _container_kind(cls, col, col_name):
        """dict / list / tuple sniffing, with the guard against a string
        that parses as a container."""
        v = cls._first_non_null(col)
        if isinstance(v, str):
            try:
                parsed = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                return None
            kind = type(parsed).__name__
            if kind in ("dict", "list", "tuple"):
                raise ValueError(
                    f"Convert this column to {kind} before fitting: {col_name}"
                )
            return None
        if isinstance(v, dict):
            return "dict"
        if isinstance(v, (list, tuple)):
            return "container"
        return None

    def _infer_column(self, col_name, col, thresh=0.10):
        """Per-column encoder inference: dict -> DictVectorizer;
        list/tuple -> multihot; else numeric vs categorical (<10%
        unique) vs free text."""
        from ._defaults import _default_encoders

        registry = _default_encoders[self.size]
        if col.isnull().all():
            import warnings

            warnings.warn(f"Column is entirely null: {col_name}")
            return None
        kind = self._container_kind(col, col_name)
        if kind == "dict":
            return registry["dict"](col_name)
        if kind == "container":
            return registry["multihotencoder"](col_name)
        try:
            np.mean(col.values)
            is_numeric = True
        except Exception:
            is_numeric = False
        pct_unique = col.nunique() / float(len(col))
        is_categorical = pct_unique < thresh
        if not is_numeric and not is_categorical:
            return registry["string_vectorizer"](col_name)
        if is_numeric and not is_categorical:
            return registry["numeric"](col_name)
        return registry["onehotencoder"](col_name)

    def _feature_indices(self, X):
        """Record per-transformer output widths."""
        lengths = []
        head = X.head(1)
        for _, trans in self.transformer_list_:
            out = trans.transform(head)
            lengths.append(
                len(out[0]) if isinstance(out, list) else out.shape[1]
            )
        self.transformer_lengths = lengths


class EncoderizerExtractor(BaseEstimator, TransformerMixin):
    """Pass-through slice of a fitted Encoderizer, for pipeline
    hyperparameter search."""

    def __init__(self, encoderizer, step_names):
        self.encoderizer = encoderizer
        self.step_names = step_names

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return self.encoderizer.extract(self.step_names).transform(X)
