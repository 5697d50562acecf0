"""
The port's own copies of the scikit-learn transformers that
featurisation (``distribute/encoder.py``, ``distribute/_defaults.py``,
``preprocessing.py``) leans on. The card's machine has no scikit-learn,
so each is written out here from scikit-learn's documented behaviour,
module by module under scikit-learn's names, and held to scikit-learn
on the CPU by ``tests/test_torch_text.py`` and
``tests/test_torch_featurize.py``:

- ``text``: ``CountVectorizer``, ``HashingVectorizer`` (n-grams hashed
  with the signed MurmurHash3 of ``native/murmurhash.c``);
- ``dict_vectorizer``: ``DictVectorizer``;
- ``impute``: ``SimpleImputer``;
- ``scale``: ``StandardScaler``, ``normalize``;
- ``labels``: ``LabelEncoder``, ``MultiLabelBinarizer``;
- ``selection``: ``VarianceThreshold``, ``f_classif`` and the
  univariate selectors;
- ``pipeline``: ``Pipeline``.

Everything here is host numpy/scipy work: the card's part starts at
the matrix these produce.
"""

from .dict_vectorizer import DictVectorizer
from .impute import SimpleImputer
from .labels import LabelEncoder, MultiLabelBinarizer
from .pipeline import Pipeline
from .scale import StandardScaler, normalize
from .selection import (
    SelectFdr,
    SelectFpr,
    SelectFwe,
    SelectKBest,
    SelectPercentile,
    VarianceThreshold,
    f_classif,
)
from .text import CountVectorizer, HashingVectorizer

__all__ = [
    "CountVectorizer",
    "DictVectorizer",
    "HashingVectorizer",
    "LabelEncoder",
    "MultiLabelBinarizer",
    "Pipeline",
    "SelectFdr",
    "SelectFpr",
    "SelectFwe",
    "SelectKBest",
    "SelectPercentile",
    "SimpleImputer",
    "StandardScaler",
    "VarianceThreshold",
    "f_classif",
    "normalize",
]
