"""
The default encoder registry of ``Encoderizer``'s type inference: a
copy of ``skdist_tpu/distribute/_defaults.py``, over the port's own
transformers (``featurize/``, ``preprocessing.py``).

Size (``small``/``medium``/``large``) x encoder type
(``string_vectorizer``/``onehotencoder``/``multihotencoder``/
``numeric``/``dict``) -> a factory producing ``[(step_name, pipeline),
...]``, with the JAX package's step names and widths. Sizes differ in
text handling: small = word 1-2grams; medium adds char_wb 3-4grams;
large = word 1-3 + char_wb 2-5, hashed into 2**12 / 2**13 / 2**14
columns.

The one-hot encoder gives ``CountVectorizer`` an identity tokenizer, so
a value's features are its lowercased characters, not the value: a
quirk of the reference, kept so that the two packages encode alike.
"""

from ..featurize import (
    CountVectorizer,
    DictVectorizer,
    Pipeline,
    SimpleImputer,
    StandardScaler,
    VarianceThreshold,
)
from ..preprocessing import (
    FeatureCast,
    HashingVectorizerChunked,
    ImputeNull,
    MultihotEncoder,
    SelectField,
)

__all__ = ["_default_encoders"]


def tokenizer(x):
    """Identity tokenizer (pre-tokenised categorical values)."""
    return x


def dict_encoder(c):
    return [(
        f"{c}_dict_encoder",
        Pipeline([
            ("var", SelectField(cols=[c], single_dimension=True)),
            ("fillna", ImputeNull({})),
            ("vec", DictVectorizer()),
        ]),
    )]


def onehot_encoder(c):
    return [(
        f"{c}_onehot",
        Pipeline([
            ("var", SelectField(cols=[c], single_dimension=True)),
            ("cast", FeatureCast(cast_type=str)),
            ("fillna", ImputeNull("")),
            ("vec", CountVectorizer(
                token_pattern=None, tokenizer=tokenizer, binary=True,
                decode_error="ignore",
            )),
        ]),
    )]


def multihot_encoder(c):
    return [(
        f"{c}_multihot",
        Pipeline([
            ("var", SelectField(cols=[c], single_dimension=True)),
            ("fillna", ImputeNull([])),
            ("vec", MultihotEncoder()),
        ]),
    )]


def numeric_encoder(c):
    return [(
        f"{c}_scaler",
        Pipeline([
            ("var", SelectField(cols=[c])),
            ("imputer", SimpleImputer(strategy="median")),
            ("scaler", StandardScaler(copy=False)),
        ]),
    )]


def _text_vec(c, suffix, analyzer, ngram_range, n_features):
    return (
        f"{c}_{suffix}",
        Pipeline([
            ("var", SelectField(cols=[c], single_dimension=True)),
            ("fillna", ImputeNull(" ")),
            ("vec", HashingVectorizerChunked(
                ngram_range=ngram_range, analyzer=analyzer,
                n_features=n_features, alternate_sign=False,
                decode_error="ignore",
            )),
            ("var_thresh", VarianceThreshold()),
        ]),
    )


def _string_small(c):
    return [_text_vec(c, "word_vec", "word", (1, 2), 2**12)]


def _string_medium(c):
    return [
        _text_vec(c, "word_vec", "word", (1, 3), 2**13),
        _text_vec(c, "char_vec", "char_wb", (3, 4), 2**13),
    ]


def _string_large(c):
    return [
        _text_vec(c, "word_vec", "word", (1, 3), 2**14),
        _text_vec(c, "char_vec", "char_wb", (2, 5), 2**14),
    ]


def _size_registry(string_vectorizer):
    return {
        "string_vectorizer": string_vectorizer,
        "onehotencoder": onehot_encoder,
        "multihotencoder": multihot_encoder,
        "numeric": numeric_encoder,
        "dict": dict_encoder,
    }


_default_encoders = {
    "small": _size_registry(_string_small),
    "medium": _size_registry(_string_medium),
    "large": _size_registry(_string_large),
}
