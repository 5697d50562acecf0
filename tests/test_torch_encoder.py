"""The port's ``Encoderizer`` against the JAX package's, on the CPU: every
case of ``tests/test_encoder.py`` through both packages at sizes small,
medium and large, with the port's ``transform`` equal to the JAX
package's (the same CSR structure, data within 1e-12), dict input equal
to pandas input, a carried encoder (``encoderizer_from_reference``)
equal to the JAX one, the encoder's output feeding the port's search,
and a ``ChunkedDataset`` passed through block by block.
"""

import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

from skdist_tpu.distribute.encoder import Encoderizer as JaxEncoderizer
from skdist_tpu_torch.convert import (
    encoderizer_from_reference,
    model_from_reference,
)
from skdist_tpu_torch.distribute.encoder import (
    Encoderizer,
    EncoderizerExtractor,
)

SIZES = ["small", "medium", "large"]


def _mixed_dict(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "num": rng.normal(size=n).tolist(),
        "cat": (["red", "blue", "Green", None] * n)[:n],
        "text": [f"some document number {i} with words {i % 5} héllo"
                 for i in range(n)],
        "tags": [["a", "b"] if i % 2 else ["c"] for i in range(n)],
        "kv": [{"k1": float(i), "k2": 1.0, "s": "v"} for i in range(n)],
        "gaps": ([1.5, None, 3.0, 4.0] * n)[:n],  # categorical, NaN in it
        "holes": [None if i % 5 == 0 else float(v)
                  for i, v in enumerate(rng.normal(size=n))],
    }


@pytest.fixture
def mixed():
    data = _mixed_dict()
    return data, pd.DataFrame.from_dict(data)


def _same(a, b, tol=1e-12):
    assert a.shape == b.shape
    if sparse.issparse(a) or sparse.issparse(b):
        assert sparse.issparse(a) and sparse.issparse(b)
        a, b = a.tocsr(), b.tocsr()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        a, b = a.data, b.data
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("size", SIZES)
def test_infers_types_and_transforms_as_jax(mixed, size):
    data, df = mixed
    ref = JaxEncoderizer(size=size).fit(df)
    enc = Encoderizer(size=size).fit(df)
    assert enc.step_names == ref.step_names
    assert enc.transformer_lengths == ref.transformer_lengths
    for name in ("num_scaler", "cat_onehot", "text_word_vec",
                 "tags_multihot", "kv_dict_encoder", "gaps_onehot",
                 "holes_scaler"):
        assert name in enc.step_names
    assert ("text_char_vec" in enc.step_names) == (size != "small")
    want = ref.transform(df)
    out = enc.transform(df)
    assert out.shape == (len(df), sum(enc.transformer_lengths))
    _same(out, want)
    from_dict = Encoderizer(size=size).fit(data)
    _same(from_dict.transform(data), out, tol=0)
    _same(from_dict.transform(df), out, tol=0)


@pytest.mark.parametrize("size", SIZES)
def test_carried_encoder_transforms_as_jax(mixed, size):
    data, df = mixed
    ref = JaxEncoderizer(size=size).fit(df)
    carried = encoderizer_from_reference(ref)
    assert type(model_from_reference(ref)) is Encoderizer
    blob = pickle.dumps(carried)
    assert b"sklearn" not in blob and b"skdist_tpu." not in blob
    loaded = pickle.loads(blob)
    _same(loaded.transform(data), ref.transform(df), tol=0)
    assert loaded.transformer_lengths == ref.transformer_lengths
    with pytest.raises(ValueError, match="not fitted"):
        encoderizer_from_reference(JaxEncoderizer())


@pytest.mark.parametrize("size", SIZES)
def test_dict_and_numpy_input(size):
    data = {
        "a": [1.0, 2.0, 3.0, 4.0],
        "b": ["alpha beta", "gamma delta", "epsilon zeta", "eta theta"],
    }
    enc = Encoderizer(size=size).fit(data)
    ref = JaxEncoderizer(size=size).fit(data)
    _same(enc.transform(data), ref.transform(data))
    X = np.random.RandomState(0).normal(size=(10, 2))
    with pytest.raises(ValueError, match="col_names"):
        Encoderizer(size=size).fit(X)
    enc = Encoderizer(size=size, col_names=["a", "b"]).fit(X)
    ref = JaxEncoderizer(size=size, col_names=["a", "b"]).fit(X)
    _same(enc.transform(X), ref.transform(X))
    short = [[1.0, "x y"], [2.0, "y z"], [None, "z w"], [4.0, "w v"]]
    for cls in (Encoderizer, JaxEncoderizer):  # no token of two letters
        with pytest.raises(ValueError, match="variance threshold"):
            cls(size=size, col_names=["n", "t"]).fit(short)
    rows = [[1.0, "xx yy"], [2.0, "yy zz"], [None, "zz ww"], [4.0, "ww vv"]]
    enc = Encoderizer(size=size, col_names=["n", "t"]).fit(rows)
    ref = JaxEncoderizer(size=size, col_names=["n", "t"]).fit(rows)
    assert enc.step_names == ref.step_names
    _same(enc.transform(rows), ref.transform(rows))


@pytest.mark.parametrize("size", SIZES)
def test_explicit_config_and_weights(mixed, size):
    data, df = mixed
    kw = dict(size=size, config={"num": "numeric", "cat": "onehotencoder",
                                 "text": "string_vectorizer"},
              transformer_weights={"num_scaler": 2.0})
    enc = Encoderizer(**kw).fit(df)
    ref = JaxEncoderizer(**kw).fit(df)
    assert set(enc.step_names) == set(ref.step_names)
    _same(enc.transform(data), ref.transform(df))


@pytest.mark.parametrize("size", SIZES)
def test_feature_origin_extract_and_extractor(mixed, size):
    data, df = mixed
    enc = Encoderizer(size=size).fit(data)
    ref = JaxEncoderizer(size=size).fit(df)
    last = sum(enc.transformer_lengths) - 1
    for i in (0, 1, last // 2, last):
        assert enc.feature_origin(i) == ref.feature_origin(i)
    sliced = enc.extract(["num_scaler"])
    assert sliced.transform(data).shape == (len(df), 1)
    ext = EncoderizerExtractor(enc, ["num_scaler", "cat_onehot"])
    out = ext.fit(data).transform(data)
    assert out.shape[1] == sum(enc.transformer_lengths[:2])
    _same(out, EncoderizerExtractor(ref, ["num_scaler", "cat_onehot"])
          .transform(df))


@pytest.mark.parametrize("size", SIZES)
def test_errors_and_warnings(size):
    bad = {"bad": ["[1, 2]", "[3]", "[4, 5]", "[6]"]}
    with pytest.raises(ValueError, match="Convert this column to list"):
        Encoderizer(size=size).fit(bad)
    nil = {"ok": [1.0, 2.0, 3.0, 4.0], "nil": [None, None, None, None]}
    with pytest.warns(UserWarning, match="entirely null"):
        enc = Encoderizer(size=size).fit(nil)
    assert enc.step_names == ["ok_scaler"]
    with pytest.raises(ValueError, match="Cannot parse input"):
        Encoderizer(size=size).fit(42)


@pytest.mark.parametrize("size", SIZES)
def test_pickle(mixed, size):
    data, _ = mixed
    enc = Encoderizer(size=size).fit(data)
    loaded = pickle.loads(pickle.dumps(enc))
    assert (loaded.transform(data) != enc.transform(data)).nnz == 0


def test_chunked_dataset_refused(mixed):
    """A ChunkedDataset was refused until the data plane was ported; now
    ``transform`` of one is the lazy pass-through, block by block, equal to
    ``transform`` of the same rows (its parity with the JAX package is in
    ``tests/test_torch_streaming.py``)."""
    from skdist_tpu_torch.data import ChunkedDataset

    rng = np.random.RandomState(0)
    data = {"num": rng.normal(size=40), "holes": np.where(
        rng.rand(40) < 0.2, np.nan, rng.normal(size=40))}
    enc = Encoderizer().fit(data)
    ds = ChunkedDataset.from_arrays(np.column_stack([data["num"],
                                                     data["holes"]]),
                                    block_rows=16)
    out = enc.transform(ds)
    assert isinstance(out, ChunkedDataset) and out.n_blocks == 3
    want = enc.transform({k: v.astype(np.float32) for k, v in data.items()})
    want = want.toarray() if sparse.issparse(want) else want
    np.testing.assert_array_equal(out.materialize(),
                                  np.asarray(want, np.float32))


def test_encoder_feeds_the_ports_search(mixed):
    from skdist_tpu.distribute.search import DistGridSearchCV as JaxSearch
    from skdist_tpu.models import LogisticRegression as JaxLR
    from skdist_tpu.parallel import TPUBackend

    from skdist_tpu_torch import (
        CUDABackend,
        DistGridSearchCV,
        LogisticRegression,
    )

    data, df = mixed
    y = (np.arange(len(df)) % 2).astype(int)
    X = Encoderizer(size="small").fit(data).transform(data)
    Xj = JaxEncoderizer(size="small").fit(df).transform(df)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gs = DistGridSearchCV(
            LogisticRegression(max_iter=50, engine="xla", device="cpu"),
            {"C": [0.1, 1.0]}, cv=2, scoring="accuracy",
            backend=CUDABackend(device="cpu")).fit(X, y)
        ref = JaxSearch(JaxLR(max_iter=50, engine="xla"), {"C": [0.1, 1.0]},
                        cv=2, scoring="accuracy",
                        backend=TPUBackend()).fit(
            np.asarray(Xj.todense(), dtype=np.float32), y)
    assert hasattr(gs, "best_estimator_")
    np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], atol=1e-6)
