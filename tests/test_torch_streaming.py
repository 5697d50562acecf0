"""The port's streamed fits and chunked prediction over a ``ChunkedDataset``
(``skdist_tpu_torch/models/streaming.py``, ``distribute/predict.py``,
``distribute/encoder.py``) against the JAX package's, on the CPU, on the
same numpy inputs made from a seed.

Tolerances: a streamed ``LogisticRegression``/``LinearSVC`` fit is held to
the JAX package's streamed fit of the same dataset and to the port's
resident fit at ``coef_`` within 5e-4 absolute, the bound of the JAX
package's own streamed-vs-resident tests (``tests/test_streaming.py``):
block sums reorder the float32 reductions, and the two packages' solvers
stop at ``tol`` on different iterations; predictions agree on at least
99.5% of rows. Bitwise: serial and pipelined feeds of one fit; chunked
prediction and the resident blocked prediction at ``batch_size`` = the
block rows; the encoder's pass-through and the JAX package's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu import data as jdata
from skdist_tpu.distribute.encoder import Encoderizer as JaxEncoderizer
from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu_torch import (
    DistGridSearchCV,
    DistOneVsRestClassifier,
    LocalBackend,
    batch_predict,
)
from skdist_tpu_torch.data import ChunkedDataset
from skdist_tpu_torch.distribute.encoder import Encoderizer
from skdist_tpu_torch.models import (
    LinearSVC,
    LogisticRegression,
    RidgeClassifier,
    SGDClassifier,
)
from skdist_tpu_torch.models import gbdt as tg
from skdist_tpu_torch.models.streaming import stream_fit_estimator
from skdist_tpu_torch.models.forest import RandomForestClassifier

#: converged fits (``n_iter_`` under ``max_iter``): a tighter ``tol`` sits
#: below the float32 noise of these sums, where both packages' line
#: searches stall on rounding
KW = dict(tol=1e-3, max_iter=100)
#: C of each family; the squared hinge is kept well conditioned, as in
#: ``tests/test_torch_svc.py``
C = {"logreg": 0.5, "svc": 0.05}


def _clf(n=360, d=10, k=3, seed=0, sparse=False):
    """Separable-ish classes around seeded centres; ``sparse`` keeps about
    a fifth of the entries (CSR)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    centres = rng.normal(scale=1.5, size=(k, d))
    X = (centres[y] + rng.normal(size=(n, d))).astype(np.float32)
    if sparse:
        X = sp.csr_matrix(X * (rng.rand(n, d) < 0.2), dtype=np.float32)
    return X, y


def _weights(n, seed=1):
    return np.random.RandomState(seed).uniform(0.2, 2.0, n).astype(
        np.float32)


FITS = [  # (family, classes, X kind, weighted, block_rows)
    ("logreg", 2, "dense", False, 100),
    ("logreg", 3, "packed", True, 128),
    ("logreg", 3, "dense", True, 90),
    ("svc", 2, "dense", True, 128),
    ("svc", 3, "packed", False, 100),
]


def _models(family):
    c = C[family]
    if family == "logreg":
        return (JaxLR(C=c, engine="xla", **KW),
                LogisticRegression(C=c, device="cpu", engine="xla", **KW))
    return (JaxSVC(C=c, engine="xla", **KW),
            LinearSVC(C=c, device="cpu", engine="xla", **KW))


def _hold(ours, other, X, atol=5e-4):
    np.testing.assert_allclose(ours.coef_, other.coef_, rtol=0, atol=atol)
    np.testing.assert_allclose(ours.intercept_, other.intercept_, rtol=0,
                               atol=atol)
    assert np.mean(ours.predict(X) == other.predict(X)) >= 0.995


@pytest.mark.parametrize("family,k,kind,weighted,block_rows", FITS)
def test_streamed_fit_matches_jax_and_resident(family, k, kind, weighted,
                                               block_rows):
    X, y = _clf(k=k, seed=k, sparse=kind == "packed")
    sw = _weights(len(y)) if weighted else None
    pack = True if kind == "packed" else None
    jds = jdata.ChunkedDataset.from_arrays(X, y, sw, block_rows=block_rows,
                                           pack=pack)
    ds = ChunkedDataset.from_arrays(X, y, sw, block_rows=block_rows,
                                    pack=pack)
    assert ds.x_format == ("packed" if kind == "packed" else "dense")
    ref, ours = _models(family)
    ref.fit(jds)
    ours.fit(ds)
    resident = _models(family)[1].fit(X, y, sample_weight=sw)
    assert int(ours.n_iter_) < KW["max_iter"]
    assert ours.stream_stats_["stream_mode"] == "pipelined"
    np.testing.assert_array_equal(ours.classes_, resident.classes_)
    _hold(ours, ref, X)
    _hold(ours, resident, X)
    if family == "logreg":
        np.testing.assert_allclose(ours.predict_proba(X),
                                   resident.predict_proba(X), atol=1e-4)


def test_serial_and_pipelined_feeds_give_the_same_bits():
    X, y = _clf(k=3, sparse=True)
    ds = ChunkedDataset.from_arrays(X, y, _weights(len(y)), block_rows=64,
                                    pack=True)
    fits = [stream_fit_estimator(LogisticRegression(device="cpu",
                                                    max_iter=30), ds,
                                 sync=sync) for sync in (True, False)]
    serial, pipelined = (f.stream_stats_ for f in fits)
    assert (serial["stream_mode"], pipelined["stream_mode"]) == (
        "serial", "pipelined")
    np.testing.assert_array_equal(fits[0].coef_, fits[1].coef_)
    np.testing.assert_array_equal(fits[0].n_iter_, fits[1].n_iter_)
    # every pass feeds every block: X, the encoded labels, the weights
    block = ds.block_rows * (8 * ds.packed_m + 4 + 4)
    for st in (serial, pipelined):
        assert st["passes"] == st["value_passes"] + st["grad_passes"]
        assert st["grad_passes"] == int(fits[0].n_iter_) + 1
        assert st["blocks_fed"] == st["passes"] * ds.n_blocks
        assert st["streamed_bytes"] == st["passes"] * ds.n_blocks * block


@pytest.mark.parametrize("sync", [True, False])
def test_one_feeder_serves_every_pass_and_a_failed_pass_rewinds(sync):
    from skdist_tpu_torch.models.linear import _freeze
    from skdist_tpu_torch.models.streaming import StreamedObjective

    X, y = _clf(k=3, sparse=True)
    ds = ChunkedDataset.from_arrays(X, y, _weights(len(y)), block_rows=64,
                                    pack=True)
    est = LogisticRegression(device="cpu")
    y_enc, sw, meta = est._prep_stream_fit(ds, y)
    hyper = {"C": np.ones(1, np.float32), "tol": np.full(1, 1e-3, np.float32)}
    obj = StreamedObjective(LogisticRegression, meta,
                            _freeze(est._static_config(meta)), ds,
                            {"y": y_enc, "sw": sw}, hyper, "cpu", sync=sync)
    w = torch.as_tensor(np.random.RandomState(2).normal(
        scale=0.1, size=obj.w0.shape).astype(np.float32))
    with obj:
        feeder = obj.feeder
        f0, g0 = obj.value_and_grad(w)
        f1 = obj.value(w)
        reads = []
        good = feeder.read

        def flaky(i):
            reads.append(i)
            if i == 2 and reads.count(2) == 1:
                raise OSError("disk gone")
            return good(i)

        feeder.read = flaky
        with pytest.raises(OSError, match="disk gone"):
            obj.value(w)
        f2, g2 = obj.value_and_grad(w)
        assert obj.feeder is feeder
    assert torch.equal(f0, f1) and torch.equal(f0, f2)
    assert torch.equal(g0, g2)
    assert obj.stats["blocks_fed"] == 3 * ds.n_blocks + 2


def test_blocks_lacking_a_class_and_a_padded_tail():
    X, y = _clf(n=301, k=3, seed=4)
    order = np.argsort(y, kind="stable")  # each block holds one class
    X, y = X[order], y[order]
    ds = ChunkedDataset.from_arrays(X, y, block_rows=50)
    assert ds.n_rows % ds.block_rows
    ours = LogisticRegression(device="cpu", **KW).fit(ds)
    resident = LogisticRegression(device="cpu", engine="xla", **KW).fit(X, y)
    _hold(ours, resident, X)


def test_warm_start_and_explicit_labels(tmp_path):
    X, y = _clf(k=2, seed=2)
    ChunkedDataset.from_arrays(X, block_rows=100).save(str(tmp_path))
    ds = ChunkedDataset.load(str(tmp_path))  # carries no labels
    with pytest.raises(ValueError, match="needs labels"):
        LogisticRegression(device="cpu").fit(ds)
    cold = LogisticRegression(device="cpu", **KW).fit(ds, y)
    warm = LogisticRegression(device="cpu", **KW).fit(
        ds, y, coef_init=cold.coef_, intercept_init=cold.intercept_)
    assert int(warm.n_iter_) < int(cold.n_iter_) // 4
    _hold(warm, cold, X, atol=1e-5)
    with pytest.raises(ValueError, match="labels"):
        LogisticRegression(device="cpu").fit(ds, y[:-1])


@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("method", ["predict_proba", "predict"])
def test_chunked_predict_is_the_resident_blocked_predict(tmp_path, kind,
                                                         method):
    X, y = _clf(n=333, k=3, sparse=kind == "packed")
    model = LogisticRegression(device="cpu", engine="xla",
                               max_iter=30).fit(X, y)
    ChunkedDataset.from_arrays(X, block_rows=64, pack=kind == "packed"
                               or None).save(str(tmp_path))
    ds = ChunkedDataset.load(str(tmp_path))
    backend = LocalBackend(device="cpu")
    out = batch_predict(model, ds, method, backend=backend)
    want = batch_predict(model, X, method, backend=backend, batch_size=64)
    np.testing.assert_array_equal(out, want)
    assert backend.last_round_stats["blocks_fed"] == ds.n_blocks
    # the estimator's own methods route a dataset there
    np.testing.assert_array_equal(getattr(model, method)(ds), want)
    with pytest.raises(TypeError, match="batch_predict"):
        model.decision_function(ds)


def test_chunked_predict_of_a_host_model():
    X, y = _clf(n=150, k=3)
    forest = RandomForestClassifier(n_estimators=3, max_depth=3,
                                    device="cpu").fit(X, y)
    ds = ChunkedDataset.from_arrays(X, block_rows=40)
    np.testing.assert_array_equal(
        batch_predict(forest, ds, "predict_proba",
                      backend=LocalBackend(device="cpu")),
        forest.predict_proba(X))
    Xs = sp.csr_matrix(X * (X > 0.5))  # packed blocks go as CSR to it
    dsp = ChunkedDataset.from_arrays(Xs, block_rows=40, pack=True)
    np.testing.assert_array_equal(
        batch_predict(forest, dsp, "predict",
                      backend=LocalBackend(device="cpu")),
        forest.predict(Xs.toarray()))


def test_encoder_pass_through_matches_jax():
    import pandas as pd

    rng = np.random.RandomState(3)
    cols = {"a": rng.normal(size=90), "b": rng.randint(0, 4, 90) * 1.0,
            "c": np.where(rng.rand(90) < 0.2, np.nan, rng.normal(size=90))}
    ref = JaxEncoderizer(size="small").fit(pd.DataFrame(cols))
    enc = Encoderizer(size="small").fit(cols)
    raw = np.column_stack(list(cols.values()))
    jds = jdata.ChunkedDataset.from_arrays(raw, np.arange(90) % 2,
                                           block_rows=32)
    ds = ChunkedDataset.from_arrays(raw, np.arange(90) % 2, block_rows=32)
    want, out = ref.transform(jds), enc.transform(ds)
    assert out.shape == want.shape and out.has_y
    for i in range(out.n_blocks):
        a, b = want.read_block(i), out.read_block(i)
        np.testing.assert_array_equal(np.asarray(a.X), b.X)
        np.testing.assert_array_equal(a.y, b.y)


def test_refusals():
    X, y = _clf(n=120, k=3)
    ds = ChunkedDataset.from_arrays(X, y, block_rows=50)
    with pytest.raises(ValueError, match="engine='host'"):
        LogisticRegression(engine="host", device="cpu").fit(ds)
    with pytest.raises(ValueError, match="balanced"):
        LinearSVC(class_weight="balanced", device="cpu").fit(ds)
    with pytest.raises(TypeError, match="requires y"):
        LogisticRegression(device="cpu").fit(X)
    # the SGD and ridge kinds, the search and one-vs-rest stream too now
    # (their own refusals: tests/test_torch_streaming_linear.py and
    # tests/test_torch_streamed_search.py); boosting stays item 9c's
    for est in (SGDClassifier(batch_size=50, device="cpu"),
                RidgeClassifier(device="cpu")):
        assert est.fit(ds).stream_stats_["blocks_fed"] >= ds.n_blocks
    with pytest.raises(NotImplementedError, match="item 9c"):
        tg.DistHistGradientBoostingClassifier(device="cpu").fit(ds)
    gs = DistGridSearchCV(LogisticRegression(device="cpu", max_iter=5),
                          {"C": [1.0]}, cv=3).fit(ds, y)
    assert gs.round_stats_[0]["mode"] == "streamed"
    ovr = DistOneVsRestClassifier(LogisticRegression(device="cpu",
                                                     max_iter=5)).fit(ds, y)
    assert len(ovr.estimators_) == 3
    # a dict class_weight is not refused: it weighs each block's rows
    cw = {0: 2.0, 1: 1.0, 2: 0.5}
    ours = LogisticRegression(class_weight=cw, device="cpu", **KW).fit(ds)
    resident = LogisticRegression(class_weight=cw, device="cpu",
                                  engine="xla", **KW).fit(X, y)
    _hold(ours, resident, X)
