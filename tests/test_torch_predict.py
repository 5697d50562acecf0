"""The port's batch prediction (skdist_tpu_torch.distribute.predict)
against the JAX package's (skdist_tpu.distribute.predict), on the same
numpy inputs made from a seed, on the CPU.

Each fitted JAX model is carried into the port (``convert``), so both
packages predict with the same weights or the same tree: labels must be
equal and probabilities agree within 1e-5 (the products are summed in
another order). The JAX side runs on ``LocalBackend()`` with
``engine="xla"`` pinned, and its tree on ``hist_mode="scatter"``.
Within the port, every path is held to the model's own method: sparse
rows (packed blocks through K1's plain version) to dense ones, row
blocks to one call, host chunks to the whole, forests bitwise. The
prediction function returns numpy where the JAX package returns
``pandas.Series`` (the port imports no pandas), so its rows are compared
as arrays. Also: ``exact_matmuls`` under threads, and the backend
resolution of the port.
"""

import pickle
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu.distribute import predict as jax_predict
from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.models import RidgeClassifier as JaxRC
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu.models import forest as jf
from skdist_tpu.models import tree as jt
from skdist_tpu.parallel import LocalBackend as JaxLocal
from skdist_tpu_torch import convert
from skdist_tpu_torch.distribute import predict as tp
from skdist_tpu_torch.models import LogisticRegression
from skdist_tpu_torch.models.forest import RandomForestClassifier
from skdist_tpu_torch.parallel import (
    CUDABackend,
    LocalBackend,
    TaskBackend,
    resolve_backend,
)
from skdist_tpu_torch.utils import device as device_mod
from skdist_tpu_torch.utils.meminfo import BUDGET_ENV

CPU = dict(backend=LocalBackend(device="cpu"))


def _data(k, seed=0, n=240, d=8):
    rng = np.random.RandomState(seed + k)
    X = rng.randn(n, d).astype(np.float32)
    X[rng.rand(n, d) < 0.5] = 0.0  # half zeros, so the CSR form is sparse
    y = np.argmax(X @ rng.randn(d, k) + 0.3 * rng.randn(n, k), axis=1)
    return X, y


def _linear_params(ref):
    return {k: np.asarray(v) for k, v in ref._params.items()}


def _model(name):
    """``(port model, JAX model, X, y)`` with the same fitted state."""
    if name == "tree":
        X, y = _data(3)
        ref = jt.DecisionTreeClassifier(max_depth=4, max_features=None,
                                        hist_mode="scatter").fit(X, y)
        return convert.tree_from_reference(ref, device="cpu"), ref, X, y
    k = 10 if name == "logreg10" else 2 if name == "logreg2" else 3
    X, y = _data(k)
    if name.startswith("logreg"):
        ref = JaxLR(engine="xla", max_iter=30).fit(X, y)
        port = convert.logistic_regression_from_reference(
            _linear_params(ref), ref._meta, device="cpu")
    elif name == "svc":
        ref = JaxSVC(engine="xla", C=0.1, max_iter=30).fit(X, y)
        port = convert.linear_svc_from_reference(
            _linear_params(ref), ref._meta, device="cpu")
    elif name == "sgd":
        ref = JaxSGD(loss="log_loss", max_iter=3).fit(X, y)
        port = convert.sgd_from_reference(
            _linear_params(ref), ref._meta, device="cpu", loss="log_loss")
    else:
        ref = JaxRC(alpha=0.5).fit(X, y)
        port = convert.ridge_from_reference(ref, device="cpu")
    return port, ref, X, y


MODELS = ["logreg2", "logreg10", "svc", "sgd", "ridge", "tree"]
HAS_PROBA = {"logreg2", "logreg10", "sgd"}


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in MODELS}


@pytest.mark.parametrize("form", ["dense", "csr"])
@pytest.mark.parametrize("name", MODELS)
def test_batch_predict_matches_jax(models, name, form):
    port, ref, X, y = models[name]
    Xin = sp.csr_matrix(X) if form == "csr" else X
    methods = ["predict"] + (["predict_proba"] if name in HAS_PROBA else [])
    for method in methods:
        ours = tp.batch_predict(port, Xin, method=method, batch_size=64,
                                **CPU)
        theirs = jax_predict.batch_predict(ref, Xin, method=method,
                                           backend=JaxLocal(), batch_size=64)
        if method == "predict":
            np.testing.assert_array_equal(ours, theirs)
            np.testing.assert_array_equal(ours, port.predict(X))
        else:
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
            np.testing.assert_allclose(ours, port.predict_proba(X), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-5)
    if name == "tree":  # no proba kernel: the host path, bitwise
        assert tp.device_predict_plan(port, "predict_proba") is None
        np.testing.assert_array_equal(
            tp.batch_predict(port, Xin, method="predict_proba", **CPU),
            port.predict_proba(X))


@pytest.mark.parametrize("method", ["predict", "predict_proba"])
def test_csr_blocks_equal_dense_blocks(models, method):
    """Packed row blocks (K1's plain version on the CPU) give the dense
    blocks' answer, also at other block sizes and with empty rows."""
    port, _ref, X, _y = models["logreg10"]
    X = X.copy()
    X[::7] = 0.0  # empty rows
    dense = tp.batch_predict(port, X, method=method, batch_size=50, **CPU)
    for batch_size in (50, 17, None):
        out = tp.batch_predict(port, sp.csr_matrix(X), method=method,
                               batch_size=batch_size, **CPU)
        if method == "predict":
            np.testing.assert_array_equal(out, dense)
        else:
            np.testing.assert_allclose(out, dense, rtol=0, atol=1e-6)
    zero = tp.batch_predict(port, sp.csr_matrix(X.shape, dtype=np.float32),
                            method=method, **CPU)
    assert zero.shape[0] == X.shape[0]


def test_sparse_budget_splits_before_packing(models, monkeypatch):
    """The budget check runs before any pack: no pack sees the whole
    matrix or more rows than the budget allows, and the answer is the
    unsplit one."""
    port, _ref, X, _y = models["logreg10"]
    Xs = sp.csr_matrix(X)
    expected = tp.batch_predict(port, Xs, method="predict_proba",
                                batch_size=64, **CPU)
    packed_rows = []
    real_pack = tp.pack_csr_rows

    def spy(M):
        packed_rows.append(M.shape[0])
        return real_pack(M)

    monkeypatch.setattr(tp, "pack_csr_rows", spy)
    m = int(np.diff(Xs.indptr).max())
    budget = Xs.shape[0] * m * 8 // 4
    monkeypatch.setenv(BUDGET_ENV, str(budget))
    out = tp.batch_predict(port, Xs, method="predict_proba", batch_size=64,
                           **CPU)
    assert packed_rows and max(packed_rows) < Xs.shape[0]
    assert all(r * m * 8 <= budget // 2 for r in packed_rows)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-6)


class _HostModel:
    """A duck-typed model: no plan, so the host path."""

    classes_ = np.array([0, 1])

    @staticmethod
    def _sum(X):
        X = X.toarray() if hasattr(X, "toarray") else X
        return np.asarray(X, np.float64).sum(axis=1)

    def predict(self, X):
        return (self._sum(X) > 0).astype(np.int64)

    def predict_proba(self, X):
        p = 1.0 / (1.0 + np.exp(-self._sum(X)))
        return np.stack([1 - p, p], axis=1)


@pytest.mark.parametrize("n_jobs", [None, 3])
def test_host_chunks_equal_whole(n_jobs):
    X, _y = _data(2, n=301)
    model = _HostModel()
    be = LocalBackend(n_jobs=n_jobs, device="cpu")
    for method in ("predict", "predict_proba"):
        out = tp.batch_predict(model, X, method=method, backend=be,
                               batch_size=50)
        np.testing.assert_array_equal(out, getattr(model, method)(X))
    # tall sparse rows over the budget reach a host model in row groups
    Xs = sp.csr_matrix(X)
    assert tp._sparse_row_groups(Xs, X.shape[0]) is None


def test_host_model_sparse_row_groups(monkeypatch):
    X, _y = _data(2, n=180)
    model = _HostModel()
    Xs = sp.csr_matrix(X)
    monkeypatch.setenv(BUDGET_ENV, str(4096))
    groups = tp._sparse_row_groups(Xs, Xs.shape[0])
    assert groups is not None and len(groups) > 1
    out = tp.batch_predict(model, Xs, method="predict_proba", **CPU)
    np.testing.assert_array_equal(out, model.predict_proba(X))


def test_forest_host_path_matches_jax():
    """A forest has no plan in either package: chunks of its own
    predict_proba, bitwise the whole in the port (any thread count) and
    the JAX forest's within 1e-6."""
    X, y = _data(3)
    ref = jf.RandomForestClassifier(
        n_estimators=6, max_depth=4, bootstrap=False, max_features=None,
        hist_mode="scatter", random_state=0).fit(X, y)
    forest = convert.forest_from_reference(ref, device="cpu")
    assert tp.device_predict_plan(forest, "predict_proba") is None
    whole = forest.predict_proba(X)
    for n_jobs in (1, 4):
        out = tp.batch_predict(forest, X, method="predict_proba",
                               backend=LocalBackend(n_jobs=n_jobs,
                                                    device="cpu"),
                               batch_size=50)
        np.testing.assert_array_equal(out, whole)
    theirs = jax_predict.batch_predict(ref, X, method="predict_proba",
                                       backend=JaxLocal(), batch_size=50)
    np.testing.assert_allclose(whole, theirs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tp.batch_predict(forest, X, method="predict", batch_size=100, **CPU),
        ref.predict(X))


def test_no_proba_and_bad_method_raise(models):
    svc = models["svc"][0]
    X = models["svc"][2]
    with pytest.raises(AttributeError):
        tp.batch_predict(svc, X, method="predict_proba", **CPU)
    with pytest.raises(ValueError):
        tp.get_prediction_udf(svc, method="predict_proba")
    with pytest.raises(ValueError):
        tp.get_prediction_udf(models["logreg2"][0], method="transform")
    with pytest.raises(NotImplementedError, match="item 12"):
        tp.device_predict_plan(models["logreg2"][0], "predict",
                               serve_dtype="bfloat16")


PLANNED_METHODS = ("predict", "decision_function", "predict_proba",
                   "predict_log_proba")


@pytest.mark.parametrize("form", ["dense", "csr"])
@pytest.mark.parametrize("name", MODELS)
def test_batch_predict_equals_every_method_of_the_model(models, name, form):
    """``batch_predict(model, X, method)`` is ``model.<method>(X)`` in row
    blocks, for every method the model has: a device plan serves
    ``predict``/``decision_function`` (the decision kernel) and
    ``predict_proba``/``predict_log_proba`` (the proba kernel, the log
    taken as the model takes it); the JAX package's ``batch_predict``
    returns the decision for ``predict_log_proba``, a fault the port
    does not copy (ROADMAP Queue 3)."""
    port, _ref, X, _y = models[name]
    Xin = sp.csr_matrix(X) if form == "csr" else X
    seen = 0
    for method in PLANNED_METHODS:
        if not hasattr(port, method):
            continue
        expected = np.asarray(getattr(port, method)(Xin))
        ours = tp.batch_predict(port, Xin, method=method, batch_size=64,
                                **CPU)
        assert ours.shape == expected.shape, method
        if method == "predict":
            np.testing.assert_array_equal(ours, expected)
        else:
            # row blocks against one call: float32 sums of another order
            np.testing.assert_allclose(ours, expected, rtol=1e-6, atol=1e-6,
                                       err_msg=method)
        seen += 1
    if name in HAS_PROBA:
        assert seen == 4
        log_plan = tp.device_predict_plan(port, "predict_log_proba")
        assert log_plan is not None
        assert tp.batch_predict(port, X, method="predict_log_proba",
                                **CPU).shape == (X.shape[0],
                                                 len(port.classes_))


def test_log_proba_of_a_hinge_sgd_raises_as_the_model_does(models):
    """A hinge-loss SGD classifier has no probabilities: no proba plan,
    and ``batch_predict`` raises what the model raises."""
    _port, ref, X, _y = models["sgd"]
    hinge = convert.sgd_from_reference(_linear_params(ref), ref._meta,
                                       device="cpu", loss="hinge")
    assert tp.device_predict_plan(hinge, "predict_log_proba") is None
    assert tp.device_predict_plan(hinge, "predict_proba") is None
    assert tp.device_predict_plan(hinge, "score") is None
    for method in ("predict_proba", "predict_log_proba"):
        with pytest.raises(AttributeError):
            tp.batch_predict(hinge, X, method=method, **CPU)
    np.testing.assert_allclose(
        tp.batch_predict(hinge, X, method="decision_function", **CPU),
        hinge.decision_function(X), rtol=0, atol=1e-6)


def test_default_batch_size_and_plan(models):
    port = models["logreg10"][0]
    plan = tp.device_predict_plan(port, "predict_proba")
    assert plan.n_features == 8 and plan.out_width == 10 and plan.packed
    be = CUDABackend(device="cpu")
    assert tp._default_batch_size(10 ** 6, be, plan) == 1 << 18
    assert tp._default_batch_size(100, be, plan) == 100
    assert tp.device_predict_plan(_HostModel(), "predict") is None


# --------------------------------------------------------------------------
# the prediction function
# --------------------------------------------------------------------------

def _cols(X):
    return [X[:, j] for j in range(X.shape[1])]


@pytest.mark.parametrize("layout", ["numpy", "pandas"])
def test_udf_layouts_match_jax(models, layout):
    port, ref, X, _y = models["logreg10"]
    names = [f"f{j}" for j in range(X.shape[1])] if layout == "pandas" \
        else None
    ours = tp.get_prediction_udf(port, feature_type=layout, names=names,
                                 **CPU)(*_cols(X))
    theirs = jax_predict.get_prediction_udf(
        ref, feature_type=layout, names=names, backend=JaxLocal())(
        *_cols(X))
    assert isinstance(ours, np.ndarray) and ours.ndim == 1
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    if layout == "pandas":
        with pytest.raises(ValueError, match="names"):
            tp.get_prediction_udf(port, feature_type="pandas")(*_cols(X))


class _TextModel:
    def predict(self, docs):
        return np.array([len(d) % 3 for d in docs])


def test_udf_text_layout():
    docs = np.array(["good day", "bad night", "good morning", "bad"] * 10)
    udf = tp.get_prediction_udf(_TextModel(), feature_type="text", **CPU)
    np.testing.assert_array_equal(udf(docs), _TextModel().predict(docs))
    with pytest.raises(ValueError):
        udf(docs, docs)


def test_udf_proba_rows_contract(models):
    """One float32 row an input row, columns in classes_ order (the
    argmax column maps to predict's label), the JAX package's rows."""
    port, ref, X, _y = models["logreg10"]
    rows = tp.get_prediction_udf(port, method="predict_proba",
                                 **CPU)(*_cols(X))
    assert rows.dtype == object and rows.shape == (len(X),)
    stacked = np.stack(rows)
    assert stacked.dtype == np.float32
    assert stacked.shape == (len(X), len(port.classes_))
    np.testing.assert_array_equal(
        port.classes_[np.argmax(stacked, axis=1)], port.predict(X))
    theirs = jax_predict.get_prediction_udf(
        ref, method="predict_proba", backend=JaxLocal())(*_cols(X))
    np.testing.assert_allclose(stacked, np.stack(theirs.values), rtol=0,
                               atol=1e-5)


def test_udf_tracks_refit_and_pickles_without_runtime():
    X, y = _data(3)
    model = LogisticRegression(max_iter=20, device="cpu").fit(X, y)
    udf = tp.get_prediction_udf(model, method="predict_proba")
    before = np.stack(udf(*_cols(X[:20])))
    assert udf._runtime is not None
    back = pickle.loads(pickle.dumps(udf))
    assert back._runtime is None
    np.testing.assert_array_equal(np.stack(back(*_cols(X[:20]))), before)
    model.fit(X, (y + 1) % 3)
    after = np.stack(udf(*_cols(X[:20])))
    np.testing.assert_allclose(after, model.predict_proba(X[:20]), rtol=0,
                               atol=1e-6)
    assert np.abs(after - before).max() > 1e-3


def test_udf_concurrent_callers_no_crosstalk(models):
    """Two threads sharing one model and one prediction function each get
    their own rows back."""
    port, _ref, X, _y = models["logreg10"]
    expected = port.predict_proba(X)
    udf = tp.get_prediction_udf(port, method="predict_proba",
                                batch_size=16, **CPU)
    errors = []

    def caller(offset):
        for n in (32, 48, 32, 48):
            lo = offset * 8
            out = tp.batch_predict(port, X[lo:lo + n],
                                   method="predict_proba", batch_size=16,
                                   **CPU)
            if not np.allclose(out, expected[lo:lo + n], atol=1e-6):
                errors.append(("batch", offset, n))
            rows = np.stack(udf(*_cols(X[lo:lo + n])))
            if not np.allclose(rows, expected[lo:lo + n], atol=1e-6):
                errors.append(("udf", offset, n))

    threads = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


# --------------------------------------------------------------------------
# exact_matmuls under threads; backend resolution
# --------------------------------------------------------------------------

def test_exact_matmuls_is_thread_safe():
    """Thread A enters, thread B enters, A leaves while B is inside: B
    must still see TF32 off, and the caller's setting (on) comes back
    only after the last one leaves."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = True
    a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with device_mod.exact_matmuls():
            seen["a"] = matmul.allow_tf32
            a_in.set()
            b_in.wait()
        seen["a_after"] = matmul.allow_tf32
        a_out.set()

    def thread_b():
        a_in.wait()
        with device_mod.exact_matmuls():
            b_in.set()
            a_out.wait()
            seen["b_after_a_left"] = matmul.allow_tf32
        b_done.set()

    try:
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert b_done.is_set()
        assert seen == {"a": False, "a_after": False,
                        "b_after_a_left": False}
        assert matmul.allow_tf32 is True
        assert device_mod._EXACT["holders"] == 0
    finally:
        matmul.allow_tf32 = prev


def test_resolve_backend():
    be = LocalBackend(n_jobs=2, device="cpu")
    assert resolve_backend(be) is be
    for bad in ("tpu", "jax", object(), ["cpu"]):
        with pytest.raises(ValueError, match="cuda"):
            resolve_backend(bad)
    assert be.run_tasks(lambda t: t * t, range(7)) == [t * t for t in
                                                       range(7)]
    assert CUDABackend(device="cpu").run_tasks(str, [1, 2]) == ["1", "2"]
    assert not be.is_device_backend and isinstance(be, TaskBackend)
    with pytest.raises(TypeError):
        pickle.dumps(be)
    if not torch.cuda.is_available():
        for name in (None, "local", "cuda", "devices"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_backend(name)


def test_forest_udf_rows(models):
    X, y = _data(3)
    forest = RandomForestClassifier(n_estimators=4, max_depth=3,
                                    device="cpu").fit(X, y)
    rows = tp.get_prediction_udf(forest, "predict_proba",
                                 backend=LocalBackend(n_jobs=2,
                                                      device="cpu"),
                                 batch_size=50)(*_cols(X))
    np.testing.assert_array_equal(np.stack(rows), forest.predict_proba(X))
