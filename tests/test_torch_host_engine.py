"""The port's f64 host engine (skdist_tpu_torch.models.host_linear) and
its warm C path against the JAX package's, on the same numpy inputs made
from a seed, on the CPU.

Both packages run the same numpy/scipy code on the same float32 inputs,
so the host fits agree to float64 rounding: ``coef_`` within 1e-6 (the
largest gap seen in these cases is 0.0) and ``predict`` equal. The
searches' ``cv_results_`` scores agree within 1e-5. Also: which engine
``engine='auto'`` resolves to (the host engine only where the device is
the CPU, never for ``device="cuda"``, checked without a card), the host
fan-out of an explicit ``engine='host'`` under ``CUDABackend``, the
one-vs-rest gate, pickles without the warm-start scratch, and exact
launch counters under threads.
"""

import pickle
import threading

import numpy as np
import pytest
import scipy.sparse as sp

from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LinearSVC as JaxSVC
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.parallel import LocalBackend as JaxLocal
from skdist_tpu_torch.distribute import search as search_mod
from skdist_tpu_torch.distribute.multiclass import DistOneVsRestClassifier
from skdist_tpu_torch.distribute.search import DistGridSearchCV
from skdist_tpu_torch.models import LinearSVC, LogisticRegression
from skdist_tpu_torch.models import host_linear
from skdist_tpu_torch.ops import _build
from skdist_tpu_torch.parallel import CUDABackend, LocalBackend
from skdist_tpu_torch.parallel import prefers_host_engine

COEF_ATOL = 1e-6
SCORE_ATOL = 1e-5


def _data(k, seed=0, n=150, d=8):
    rng = np.random.RandomState(seed + k)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(d, k) + 0.7 * rng.randn(n, k), axis=1)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, sw


CASES = [
    # (family, classes, class_weight, sample_weight)
    ("lr", 2, None, False),
    ("lr", 3, None, True),
    ("lr", 3, "balanced", False),
    ("lr", 3, {0: 2.0, 1: 0.5, 2: 1.0}, True),
    ("lr", 2, {0: 3.0, 1: 1.0}, False),
    ("svc", 2, None, True),
    ("svc", 4, "balanced", False),
    ("svc", 3, {0: 2.0, 1: 0.5, 2: 1.0}, False),
]


def _pair(family, **kw):
    if family == "lr":
        return JaxLR(**kw), LogisticRegression(device="cpu", **kw)
    return JaxSVC(C=0.1, **kw), LinearSVC(C=0.1, device="cpu", **kw)


@pytest.mark.parametrize("family,k,cw,use_sw", CASES)
def test_host_engine_matches_jax(family, k, cw, use_sw):
    """``engine='host'`` in both packages: the same fit."""
    X, y, sw = _data(k)
    fit_kw = {"sample_weight": sw} if use_sw else {}
    jm, tm = _pair(family, engine="host", class_weight=cw)
    jm.fit(X, y, **fit_kw)
    tm.fit(X, y, **fit_kw)
    assert hasattr(tm, "_w_opt64")  # the host engine ran
    assert tm.coef_.shape == jm.coef_.shape
    np.testing.assert_allclose(tm.coef_, jm.coef_, rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(tm.intercept_, jm.intercept_, rtol=0,
                               atol=COEF_ATOL)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    assert int(tm.n_iter_) == int(jm.n_iter_)


@pytest.mark.parametrize("family", ["lr", "svc"])
def test_cpu_default_is_the_host_engine(family):
    """``engine='auto'`` with ``device="cpu"`` is the JAX package's CPU
    default, the host engine: the fits agree as pinned fits do."""
    X, y, _ = _data(3, seed=2)
    jm, tm = _pair(family)
    jm.fit(X, y)
    tm.fit(X, y)
    assert tm._resolve_host_engine()
    np.testing.assert_allclose(tm.coef_, jm.coef_, rtol=0, atol=COEF_ATOL)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))


def test_auto_resolution_never_picks_the_host_engine_on_the_card():
    """``auto`` resolves to the host engine only for ``device="cpu"``:
    never for ``None`` or ``"cuda"`` (the card), nor under bf16; a pin
    wins. Resolution touches no card (none is here)."""
    for cls in (LogisticRegression, LinearSVC):
        assert not cls()._resolve_host_engine()
        assert not cls(device="cuda")._resolve_host_engine()
        assert not cls(device="cuda:0")._resolve_host_engine()
        assert cls(device="cpu")._resolve_host_engine()
        assert cls(engine="host")._resolve_host_engine()
        assert not cls(engine="xla", device="cpu")._resolve_host_engine()
    assert not LogisticRegression(
        device="cpu", matmul_dtype="bfloat16")._resolve_host_engine()
    # a device backend on the card (none here: a stand-in with its flag)
    card = type("CardBackend", (), {"is_device_backend": True})()
    for backend in (card, CUDABackend(device="cpu")):
        # a device backend: auto is batched whatever the device
        assert not prefers_host_engine(backend, LogisticRegression())
        assert not prefers_host_engine(
            backend, LogisticRegression(device="cpu"))
        assert prefers_host_engine(backend, LogisticRegression(engine="host"))
    assert not prefers_host_engine(LocalBackend(device="cpu"),
                                   LogisticRegression(device="cuda"))
    assert prefers_host_engine(LocalBackend(device="cpu"),
                               LogisticRegression(device="cpu"))


def test_explicit_host_pin_under_cuda_backend_takes_the_host_fanout(
        monkeypatch):
    """An explicit ``engine='host'`` under ``CUDABackend`` runs every fit,
    the selection and the refit, on the host engine (through the warm C
    path's host threads), never the batched path."""
    X, y, _ = _data(3, seed=3)
    calls = []
    real = host_linear.logreg_host_fit

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def boom(*a, **k):
        raise AssertionError("the batched path must not run")

    monkeypatch.setattr(host_linear, "logreg_host_fit", spy)
    monkeypatch.setattr(search_mod.DistBaseSearchCV, "_run_batched", boom)
    gs = DistGridSearchCV(
        LogisticRegression(max_iter=30, engine="host", device="cpu"),
        {"C": [0.1, 1.0]}, cv=3, scoring="accuracy",
        backend=CUDABackend(device="cpu"),
    ).fit(X, y)
    assert len(calls) == 2 * 3 + 1
    stats = gs.round_stats_[0]
    assert stats["mode"] == "host_warm"
    assert stats["host_fits"] == stats["tasks"] == 6
    assert stats["warm_seeded"] == 3
    assert hasattr(gs.best_estimator_, "_w_opt64")


def test_auto_search_on_a_device_backend_stays_batched():
    X, y, _ = _data(3, seed=3)
    gs = DistGridSearchCV(
        LogisticRegression(max_iter=30, device="cpu"), {"C": [0.1, 1.0]},
        cv=3, scoring="accuracy", backend=CUDABackend(device="cpu"),
    ).fit(X, y)
    assert gs.round_stats_[0]["mode"] != "host_warm"


@pytest.mark.parametrize("family", ["lr", "svc"])
def test_warm_c_path_matches_jax(family):
    """The warm C path (``engine='host'``) against the JAX package's:
    ``cv_results_`` within 1e-5, the same best params; the chains are
    seeded (3 of 4 fits a fold)."""
    X, y, _ = _data(3, seed=5, n=180)
    grid = {"C": [1.0, 0.01, 10.0, 0.1]}
    kw = dict(engine="host", max_iter=200)
    jm, tm = _pair(family, **kw)
    js = JaxGrid(jm, grid, cv=4, scoring="accuracy",
                 backend=JaxLocal()).fit(X, y)
    ts = DistGridSearchCV(tm, grid, cv=4, scoring="accuracy",
                          backend=LocalBackend(device="cpu")).fit(X, y)
    for key in [f"split{i}_test_score" for i in range(4)] + [
            "mean_test_score"]:
        np.testing.assert_allclose(ts.cv_results_[key], js.cv_results_[key],
                                   rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(ts.cv_results_["rank_test_score"],
                                  js.cv_results_["rank_test_score"])
    assert ts.best_params_ == js.best_params_
    stats = ts.round_stats_[0]
    assert stats["warm_seeded"] == 3 * 4
    np.testing.assert_allclose(ts.best_estimator_.coef_,
                               js.best_estimator_.coef_, rtol=0,
                               atol=COEF_ATOL)


def test_cpu_default_search_matches_jax_default():
    """The CPU default of both packages (``engine='auto'``; the JAX
    package's search default is its host ``LocalBackend``, the port's
    counterpart ``LocalBackend(device="cpu")``): both take the warm C
    path, scores within 1e-5. This closes the "CPU default runs a
    different engine" divergence."""
    X, y, _ = _data(3, seed=6, n=180)
    grid = {"C": list(np.logspace(-2, 2, 5))}
    js = JaxGrid(JaxLR(max_iter=100), grid, cv=3, scoring="accuracy").fit(
        X, y)
    ts = DistGridSearchCV(LogisticRegression(max_iter=100, device="cpu"),
                          grid, cv=3, scoring="accuracy",
                          backend=LocalBackend(device="cpu")).fit(X, y)
    assert ts.round_stats_[0]["mode"] == "host_warm"
    np.testing.assert_allclose(ts.cv_results_["mean_test_score"],
                               js.cv_results_["mean_test_score"], rtol=0,
                               atol=SCORE_ATOL)
    assert ts.best_params_ == js.best_params_


def test_warm_c_path_capped_candidates_match_jax():
    """Fits that stop on ``max_iter`` (``max_iter=3``): the chains restart
    cold after them, and a warm-seeded capped fit is refit cold before
    its score is recorded, in both packages; the scores agree and equal
    the candidates' solo (cold) runs."""
    X, y, _ = _data(3, seed=7, n=180)
    grid = {"C": [0.01, 0.1, 1.0, 10.0]}
    kw = dict(engine="host", max_iter=3, tol=1e-8)
    js = JaxGrid(JaxLR(**kw), grid, cv=3, scoring="accuracy",
                 backend=JaxLocal()).fit(X, y)
    ts = DistGridSearchCV(LogisticRegression(device="cpu", **kw), grid, cv=3,
                          scoring="accuracy",
                          backend=LocalBackend(device="cpu")).fit(X, y)
    np.testing.assert_allclose(ts.cv_results_["mean_test_score"],
                               js.cv_results_["mean_test_score"], rtol=0,
                               atol=SCORE_ATOL)
    stats = ts.round_stats_[0]
    # every fit is capped: no chain is ever seeded
    assert stats["warm_seeded"] == 0 and stats["cold_refits"] == 0
    for i, c in enumerate(grid["C"]):
        solo = DistGridSearchCV(LogisticRegression(device="cpu", **kw),
                                {"C": [c]}, cv=3, scoring="accuracy",
                                refit=False,
                                backend=LocalBackend(device="cpu")).fit(X, y)
        np.testing.assert_array_equal(
            [ts.cv_results_[f"split{s}_test_score"][i] for s in range(3)],
            [solo.cv_results_[f"split{s}_test_score"][0] for s in range(3)])


def test_warm_seeded_capped_fit_is_refit_cold():
    """A warm-seeded fit that stops on the cap is refit cold, and the
    recorded score is the cold one (the cap made deterministic by a
    subclass whose warm fits report no optimum, as the engine does for a
    ``max_iter`` stop)."""
    X, y, _ = _data(3, seed=8, n=150)
    log = []

    class CapsWhenWarm(LogisticRegression):
        def fit(self, X, y=None, sample_weight=None):
            warm = getattr(self, "_warm_w0", None) is not None
            log.append((float(self.C), warm))
            super().fit(X, y, sample_weight=sample_weight)
            if warm:
                self._w_opt64 = None
            return self

    est = CapsWhenWarm(max_iter=50, engine="host", device="cpu")
    full = DistGridSearchCV(est, {"C": [1e-2, 1.0]}, cv=3,
                            scoring="accuracy", refit=False,
                            backend=LocalBackend(device="cpu")).fit(X, y)
    assert log == [(1e-2, False), (1.0, True), (1.0, False)] * 3
    assert full.round_stats_[0]["cold_refits"] == 3
    solo = DistGridSearchCV(est, {"C": [1.0]}, cv=3, scoring="accuracy",
                            refit=False,
                            backend=LocalBackend(device="cpu")).fit(X, y)
    np.testing.assert_array_equal(
        [full.cv_results_[f"split{s}_test_score"][1] for s in range(3)],
        [solo.cv_results_[f"split{s}_test_score"][0] for s in range(3)])


def test_engine_grid_takes_the_generic_path(monkeypatch):
    """A searched ``engine`` is honoured per candidate: the generic path."""
    X, y, _ = _data(3, seed=9)

    def boom(*a, **k):
        raise AssertionError("the batched path must not run")

    monkeypatch.setattr(search_mod.DistBaseSearchCV, "_run_batched", boom)
    gs = DistGridSearchCV(
        LogisticRegression(max_iter=20, device="cpu"),
        {"C": [0.1, 1.0], "engine": ["host", "xla"]}, cv=3,
        scoring="accuracy", backend=CUDABackend(device="cpu")).fit(X, y)
    assert gs.round_stats_[0]["mode"] == "generic"
    assert {p["engine"] for p in gs.cv_results_["params"]} == {"host", "xla"}


def test_sparse_input_under_auto_stays_batched_and_host_pin_densifies():
    """Packed X has no host form: ``auto`` keeps it on the torch engine
    (the fit is packed), ``engine='host'`` densifies and fits on the
    host, as the JAX package does."""
    rng = np.random.RandomState(0)
    n, d = 120, 400
    rows = np.repeat(np.arange(n), 6)
    X = sp.csr_matrix(((rng.rand(n * 6) + 0.5).astype(np.float32),
                       (rows, rng.randint(0, d, n * 6))), shape=(n, d))
    y = rng.randint(0, 2, n)
    auto = LogisticRegression(device="cpu", max_iter=20).fit(X, y)
    assert auto._meta["x_format"] == "packed"
    assert not hasattr(auto, "_w_opt64")
    local = LocalBackend(device="cpu")
    assert not prefers_host_engine(local, LogisticRegression(device="cpu"),
                                   X)
    assert prefers_host_engine(local, LogisticRegression(device="cpu"),
                               X.toarray())
    assert prefers_host_engine(
        local, LogisticRegression(device="cpu", engine="host"), X)
    host = LogisticRegression(device="cpu", engine="host").fit(X, y)
    ref = JaxLR(engine="host").fit(X, y)
    assert host._meta["x_format"] == "dense"
    np.testing.assert_allclose(host.coef_, ref.coef_, rtol=0, atol=COEF_ATOL)


def test_one_vs_rest_routes_the_host_engine_to_the_generic_path():
    """One estimator never runs two engines depending on its wrapper:
    under a host backend, ``auto`` on the CPU fits each class through
    the host engine (the generic path); on a device backend it batches;
    an explicit ``engine='host'`` pin takes the host path anywhere."""
    X, y, _ = _data(3, seed=10)
    svc = dict(C=0.1, tol=1e-2, max_iter=100, device="cpu")
    host = DistOneVsRestClassifier(
        LinearSVC(**svc),
        backend=LocalBackend(device="cpu")).fit(X, y)
    assert all(hasattr(e, "_w_opt64") for e in host.estimators_)
    assert not hasattr(host, "round_stats_") or not host.round_stats_
    batched = DistOneVsRestClassifier(
        LinearSVC(**svc),
        backend=CUDABackend(device="cpu")).fit(X, y)
    assert batched.round_stats_
    pinned = DistOneVsRestClassifier(
        LinearSVC(engine="host", **svc),
        backend=CUDABackend(device="cpu")).fit(X, y)
    assert all(hasattr(e, "_w_opt64") for e in pinned.estimators_)
    np.testing.assert_array_equal(pinned.predict(X), host.predict(X))


def test_pickle_drops_the_warm_start_scratch():
    X, y, _ = _data(3, seed=11)
    gs = DistGridSearchCV(
        LogisticRegression(engine="host", device="cpu"), {"C": [0.1, 1.0]},
        cv=3, backend=LocalBackend(device="cpu")).fit(X, y)
    assert hasattr(gs.best_estimator_, "_w_opt64")
    loaded = pickle.loads(pickle.dumps(gs))
    assert not hasattr(loaded.best_estimator_, "_w_opt64")
    np.testing.assert_array_equal(loaded.predict(X), gs.predict(X))
    np.testing.assert_array_equal(loaded.predict_proba(X),
                                  gs.predict_proba(X))


def test_launch_counters_are_exact_under_threads():
    """``count_launch`` adds one a call under a lock: eight threads of
    2000 calls each count 16000."""

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            _build.count_launch(wrapper)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 16000
