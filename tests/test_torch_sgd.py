"""The port's mini-batch SGD on the CPU, against the JAX package's
``SGDClassifier`` and ``DistRandomizedSearchCV`` on the same seeded numpy
inputs, and against scikit-learn's SGD for quality.

The port draws each epoch's row order from its counter hash
(``utils/draws.py epoch_permutation``), the JAX package from
``jax.random.permutation``. Where a test holds the port to the JAX
package with ``shuffle=True`` it injects the JAX stream into that one
function (``jax_orders``), so the whole algorithm is held, not only its
``shuffle=False`` form.

Tolerance: ``n_iter_`` equal, and ``coef_``/``intercept_`` within 1e-5
of ``max|coef_|``: both packages run the same float32 updates in the
same order, and differ only by the summation order of their products
and batch sums (about 1e-7 of max|coef_| over these fits). Search scores
are held to 1e-5 (tests/test_torch_search.py's standing tolerance) and
converted models' decisions to 1e-6.

Bitwise contracts of the port alone: an epoch-sliced solve is the
unsliced one (slice sizes 1, 3 and past ``max_iter``), a lane restarted
in place runs as a fresh lane, and compacted, classic, refilled and
``eta=inf`` searches give the same ``cv_results_`` at equal round size.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from bench import make_tabular
from skdist_tpu.distribute.adaptive import HalvingSpec as JaxHalving
from skdist_tpu.distribute.search import (
    DistRandomizedSearchCV as JaxRandomized,
)
from skdist_tpu.models import SGDClassifier as JaxSGD
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend, HalvingSpec
from skdist_tpu_torch.convert import sgd_from_reference
from skdist_tpu_torch.distribute.adaptive import RungKilledWarning
from skdist_tpu_torch.distribute.search import DistRandomizedSearchCV
from skdist_tpu_torch.models import SGDClassifier
from skdist_tpu_torch.models.linear import _freeze, to_device_X
from skdist_tpu_torch.parallel import backend as backend_mod
from skdist_tpu_torch.utils import draws


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small steps: the
    tier-1 run shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_orders(monkeypatch):
    """Inject the JAX package's epoch orders into the port: ``use(max_iter)``
    makes ``epoch_permutation`` return ``jax.random.permutation`` of the
    epoch's key (the keys split ``max_iter`` ways from the seed, as in
    ``skdist_tpu/models/solvers.py``), modulo the row count."""

    def use(max_iter):
        def orders(seed, epoch, padded, n, device=None):
            keys = jax.random.split(jax.random.PRNGKey(seed), max_iter)
            perm = np.array(jax.random.permutation(keys[epoch], padded) % n)
            return torch.as_tensor(perm, dtype=torch.int64, device=device)

        monkeypatch.setattr(draws, "epoch_permutation", orders)

    return use


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n, d, k = 300, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, k)) + 0.5 * rng.normal(size=(n, k))).argmax(1)
    return X, y


def _assert_fit_close(port, ref):
    assert int(port.n_iter_) == int(ref.n_iter_)
    scale = np.abs(ref.coef_).max()
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(port.intercept_, ref.intercept_, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(port.classes_, ref.classes_)


# --------------------------------------------------------------------------
# the estimator against the JAX package's
# --------------------------------------------------------------------------

#: (constructor arguments, binary) with max_iter <= 5 unless tol stops it
FITS = [
    (dict(shuffle=False), False),
    (dict(shuffle=False), True),
    (dict(), False),
    (dict(loss="log_loss"), False),
    (dict(loss="log_loss"), True),
    (dict(loss="squared_hinge", learning_rate="constant", eta0=0.01), False),
    (dict(penalty="elasticnet", l1_ratio=0.3, learning_rate="invscaling",
          eta0=0.1), False),
    (dict(penalty="l1", alpha=0.1), True),
    (dict(penalty=None, class_weight="balanced"), False),
    (dict(class_weight={0: 2.0, 2: 0.5}, fit_intercept=False), False),
    (dict(tol=None), True),
    (dict(max_iter=40, tol=1e-2, n_iter_no_change=2), False),
]


@pytest.mark.parametrize("kwargs,binary", FITS)
def test_fit_matches_jax_package(data, jax_orders, kwargs, binary):
    X, y = data
    if binary:
        y = (y == 1).astype(np.int64)
    kw = dict(max_iter=5, batch_size=16, tol=1e-3)
    kw.update(kwargs)
    jax_orders(kw["max_iter"])
    port = SGDClassifier(device="cpu", **kw).fit(X, y)
    ref = JaxSGD(**kw).fit(X, y)
    _assert_fit_close(port, ref)
    if kw["max_iter"] > 5:  # the early-stopping case stops early
        assert int(port.n_iter_) < kw["max_iter"]
    if kw.get("penalty") == "l1":  # truncation reaches exact zeros
        assert (port.coef_ == 0).any()
        np.testing.assert_array_equal(port.coef_ == 0, ref.coef_ == 0)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_sample_weight_matches_jax_package(data, jax_orders):
    X, y = data
    sw = np.random.RandomState(3).rand(len(y)).astype(np.float32)
    sw[:40] = 0.0  # zero-weight rows keep their batch slots
    jax_orders(4)
    kw = dict(max_iter=4, batch_size=32)
    port = SGDClassifier(device="cpu", **kw).fit(X, y, sample_weight=sw)
    ref = JaxSGD(**kw).fit(X, y, sample_weight=sw)
    _assert_fit_close(port, ref)


def test_predict_proba_matches_jax_package(data):
    X, y = data
    kw = dict(loss="log_loss", max_iter=3, shuffle=False)
    port = SGDClassifier(device="cpu", **kw).fit(X, y)
    ref = JaxSGD(**kw).fit(X, y)
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X),
                               rtol=0, atol=1e-5)
    with pytest.raises(AttributeError, match="log_loss"):
        SGDClassifier(device="cpu", max_iter=2).fit(X, y).predict_proba(X)


def test_rejects_what_the_jax_package_rejects(data):
    X, y = data
    with pytest.raises(ValueError, match="n_iter_no_change"):
        SGDClassifier(device="cpu", n_iter_no_change=0).fit(X, y)
    with pytest.raises(ValueError, match="loss"):
        SGDClassifier(device="cpu", loss="perceptron").fit(X, y)


def test_packed_x_is_not_ported():
    """Packed sparse X is ported now: the fit takes the packed plane (the
    row forms of K1 and K2) and agrees with the same fit on the dense
    matrix, which draws the same row orders (tests/test_torch_sgd_packed.py
    holds it to the JAX package)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    X = sp.random(200, 4096, density=0.002, format="csr", random_state=rng,
                  dtype=np.float32)
    y = rng.randint(0, 2, 200)
    packed = SGDClassifier(device="cpu", max_iter=2).fit(X, y)
    dense = SGDClassifier(device="cpu", max_iter=2).fit(X.toarray(), y)
    assert packed._meta["x_format"] == "packed"
    assert int(packed.n_iter_) == int(dense.n_iter_)
    scale = np.abs(dense.coef_).max()
    np.testing.assert_allclose(packed.coef_, dense.coef_, rtol=0,
                               atol=1e-5 * scale)


# --------------------------------------------------------------------------
# the solver: slices and restarts, bitwise
# --------------------------------------------------------------------------

def _lanes(X, y, max_iter, alphas, tol=1e-3):
    """A round of ``len(alphas)`` lanes (lane t on fold mask t % 3)."""
    est = SGDClassifier(max_iter=max_iter, batch_size=16, random_state=3)
    data_, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    op = SGDClassifier._linear_op(to_device_X(X, "cpu"), static)
    T, n = len(alphas), X.shape[0]
    sw = (torch.arange(n)[None] % 3 != torch.arange(T)[:, None] % 3).float()
    hyper = {"alpha": torch.tensor(alphas, dtype=torch.float32),
             "eta0": torch.full((T,), 0.01), "l1_ratio": torch.full((T,), 0.15),
             "tol": torch.full((T,), tol)}
    return meta, static, (op, torch.as_tensor(data_["y"]), sw, hyper)


def _run_sliced(ks, args, n_slices):
    carry = ks["init"](*args)
    for _ in range(n_slices):
        carry = ks["step"](*args, carry)
    return ks["finalize"](*args, carry)


@pytest.mark.parametrize("n_slice", [1, 3, 9])
def test_sliced_solve_is_the_unsliced_one(data, n_slice):
    X, y = data
    alphas = list(np.logspace(-5, -1, 6))
    meta, static, args = _lanes(X, y, 7, alphas)
    whole = SGDClassifier._build_fit_kernel(meta, static)(*args)
    ks = SGDClassifier._build_fit_slice_kernels(meta, static, n_slice)
    sliced = _run_sliced(ks, args, -(-7 // n_slice))
    assert torch.equal(sliced["W"], whole["W"])
    assert torch.equal(sliced["n_iter"], whole["n_iter"])
    assert int(whole["n_iter"].min()) >= 1


def test_restart_is_a_fresh_start(data):
    X, y = data
    first = list(np.logspace(-5, -1, 6))
    meta, static, args = _lanes(X, y, 6, first)
    ks = SGDClassifier._build_fit_slice_kernels(meta, static, 2)
    carry = ks["step"](*args, ks["init"](*args))
    # slots 1 and 4 take new tasks two epochs into the others' solves:
    # from then on the round's lanes read different epochs' orders
    second = list(first)
    second[1], second[4] = 3e-4, 3e-2
    _, _, args2 = _lanes(X, y, 6, second)
    slots = torch.tensor([1, 4])
    carry = ks["restart"](*args2, carry, slots)
    for _ in range(3):
        carry = ks["step"](*args2, carry)
    mixed = ks["finalize"](*args2, carry)
    fresh = SGDClassifier._build_fit_kernel(meta, static)(*args2)
    kept = torch.tensor([0, 2, 3, 5])
    old = SGDClassifier._build_fit_kernel(meta, static)(*args)
    assert torch.equal(mixed["W"][slots], fresh["W"][slots])
    assert torch.equal(mixed["n_iter"][slots], fresh["n_iter"][slots])
    assert torch.equal(mixed["W"][kept], old["W"][kept])


def test_lane_bits_do_not_depend_on_slot(data):
    X, y = data
    alphas = list(np.logspace(-5, -1, 8))
    meta, static, args = _lanes(X, y, 3, alphas)
    kernel = SGDClassifier._build_fit_kernel(meta, static)
    op, yd, sw, hyper = args
    rev = torch.arange(len(alphas) - 1, -1, -1)
    w1 = kernel(op, yd, sw, hyper)["W"]
    w2 = kernel(op, yd, sw[rev], {k: v[rev] for k, v in hyper.items()})["W"]
    assert torch.equal(w1, w2[rev])


def test_epoch_orders_are_keyed_by_seed_and_epoch():
    a = draws.epoch_permutation(0, 3, 320, 300)
    assert torch.equal(a, draws.epoch_permutation(0, 3, 320, 300))
    assert not torch.equal(a, draws.epoch_permutation(0, 4, 320, 300))
    assert not torch.equal(a, draws.epoch_permutation(1, 3, 320, 300))
    # every row once, and the 20 padding slots wrap onto 20 rows
    counts = torch.bincount(a, minlength=300)
    assert int(counts.min()) == 1 and int((counts == 2).sum()) == 20


# --------------------------------------------------------------------------
# the search against the JAX package's, and its paths against each other
# --------------------------------------------------------------------------

ALPHAS = list(np.logspace(-6, -2, 12))
SEARCH = dict(n_iter=10, cv=3, scoring="accuracy", random_state=0)
SGD_KW = dict(max_iter=6, batch_size=16)


@pytest.fixture(scope="module")
def tabular():
    return make_tabular(400, 8, 4, seed=1)


def _port_search(X, y, compaction=True, **kw):
    os.environ["SKDIST_COMPACTION"] = "1" if compaction else "0"
    try:
        return DistRandomizedSearchCV(
            SGDClassifier(device="cpu", **SGD_KW), {"alpha": ALPHAS},
            backend=CUDABackend(device="cpu"), **{**SEARCH, **kw}).fit(X, y)
    finally:
        del os.environ["SKDIST_COMPACTION"]


def _differing(a, b):
    return [c for c in a.cv_results_ if c != "params" and "_time" not in c
            and not np.array_equal(np.asarray(a.cv_results_[c]),
                                   np.asarray(b.cv_results_[c]))]


def test_search_matches_jax_package(tabular, jax_orders):
    X, y = tabular
    jax_orders(SGD_KW["max_iter"])
    port = _port_search(X, y)
    ref = JaxRandomized(JaxSGD(**SGD_KW), {"alpha": ALPHAS},
                        backend=TPUBackend(), **SEARCH).fit(X, y)
    assert port.round_stats_[0]["mode"] == "compacted"
    assert [p["alpha"] for p in port.cv_results_["params"]] == \
        [p["alpha"] for p in ref.cv_results_["params"]]
    for key in ["mean_test_score"] + [f"split{i}_test_score"
                                      for i in range(3)]:
        np.testing.assert_allclose(port.cv_results_[key],
                                   ref.cv_results_[key], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.cv_results_["rank_test_score"],
                                  ref.cv_results_["rank_test_score"])
    assert port.best_params_ == ref.best_params_
    _assert_fit_close(port.best_estimator_, ref.best_estimator_)


def test_search_paths_are_bitwise_equal(tabular):
    X, y = tabular
    comp = _port_search(X, y)
    st = comp.round_stats_[0]
    # one round: the step loop's cost is its launches, not its lanes
    assert (st["mode"], st["chunk"], st["slices"]) == ("compacted", 30, 2)
    assert st["lanes_converged"] + st["lanes_max_iter"] == 30
    classic = _port_search(X, y, compaction=False)
    assert classic.round_stats_[0]["tasks_per_round"] == 30
    assert not _differing(comp, classic)
    assert np.array_equal(comp.best_estimator_.coef_,
                          classic.best_estimator_.coef_)
    inf = _port_search(X, y, adaptive=HalvingSpec(eta=float("inf")))
    assert len(inf.round_stats_[0]["rung_history"]) == 2
    assert not _differing(comp, inf)


def test_refill_regime_restarts_lanes(tabular, monkeypatch):
    X, y = tabular
    monkeypatch.setattr(backend_mod.CUDABackend, "round_cap",
                        lambda self, *a, **k: 12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refill = _port_search(X, y, partitions=3)
        classic = _port_search(X, y, compaction=False, partitions=3)
    st = refill.round_stats_[0]
    assert (st["regime"], st["chunk"]) == ("refill", 10)
    assert st["refills"] > 0 and st["refilled_lanes"] == 20
    assert not _differing(refill, classic)


def test_asha_kills_as_the_jax_package(tabular, jax_orders):
    X, y = tabular
    jax_orders(SGD_KW["max_iter"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RungKilledWarning)
        port = _port_search(X, y, adaptive=HalvingSpec(eta=3))
        ref = JaxRandomized(JaxSGD(**SGD_KW), {"alpha": ALPHAS},
                            backend=TPUBackend(), adaptive=JaxHalving(eta=3),
                            **SEARCH).fit(X, y)
    np.testing.assert_array_equal(port.cv_results_["rung_"],
                                  ref.cv_results_["rung_"])
    assert (port.cv_results_["rung_"] >= 0).any()
    alive = port.cv_results_["rung_"] < 0
    np.testing.assert_allclose(port.cv_results_["mean_test_score"][alive],
                               ref.cv_results_["mean_test_score"][alive],
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# convert, and quality against scikit-learn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [False, True])
def test_sgd_from_reference_decides_as_jax(data, binary):
    X, y = data
    if binary:
        y = (y == 2).astype(np.int64)
    ref = JaxSGD(loss="log_loss", max_iter=3).fit(X, y)
    port = sgd_from_reference(
        {k: np.asarray(v) for k, v in ref._params.items()}, ref._meta,
        device="cpu", loss="log_loss")
    np.testing.assert_allclose(port.decision_function(X),
                               np.asarray(ref.decision_function(X)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    assert int(port.n_iter_) == int(ref.n_iter_)


def test_sgd_quality_vs_sklearn_matched_epochs():
    """The JAX package's config-2 quality gate
    (tests/test_models_linear.py): at matched epoch counts, the port's
    mini-batch SGD is within 2 accuracy points of sklearn's
    sample-at-a-time SGD for hinge, log_loss and elasticnet."""
    from sklearn.linear_model import SGDClassifier as SkSGD

    rng = np.random.RandomState(0)
    n, d, k = 6000, 20, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, k))
         + 1.5 * rng.normal(size=(n, k))).argmax(1)
    Xtr, ytr, Xte, yte = X[:4500], y[:4500], X[4500:], y[4500:]
    for kwargs in (
        {"loss": "hinge"},
        {"loss": "log_loss"},
        {"loss": "hinge", "penalty": "elasticnet", "l1_ratio": 0.15},
    ):
        ours = SGDClassifier(alpha=1e-4, max_iter=15, tol=None,
                             random_state=0, device="cpu",
                             **kwargs).fit(Xtr, ytr)
        sk = SkSGD(alpha=1e-4, max_iter=15, tol=None, random_state=0,
                   **kwargs).fit(Xtr, ytr)
        acc_ours = (ours.predict(Xte) == yte).mean()
        acc_sk = (sk.predict(Xte) == yte).mean()
        assert acc_ours >= acc_sk - 0.02, (kwargs, acc_ours, acc_sk)
