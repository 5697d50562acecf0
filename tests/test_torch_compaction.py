"""The port's convergence-compacted execution: the iteration-sliced
L-BFGS kernels, the slice loop of ``CUDABackend.batched_map_iterative``
in both its regimes, and the search's compacted path, on the CPU.

Contracts held here, mirroring tests/test_compaction.py:

- chained slices of the port's batched solver are bitwise the unsliced
  solve, for several slice sizes (1 and past ``max_iter`` included);
- a lane's ``w`` and ``it`` do not depend on its slot or on its
  neighbours at a fixed round size, and a lane restarted in place in a
  mid-solve round is bitwise a lane started fresh;
- compacted and classic ``cv_results_`` (and the refit) are bitwise
  equal at equal round size, with every round resident and with a pool
  of rounds refilled from the queue (forced by patching ``round_cap``);
- the port's compacted search matches the JAX package's compacted
  search (``JaxLR(engine="xla")`` on ``TPUBackend()`` over the conftest
  CPU mesh) to the standing tolerances of tests/test_torch_search.py:
  scores within 1e-5, identical ranks and ``best_params_``, on the well
  conditioned C range (C <= 1);
- the gates and switches (``MIN_ITER_TASKS``, ``SKDIST_COMPACTION``,
  ``SKDIST_SLICE_ITERS``) behave as the JAX package's, the cost
  permutation keeps row order, and an out-of-memory error in the slice
  loop downgrades to the classic path with a warning and the same
  results.
"""

import numpy as np
import pytest
import torch

from bench import make_20news_sparse
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.parallel import TPUBackend
from skdist_tpu.parallel import iterative_chunk_size as jax_chunk_size
from skdist_tpu.parallel import resolve_slice_iters as jax_slice_iters
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.distribute.search import DistGridSearchCV as TorchGrid
from skdist_tpu_torch.models import LogisticRegression as TorchLR
from skdist_tpu_torch.models import Ridge as TorchRidge
from skdist_tpu_torch.models.linear import prepare_fit_X, to_device_X
from skdist_tpu_torch.models.solvers import (
    lbfgs_carry_init,
    lbfgs_minimize,
    lbfgs_resume,
)
from skdist_tpu_torch.parallel import (
    MIN_ITER_TASKS,
    TaskBackend,
    iterative_chunk_size,
    iterative_fit_supported,
    resolve_slice_iters,
)
from skdist_tpu_torch.parallel import backend as backend_mod

#: 8 C x 3 folds = 24 tasks, the compaction floor; the well-conditioned
#: range of tests/test_torch_search.py
CS = list(np.logspace(-2, 0, 8))
EST = dict(tol=1e-2, max_iter=200)


@pytest.fixture(scope="module")
def data():
    return make_20news_sparse(seed=0, n=300, d=1024, nnz_row=20, k=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small solves: the
    tier-1 run shares the host's cores among its workers, and torch's
    default of a thread a core makes each small op wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nontime_cols(cv):
    return [c for c in cv if c != "params" and "_time" not in c]


def _assert_bitwise(a, b):
    for col in _nontime_cols(a.cv_results_):
        np.testing.assert_array_equal(np.asarray(a.cv_results_[col]),
                                      np.asarray(b.cv_results_[col]),
                                      err_msg=col)
    assert a.cv_results_["params"] == b.cv_results_["params"]


def _torch_grid(X, y, grid=None, refit=False, max_iter=EST["max_iter"],
                **kw):
    backend = kw.pop("backend", None) or CUDABackend(device="cpu")
    est = TorchLR(device="cpu", engine="xla", tol=EST["tol"],
                  max_iter=max_iter)
    return TorchGrid(est, grid or {"C": CS},
                     cv=3, scoring="f1_weighted", backend=backend,
                     refit=refit, **kw).fit(X, y)


# ---------------------------------------------------------------------------
# the solver: sliced equals unsliced, slot independence, restart
# ---------------------------------------------------------------------------

def _logreg_batch(seed, T=5):
    """``fun((T, 8)) -> (T,)``: T binary logistic problems on one X with
    a ridge strength a lane."""
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.normal(size=(48, 7)).astype(np.float32))
    X = torch.cat([X, torch.ones(48, 1)], 1)
    y = torch.as_tensor((rng.rand(48) > 0.5).astype(np.float32))
    reg = torch.as_tensor(np.logspace(-3, 0, T).astype(np.float32))

    def fun(w):
        z = w @ X.T
        return torch.sum(torch.logaddexp(z, torch.zeros_like(z)) - y * z,
                         dim=1) + reg * torch.sum(w * w, dim=1)

    return fun, torch.zeros((T, 8))


@pytest.mark.parametrize("n_slice", [1, 3, 7, 33, 50])
def test_lbfgs_sliced_bitwise(n_slice):
    """Chained resumes of ``n_slice`` iterations equal one unsliced solve
    bit for bit (slice 1 and slices past max_iter included)."""
    max_iter, tol = 33, 1e-5
    for seed in range(3):
        fun, w0 = _logreg_batch(seed)
        w_ref, it_ref = lbfgs_minimize(fun, w0, tol=tol, max_iter=max_iter)
        carry = lbfgs_carry_init(fun, w0, tol, max_iter=max_iter)
        for _ in range(200):
            if bool(carry["done"].all()):
                break
            carry = lbfgs_resume(fun, carry, n_slice, tol, max_iter=max_iter)
        assert bool(carry["done"].all())
        np.testing.assert_array_equal(w_ref.numpy(), carry["w"].numpy())
        np.testing.assert_array_equal(it_ref.numpy(), carry["it"].numpy())


def _lr_kernels(data, form, T, n_slice=5):
    """The port's sliced LogReg kernels over ``T`` lanes of the fixture
    problem (fold-free: every lane fits all rows with its own C)."""
    X, y = data
    if form == "dense":
        X = X.toarray()
    est = TorchLR(device="cpu", max_iter=40, tol=1e-4)
    Xp = prepare_fit_X(X, TorchLR)
    fit_data, meta = est._prep_fit_data(Xp, y)
    static = tuple(sorted(est._static_config(meta).items()))
    op = TorchLR._linear_op(to_device_X(fit_data["X"], "cpu"), static)
    ks = TorchLR._build_fit_slice_kernels(meta, static, n_slice)
    y_t = torch.as_tensor(fit_data["y"])
    sw = torch.as_tensor(fit_data["sw"])[None].expand(T, -1).contiguous()

    def args(Cs):
        hyper = {"C": torch.as_tensor(np.asarray(Cs, np.float32)),
                 "tol": torch.full((T,), 1e-4)}
        return op, y_t, sw, hyper

    return ks, args


def _solve(ks, args, Cs):
    a = args(Cs)
    carry = ks["init"](*a)
    while not bool(carry["done"].all()):
        carry = ks["step"](*a, carry)
    return carry


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_lane_bits_do_not_depend_on_slot(data, form):
    """At a fixed T, a lane's w and it are bitwise the same in slot 0 and
    in slot T-1, whatever its neighbours (other C values, or copies)."""
    T = 6
    ks, args = _lr_kernels(data, form, T)
    lane_C = 0.3
    others = [0.01, 0.05, 0.2, 1.0, 0.7]
    first = _solve(ks, args, [lane_C] + others)
    last = _solve(ks, args, others[::-1] + [lane_C])
    alone = _solve(ks, args, [lane_C] * T)
    for c in (last, alone):
        row = T - 1 if c is last else 3
        np.testing.assert_array_equal(first["w"][0].numpy(),
                                      c["w"][row].numpy())
        assert int(first["it"][0]) == int(c["it"][row])


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_restart_in_place_equals_fresh_start(data, form):
    """A lane restarted in the freed slot of a mid-solve round runs the
    same bits as the lane started with the round."""
    T = 5
    ks, args = _lr_kernels(data, form, T)
    Cs = [0.02, 0.1, 0.4, 0.8, 0.05]
    ref = _solve(ks, args, Cs)
    # a round of other lanes, two slices in; slot 2 then takes C=0.4
    other = [0.02, 0.1, 0.9, 0.8, 0.05]
    carry = ks["init"](*args(other))
    for _ in range(2):
        carry = ks["step"](*args(other), carry)
    a = args(Cs)
    carry = ks["restart"](*a, carry, torch.tensor([2]))
    assert int(carry["it"][2]) == 0 and int(carry["k"][2]) == 0
    assert float(carry["S"][2].abs().max()) == 0.0
    while not bool(carry["done"][2]):
        carry = ks["step"](*a, carry)
    np.testing.assert_array_equal(ref["w"][2].numpy(), carry["w"][2].numpy())
    assert int(ref["it"][2]) == int(carry["it"][2])


# ---------------------------------------------------------------------------
# the scheduler in the search: compacted against classic, both regimes
# ---------------------------------------------------------------------------

@pytest.fixture
def refill(monkeypatch):
    """Device memory that fits 8 lanes: the 24-task grid then runs in
    the refill regime (a pool of one round of 8)."""
    monkeypatch.setattr(
        CUDABackend, "round_cap",
        lambda self, bytes_per_task, headroom=0.85, bytes_per_round=0: 8)


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_compacted_equals_classic_resident(data, form, monkeypatch):
    X, y = data
    if form == "dense":
        X = X.toarray()
    bk = CUDABackend(device="cpu")
    compacted = _torch_grid(X, y, backend=bk, partitions=8, refit=True)
    st = bk.last_round_stats
    assert (st["mode"], st["regime"], st["chunk"]) == \
        ("compacted", "resident", 3)
    assert st["refills"] == 0 and st["rounds_per_slice"][-1] < 8
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    bk2 = CUDABackend(device="cpu")
    classic = _torch_grid(X, y, backend=bk2, partitions=8, refit=True)
    assert bk2.last_round_stats["mode"] == "classic"
    assert bk2.last_round_stats["tasks_per_round"] == 3
    _assert_bitwise(compacted, classic)
    np.testing.assert_array_equal(compacted.best_estimator_.coef_,
                                  classic.best_estimator_.coef_)


def test_batched_map_pads_the_last_round():
    """Every round the kernel sees has the round's shape; the padding
    lanes' outputs are dropped and the tasks keep their order."""
    shapes = []

    def kernel(shared, task):
        shapes.append(tuple(task["t"].shape))
        return {"out": task["t"][:, None] * shared + 1.0}

    bk = CUDABackend(device="cpu")
    t = np.arange(11, dtype=np.float32)
    out = bk.batched_map(kernel, {"t": t}, torch.full((3,), 2.0),
                         round_size=4)
    assert shapes == [(4,), (4,), (4,)]
    np.testing.assert_array_equal(out["out"], t[:, None] * 2.0 + 1.0
                                  + np.zeros((11, 3), np.float32))
    assert bk.last_round_stats["rounds"] == 3


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_compacted_equals_classic_short_last_round(data, form, monkeypatch):
    """24 tasks in rounds of 5: the classic path's last round holds 4
    tasks and is padded to 5 slots, the compacted path's round shape."""
    X, y = data
    if form == "dense":
        X = X.toarray()
    bk = CUDABackend(device="cpu")
    compacted = _torch_grid(X, y, backend=bk, partitions=5, refit=True)
    assert (bk.last_round_stats["mode"], bk.last_round_stats["chunk"]) == \
        ("compacted", 5)
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    bk2 = CUDABackend(device="cpu")
    classic = _torch_grid(X, y, backend=bk2, partitions=5, refit=True)
    st = bk2.last_round_stats
    assert (st["mode"], st["rounds"], st["tasks_per_round"]) == \
        ("classic", 5, 5)
    _assert_bitwise(compacted, classic)
    np.testing.assert_array_equal(compacted.best_estimator_.coef_,
                                  classic.best_estimator_.coef_)


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_compacted_equals_classic_refill(data, form, monkeypatch, refill):
    X, y = data
    if form == "dense":
        X = X.toarray()
    bk = CUDABackend(device="cpu")
    compacted = _torch_grid(X, y, backend=bk, refit=True)
    st = bk.last_round_stats
    assert (st["mode"], st["regime"], st["chunk"], st["pool_rounds"]) == \
        ("compacted", "refill", 8, 1)
    assert st["refilled_lanes"] == 16
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    bk2 = CUDABackend(device="cpu")
    classic = _torch_grid(X, y, backend=bk2, refit=True)
    assert bk2.last_round_stats["tasks_per_round"] == 8
    _assert_bitwise(compacted, classic)
    np.testing.assert_array_equal(compacted.best_estimator_.coef_,
                                  classic.best_estimator_.coef_)


def test_lane_counts(data):
    """The round stats account for every lane: each retires once, by one
    reason; lane-iterations used are the lanes' n_iter summed and never
    exceed those carried."""
    X, y = data
    gs = _torch_grid(X, y, grid={"C": CS + [3.0, 10.0]})
    st = gs.round_stats_[0]
    n = len(CS + [3.0, 10.0]) * 3
    n_iter = np.asarray(st["lane_n_iter"])
    assert n_iter.shape == (n,) and (n_iter >= 1).all()
    assert (n_iter <= EST["max_iter"]).all()
    assert st["lane_iters_used"] == int(n_iter.sum())
    assert st["lane_iters_carried"] >= st["lane_iters_used"]
    assert st["lanes_converged"] + st["lanes_stalled"] \
        + st["lanes_max_iter"] == n
    assert st["retired_convergence"] == n and st["retired_rung"] == 0
    assert sum(st["retired_per_slice"]) == n
    assert len(st["rounds_per_slice"]) == st["slices"]
    at_max = np.asarray(st["lane_status"]) == 2
    np.testing.assert_array_equal(n_iter[at_max], EST["max_iter"])


def _counter_spec(n_slice):
    """A solve whose lane t needs ``need[t]`` iterations and adds its
    ``val[t]`` row to an accumulator at each: finalize gives back the
    iterations and the accumulated sum, so a lane moved or restarted
    with the wrong state shows."""
    def init(shared, task):
        T = task["need"].shape[0]
        return {"it": torch.zeros(T, dtype=torch.int64),
                "acc": torch.zeros(T, 3), "done": task["need"] <= 0}

    def restart(shared, task, carry, slots):
        carry["it"].index_fill_(0, slots, 0)
        carry["acc"].index_fill_(0, slots, 0.0)
        carry["done"].index_copy_(
            0, slots, task["need"].index_select(0, slots) <= 0)
        return carry

    def step(shared, task, carry):
        for _ in range(n_slice):
            live = ~carry["done"]
            carry["it"] = carry["it"] + live
            carry["acc"] = carry["acc"] + live[:, None] * task["val"]
            carry["done"] = carry["it"] >= task["need"]
        return carry

    def finalize(shared, task, carry):
        return {"it": carry["it"], "acc": carry["acc"].sum(1)}

    return backend_mod.IterativeKernelSpec(init, restart, step, finalize,
                                           ("it", "acc"))


@pytest.mark.parametrize("cap", [None, 8])
def test_slice_loop_moves_and_refills_lanes(monkeypatch, cap):
    """The slice loop on a counter solve: every lane's output is its own
    however it moved (merges in the resident regime, refills in a pool
    of one round), in task order."""
    if cap is not None:
        monkeypatch.setattr(
            CUDABackend, "round_cap",
            lambda self, b, headroom=0.85, bytes_per_round=0: cap)
    rng = np.random.RandomState(0)
    need = rng.randint(0, 40, 45)
    val = rng.rand(45, 3).astype(np.float32)
    bk = CUDABackend(device="cpu")
    out = bk.batched_map_iterative(
        _counter_spec(5), {"need": need, "val": val}, {}, round_size=8)
    st = bk.last_round_stats
    np.testing.assert_array_equal(out["it"], need)
    np.testing.assert_allclose(out["acc"], need * val.sum(1), rtol=1e-6)
    np.testing.assert_array_equal(st["lane_n_iter"], need)
    assert st["lane_iters_used"] == need.sum()
    assert sum(st["retired_per_slice"]) == 45
    if cap is None:
        assert (st["regime"], st["pool_rounds"]) == ("resident", 6)
        assert st["compactions"] >= 1 and st["refills"] == 0
    else:
        assert (st["regime"], st["pool_rounds"]) == ("refill", 1)
        assert st["refilled_lanes"] == 45 - 8
        assert set(st["rounds_per_slice"]) == {1}


# ---------------------------------------------------------------------------
# the port against the JAX package's compacted path
# ---------------------------------------------------------------------------

#: the C grid of tests/test_torch_search.py and two tolerances: 36 tasks
#: (C ~ 0.072 of CS sits on a near-tie where either package's dense and
#: packed fits of one lane flip a test prediction, as they do at C >= 2.5)
PARITY_GRID = {"C": list(np.logspace(-2, 0, 6)), "tol": [1e-2, 1e-3]}


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_compacted_matches_jax_compacted(data, form):
    X, y = data
    if form == "dense":
        X = X.toarray()
    tg = _torch_grid(X, y, grid=PARITY_GRID, refit=True)
    jbk = TPUBackend()
    jg = JaxGrid(JaxLR(engine="xla", **EST), PARITY_GRID, cv=3,
                 scoring="f1_weighted", backend=jbk).fit(X, y)
    assert tg.round_stats_[0]["mode"] == "compacted"
    assert jbk.last_round_stats["mode"] == "compacted"
    for key in ["mean_test_score"] + [f"split{i}_test_score"
                                      for i in range(3)]:
        np.testing.assert_allclose(tg.cv_results_[key], jg.cv_results_[key],
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tg.cv_results_["rank_test_score"],
                                  jg.cv_results_["rank_test_score"])
    assert tg.best_params_ == jg.best_params_
    assert tg.cv_results_["params"] == jg.cv_results_["params"]
    np.testing.assert_allclose(tg.best_estimator_.coef_,
                               jg.best_estimator_.coef_, atol=1e-3)


# ---------------------------------------------------------------------------
# gates, switches, cost order, out of memory
# ---------------------------------------------------------------------------

def test_gate_respects_env_and_sizes(monkeypatch):
    bk = CUDABackend(device="cpu")
    assert MIN_ITER_TASKS == 24
    assert iterative_fit_supported(bk, TorchLR, 64, 100) == 13
    assert iterative_fit_supported(bk, TorchLR, 24, 100) == 13
    assert iterative_fit_supported(bk, TorchLR, 23, 100) is None
    assert iterative_fit_supported(bk, TorchLR, 64, None) is None
    assert iterative_fit_supported(bk, TorchLR, 64, 4) is None
    assert iterative_fit_supported(bk, TorchRidge, 64, 100) is None
    assert iterative_fit_supported(TaskBackend(), TorchLR, 64, 100) is None
    for off in ("0", "false", "no"):
        monkeypatch.setenv("SKDIST_COMPACTION", off)
        assert iterative_fit_supported(bk, TorchLR, 64, 100) is None
    monkeypatch.delenv("SKDIST_COMPACTION")
    for env in ("", "3", "17", "0", "junk"):
        monkeypatch.setenv("SKDIST_SLICE_ITERS", env)
        for max_iter in (1, 20, 33, 100, 200):
            assert resolve_slice_iters(max_iter) == jax_slice_iters(max_iter)
    monkeypatch.setenv("SKDIST_SLICE_ITERS", "100")
    assert iterative_fit_supported(bk, TorchLR, 64, 100) is None
    for n in (1, 7, 24, 30, 100, 480):
        assert iterative_chunk_size(n, 1) == jax_chunk_size(n, 1)


def test_small_grids_stay_classic(data):
    X, y = data
    bk = CUDABackend(device="cpu")
    _torch_grid(X, y, grid={"C": CS[:7]}, backend=bk, max_iter=20)  # 21
    assert bk.last_round_stats["mode"] == "classic"


def test_compaction_switch_and_slice_iters(data, monkeypatch):
    """SKDIST_SLICE_ITERS sizes the slices (more of them, same results);
    SKDIST_COMPACTION=0 returns the search to the classic path."""
    X, y = data
    bk = CUDABackend(device="cpu")
    base = _torch_grid(X, y, backend=bk, partitions=8, max_iter=40)
    slices = bk.last_round_stats["slices"]
    monkeypatch.setenv("SKDIST_SLICE_ITERS", "3")
    bk3 = CUDABackend(device="cpu")
    fine = _torch_grid(X, y, backend=bk3, partitions=8, max_iter=40)
    assert bk3.last_round_stats["slices"] > slices
    _assert_bitwise(base, fine)
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    bk0 = CUDABackend(device="cpu")
    _torch_grid(X, y, backend=bk0, partitions=8, max_iter=20)
    assert bk0.last_round_stats["mode"] == "classic"


def test_cost_permutation_round_trip_keeps_row_order(data, monkeypatch):
    """The cost order is a scheduler detail: rows stay in candidate
    order with their own values (the JAX package's contract)."""
    X, y = data
    grid = {"C": [0.9, 0.01, 0.3, 0.05], "tol": [1e-2, 1e-3]}
    gs = _torch_grid(X, y, grid=grid, partitions=8, max_iter=40)
    from skdist_tpu_torch.utils.cv import ParameterGrid

    assert gs.cv_results_["params"] == list(ParameterGrid(grid))
    np.testing.assert_array_equal(
        np.asarray([p["C"] for p in gs.cv_results_["params"]]),
        np.asarray(gs.cv_results_["param_C"].compressed(), dtype=float))
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    _assert_bitwise(gs, _torch_grid(X, y, grid=grid, partitions=8,
                                    max_iter=40))


def test_oom_in_slice_loop_downgrades(data, monkeypatch):
    """An out-of-memory error in a slice warns and reruns the bucket on
    the classic path at the same round size, with the same results."""
    X, y = data
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    classic = _torch_grid(X, y, partitions=8, max_iter=40)
    monkeypatch.delenv("SKDIST_COMPACTION")
    real = TorchLR._build_fit_slice_kernels.__func__
    calls = []

    def flaky(cls, meta, static, n_slice):
        ks = real(cls, meta, static, n_slice)
        step = ks["step"]

        def oom_step(*a):
            calls.append(1)
            if len(calls) == 3:
                raise torch.cuda.OutOfMemoryError("simulated")
            return step(*a)

        ks["step"] = oom_step
        return ks

    monkeypatch.setattr(TorchLR, "_build_fit_slice_kernels",
                        classmethod(flaky))
    bk = CUDABackend(device="cpu")
    with pytest.warns(UserWarning, match="falling back to the classic"):
        downgraded = _torch_grid(X, y, backend=bk, partitions=8,
                                 max_iter=40)
    assert bk.last_round_stats["mode"] == "classic"
    assert bk.last_round_stats["tasks_per_round"] == 3
    _assert_bitwise(downgraded, classic)


def test_task_backend_runs_the_fallback():
    """A backend without the slice loop runs the spec's classic kernel
    and deactivates a rung (its run is exhaustive)."""
    calls = []

    class Host(TaskBackend):
        def batched_map(self, kernel, task_args, shared, **kw):
            calls.append((kernel, kw["round_size"]))
            return {"ok": np.ones(3)}

    rung = backend_mod.RungController(eta=3)
    spec = backend_mod.IterativeKernelSpec(None, None, None, None, ("w",),
                                           fallback="classic")
    out = Host().batched_map_iterative(spec, {"x": np.zeros(3)}, {},
                                       round_size=2, rung=rung)
    assert calls == [("classic", 2)] and out["ok"].shape == (3,)
    assert rung.active is False
    with pytest.raises(NotImplementedError):
        Host().batched_map_iterative(
            backend_mod.IterativeKernelSpec(None, None, None, None, ()),
            {"x": np.zeros(3)}, {})
