"""The port's bring-your-own-base forests (``DistForestClassifier``,
``DistForestRegressor``), the forests' bin memos and the backend's
device-broadcast reuse cache, against the JAX package's where it has
them, on numpy inputs made from a seed.

- BYO forests: the same seeds (``RandomState(random_state).randint``),
  bootstrap as bincount weights over the full X for a base whose ``fit``
  takes ``sample_weight`` (times a caller's weights), a row resample for
  one that does not, and ``partitions`` rounds; with deterministic tree
  bases (pinned to ``hist_mode="scatter"`` on both sides) the
  predictions equal the JAX package's within 1e-6. Pickled = live.
- Bin memos (``models/forest.py``, enabled by ``reuse_broadcast``): a
  second fit on the same host X reads both memos (no quantile pass, the
  same binned tensor) and grows bitwise the same trees; a new X misses;
  without ``reuse_broadcast`` both stay cold; a warm-start apply of
  inherited edges on a new X cannot change the edges a later fresh fit
  on that X reads.
- The reuse cache (``parallel/backend.py``): a large host array placed
  twice is uploaded once (a hit), a small one every time; an entry whose
  weakref no longer names its array is never served; the LRU bound
  holds; collecting the host array evicts its entry.
"""

import gc
import pickle
import weakref

import numpy as np
import pytest
import torch

import skdist_tpu.base as jbase
from skdist_tpu.distribute import ensemble as je
from skdist_tpu.models import tree as jt
from skdist_tpu_torch import DistForestClassifier, DistForestRegressor
import skdist_tpu_torch.base as tbase
from skdist_tpu_torch.distribute import ensemble as te
from skdist_tpu_torch.models import forest as fm
from skdist_tpu_torch.models import tree as tt
from skdist_tpu_torch.models.forest import _memo_apply_bins, _memo_edges
from skdist_tpu_torch.ops.binning import quantile_bin_edges
from skdist_tpu_torch.parallel import CUDABackend, LocalBackend
from skdist_tpu_torch.parallel import backend as bm


def _data(seed=0, n=300, d=6):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    s = X @ rng.randn(d) + 0.3 * rng.randn(n)
    y = np.digitize(s, np.quantile(s, [0.3, 0.7]))
    return X, np.array(["a", "b", "c"])[y], s.astype(np.float32)


class _PortUnweighted(tbase.BaseEstimator):
    """A regressor whose ``fit`` takes no sample_weight (the resample
    path)."""

    def __init__(self, max_depth=3, random_state=0):
        self.max_depth = max_depth
        self.random_state = random_state

    def fit(self, X, y):
        self.tree_ = tt.DecisionTreeRegressor(
            max_depth=self.max_depth, hist_mode="scatter",
            device="cpu").fit(X, y)
        return self

    def predict(self, X):
        return self.tree_.predict(X)


class _JaxUnweighted(jbase.BaseEstimator):
    def __init__(self, max_depth=3, random_state=0):
        self.max_depth = max_depth
        self.random_state = random_state

    def fit(self, X, y):
        self.tree_ = jt.DecisionTreeRegressor(
            max_depth=self.max_depth, hist_mode="scatter").fit(X, y)
        return self

    def predict(self, X):
        return self.tree_.predict(X)


@pytest.mark.parametrize("case", ["bootstrap", "user_weight", "no_bootstrap"])
def test_byo_forest_classifier_equals_jax(case):
    X, y, _ = _data(0)
    kw = dict(n_estimators=5, random_state=7, partitions=2,
              bootstrap=case != "no_bootstrap")
    fit_kw = {}
    if case == "user_weight":
        fit_kw["sample_weight"] = np.random.RandomState(1).randint(
            1, 4, len(y)).astype(np.float64)
    ref = je.DistForestClassifier(
        jt.DecisionTreeClassifier(max_depth=3, hist_mode="scatter"),
        **kw).fit(X, y, **fit_kw)
    ours = DistForestClassifier(
        tt.DecisionTreeClassifier(max_depth=3, hist_mode="scatter",
                                  device="cpu"), **kw).fit(X, y, **fit_kw)
    assert len(ours) == 5 and ours.backend is None
    assert [e.random_state for e in ours.estimators_] == \
        [e.random_state for e in ref.estimators_]
    Xq = np.random.RandomState(2).rand(80, X.shape[1]).astype(np.float32)
    np.testing.assert_allclose(ours.predict_proba(Xq), ref.predict_proba(Xq),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.predict(Xq), ref.predict(Xq))
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    loaded = pickle.loads(pickle.dumps(ours))
    np.testing.assert_array_equal(loaded.predict_proba(Xq),
                                  ours.predict_proba(Xq))


@pytest.mark.parametrize("base", ["weighted", "resampled"])
def test_byo_forest_regressor_equals_jax(base):
    X, _, s = _data(3)
    kw = dict(n_estimators=4, random_state=5, n_jobs=2)
    if base == "weighted":
        ref_base = jt.DecisionTreeRegressor(max_depth=3, hist_mode="scatter")
        our_base = tt.DecisionTreeRegressor(max_depth=3, hist_mode="scatter",
                                            device="cpu")
    else:
        ref_base, our_base = _JaxUnweighted(), _PortUnweighted()
    ref = je.DistForestRegressor(ref_base, **kw).fit(X, s)
    ours = DistForestRegressor(our_base, backend=LocalBackend(
        n_jobs=2, device="cpu"), **kw).fit(X, s)
    Xq = np.random.RandomState(4).rand(80, X.shape[1]).astype(np.float32)
    np.testing.assert_allclose(ours.predict(Xq), ref.predict(Xq), rtol=0,
                               atol=1e-6)
    assert abs(ours.score(X, s) - ref.score(X, s)) <= 1e-6


def test_byo_forests_are_exported():
    import skdist_tpu_torch as p
    from skdist_tpu_torch import distribute

    assert p.DistForestClassifier is te.DistForestClassifier
    assert distribute.DistForestRegressor is te.DistForestRegressor


def _forest(backend, **over):
    kw = dict(n_estimators=4, max_depth=4, random_state=0, device="cpu")
    kw.update(over)
    return te.DistRandomForestClassifier(backend=backend, **kw)


def test_bin_memos_hit_on_the_same_x_and_keep_the_trees(monkeypatch):
    X, y, _ = _data(6)
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()
    quantiles = []
    real = fm.quantile_bin_edges
    monkeypatch.setattr(fm, "quantile_bin_edges",
                        lambda *a: quantiles.append(1) or real(*a))
    bk = CUDABackend(device="cpu", reuse_broadcast=True)
    f1 = _forest(bk).fit(X, y)
    key = next(iter(fm._XB_MEMO))
    xb_first = fm._XB_MEMO[key][2]
    f2 = _forest(bk).fit(X, y)
    assert len(quantiles) == 1, "the second fit must read the edge memo"
    assert fm._XB_MEMO[key][2] is xb_first, "and the binned-X memo"
    for k in f1._trees:
        np.testing.assert_array_equal(f1._trees[k], f2._trees[k])
    X_new = X + np.float32(0.5)
    _forest(bk).fit(X_new, y)
    assert len(quantiles) == 2 and len(fm._XB_MEMO) == 2  # a new X misses
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()
    _forest(CUDABackend(device="cpu")).fit(X, y)
    assert not fm._EDGE_MEMO and not fm._XB_MEMO, \
        "without reuse_broadcast the memos stay cold"
    f3 = _forest(CUDABackend(device="cpu")).fit(X, y)
    for k in f1._trees:
        np.testing.assert_array_equal(f1._trees[k], f3._trees[k])


def test_warm_start_apply_does_not_poison_the_edge_memo():
    rng = np.random.RandomState(7)
    X_old = rng.rand(80, 5).astype(np.float32) * 10.0
    X_new = rng.rand(80, 5).astype(np.float32)
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()
    foreign = quantile_bin_edges(X_old, 8)
    _memo_apply_bins(X_new, foreign, 8, "cpu", enabled=True)
    served = _memo_edges(X_new, 8, enabled=True)
    np.testing.assert_array_equal(served, quantile_bin_edges(X_new, 8))
    assert not np.array_equal(served, foreign)
    # through the forests: a warm start on X_new applies X_old's edges;
    # a fresh fit on X_new then bins with X_new's own
    y = (X_new[:, 0] > 0.5).astype(int)
    bk = CUDABackend(device="cpu", reuse_broadcast=True)
    warm = _forest(bk, warm_start=True).fit(X_old, (X_old[:, 0] > 5) * 1)
    warm.set_params(n_estimators=6, backend=bk).fit(X_new, y)
    np.testing.assert_array_equal(warm._edges, quantile_bin_edges(X_old, 32))
    fresh = _forest(bk).fit(X_new, y)
    np.testing.assert_array_equal(fresh._edges, quantile_bin_edges(X_new, 32))
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()


def test_reuse_cache_hits_bounds_and_never_serves_stale():
    bm._BCAST_CACHE.clear()
    bk = CUDABackend(device="cpu", reuse_broadcast=True)
    a = np.ones((512, 1024), np.float32)  # 2 MiB: over the 1 MiB floor
    hits = bm._BCAST_HITS
    d1 = bk.place({"X": a})["X"]
    d2 = bk.place({"X": a})["X"]
    assert d1 is d2 and bm._BCAST_HITS == hits + 1
    assert d1.data_ptr() != torch.as_tensor(a).data_ptr()  # no alias
    small = np.ones(4, np.float32)
    assert bk.place({"s": small})["s"] is not bk.place({"s": small})["s"]
    off = CUDABackend(device="cpu")
    assert off.place({"X": a})["X"] is not off.place({"X": a})["X"]
    # an entry whose weakref names another array (a recycled id) is
    # never served
    other = np.zeros((512, 1024), np.float32)
    bm._BCAST_CACHE[(id(a), "cpu")] = (weakref.ref(other), "STALE")
    d3 = bk.place({"X": a})["X"]
    assert not isinstance(d3, str)
    np.testing.assert_array_equal(d3.numpy(), a)
    keep = [np.full((512, 1024), i, np.float32) for i in range(20)]
    for arr in keep:
        bk.place({"X": arr})
    assert len(bm._BCAST_CACHE) <= bm._BCAST_MAX
    bm._BCAST_CACHE.clear()


def test_reuse_cache_evicts_when_the_host_array_dies():
    bm._BCAST_CACHE.clear()
    bk = LocalBackend(device="cpu", reuse_broadcast=True)
    a = np.ones((512, 1024), np.float32)
    bk.place({"X": a})
    assert len(bm._BCAST_CACHE) == 1
    del a
    gc.collect()
    assert len(bm._BCAST_CACHE) == 0, \
        "a dead host array must not pin its device copy"
