"""The port's host C tree engine (``skdist_tpu_torch/native``,
``models/native_forest.py``, ``hist_mode="native"``) against its numpy
forms, the JAX package's native engine and the port's torch engine, on
numpy inputs made from a seed.

- The C ``hist_level`` equals its numpy form (classification and
  regression channels, a feature-activity mask; integer weights sum
  exactly, fractional ones within 1e-5), and ``best_splits`` equals
  ``_best_splits_numpy`` (the float64 C search against the float32 numpy
  one: gains rtol 1e-5, the chosen splits equal on this untied data).
- With ``bootstrap=False`` a port native forest is the JAX package's
  native forest tree for tree, bitwise, with ``max_features`` and
  ExtraTrees too: the per-level ``RandomState`` streams are copied.
- A native ``RandomForestClassifier`` with ``max_features=None`` equals
  the port's scatter forest tree for tree, with and without bootstrap
  (both draw it with ``utils/draws.py``), and its OOB score and decision
  function are the scatter forest's. A regressor's split search sums in
  float64 in C and in float32 in torch, which may pick another feature
  at a near tie (the JAX package's own engine caveat); it is held to the
  scatter forest's predictions within 0.05 of their spread.
- The C walker equals the torch walker (leaf values and node ids), and
  a forest's trees do not change with its thread count.
- ``"auto"`` takes the native engine exactly where the JAX package's CPU
  table does: a single tree on the CPU, a forest on a ``LocalBackend``;
  a ``CUDABackend`` forest round stays the scatter.
"""

import warnings

import numpy as np
import pytest
import torch

from skdist_tpu.models import forest as jf
from skdist_tpu_torch import native
from skdist_tpu_torch.distribute import ensemble as te
from skdist_tpu_torch.models import forest as tf
from skdist_tpu_torch.models import native_forest as nf
from skdist_tpu_torch.models import tree as tt
from skdist_tpu_torch.ops.binning import apply_bins_np, quantile_bin_edges
from skdist_tpu_torch.parallel import CUDABackend, LocalBackend


def _data(seed=0, n=400, d=7, classes=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    s = X @ rng.randn(d) + 0.3 * rng.randn(n)
    y = np.digitize(s, np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1]))
    return X, y.astype(np.int32), s.astype(np.float32)


def test_the_c_engine_builds():
    assert native.hist_tree_available(), native.build_error()


@pytest.mark.parametrize("kind", ["clf", "reg"])
@pytest.mark.parametrize("weights", ["counts", "fractional"])
def test_hist_level_c_equals_numpy(kind, weights):
    X, y, s = _data(1)
    B, Tb, nl = 16, 3, 4
    Xb = apply_bins_np(X, quantile_bin_edges(X, B))
    XbT = np.ascontiguousarray(Xb.T, np.uint8)
    rng = np.random.RandomState(2)
    n, d = Xb.shape
    node_rel = rng.randint(-1, nl, (Tb, n)).astype(np.int32)
    W = rng.randint(0, 3, (Tb, n)).astype(np.float32)
    if weights == "fractional":
        W *= rng.uniform(0.5, 1.5, (Tb, n)).astype(np.float32)
    act = (rng.rand(Tb, d) < 0.6).astype(np.uint8)
    C = 4  # three classes and the count, or the 4 regression channels
    kw = dict(cls=y, yv=None) if kind == "clf" else dict(cls=None, yv=s)
    got = native.hist_level(np.empty((Tb, d, nl, B, C), np.float32), XbT,
                            node_rel, W, act=act, **kw)
    want = native.hist_level(np.empty((Tb, d, nl, B, C), np.float32), XbT,
                             node_rel, W, act=act, force_python=True, **kw)
    if weights == "counts" and kind == "clf":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[~act.astype(bool)].any()  # skipped slabs stay zero


@pytest.mark.parametrize("kind", ["clf", "reg"])
@pytest.mark.parametrize("draws", ["none", "fmask", "extra"])
def test_best_splits_c_equals_numpy(kind, draws):
    X, y, s = _data(3)
    B, Tb, nl, K = 16, 2, 4, 3
    Xb = apply_bins_np(X, quantile_bin_edges(X, B))
    XbT = np.ascontiguousarray(Xb.T, np.uint8)
    rng = np.random.RandomState(4)
    n, d = Xb.shape
    node_rel = rng.randint(0, nl, (Tb, n)).astype(np.int32)
    W = rng.randint(0, 3, (Tb, n)).astype(np.float32)
    classification = kind == "clf"
    C = K + 1 if classification else 4
    hist = native.hist_level(
        np.empty((Tb, d, nl, B, C), np.float32), XbT, node_rel, W,
        cls=y if classification else None,
        yv=None if classification else s)
    fmask = urand = None
    if draws == "fmask":
        fmask = (rng.rand(Tb, d, nl) < 0.5).astype(np.uint8)
    if draws == "extra":
        urand = rng.rand(Tb, d, nl).astype(np.float32)
    got = native.best_splits_native(hist, fmask, urand, K if
                                    classification else 1, classification, 2)
    want = nf._best_splits_numpy(hist, fmask, urand, K if classification
                                 else 1, classification, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls_name", ["RandomForestClassifier",
                                      "ExtraTreesClassifier",
                                      "RandomForestRegressor",
                                      "ExtraTreesRegressor"])
def test_native_forest_is_the_jax_native_forest(cls_name):
    X, y, s = _data(5)
    yy = s if "Regressor" in cls_name else y
    kw = dict(n_estimators=5, max_depth=4, n_bins=16, bootstrap=False,
              max_features="sqrt", random_state=3, hist_mode="native")
    ref = getattr(jf, cls_name)(**kw).fit(X, yy)
    ours = getattr(tf, cls_name)(device="cpu", **kw).fit(X, yy)
    for k in ("feat", "thr", "is_split", "leaf", "gain", "seed"):
        np.testing.assert_array_equal(ours._trees[k],
                                      np.asarray(ref._trees[k]), err_msg=k)
    np.testing.assert_array_equal(ours._edges, np.asarray(ref._edges))
    Xq = np.random.RandomState(6).rand(50, X.shape[1]).astype(np.float32)
    want = (ref.predict_proba(Xq) if "Class" in cls_name
            else ref.predict(Xq))
    got = (ours.predict_proba(Xq) if "Class" in cls_name
           else ours.predict(Xq))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bootstrap", [False, True])
def test_native_forest_is_the_scatter_forest(bootstrap):
    X, y, _ = _data(7)
    kw = dict(n_estimators=6, max_depth=5, n_bins=16, bootstrap=bootstrap,
              oob_score=bootstrap, max_features=None, random_state=1,
              device="cpu")
    with warnings.catch_warnings():
        # a small forest leaves some samples in-bag for every tree
        warnings.simplefilter("ignore", UserWarning)
        nat = tf.RandomForestClassifier(hist_mode="native", **kw).fit(X, y)
        sc = tf.RandomForestClassifier(hist_mode="scatter", **kw).fit(X, y)
    for k in ("feat", "thr", "is_split", "leaf", "seed"):
        np.testing.assert_array_equal(nat._trees[k], sc._trees[k],
                                      err_msg=k)
    np.testing.assert_allclose(nat._trees["gain"], sc._trees["gain"],
                               rtol=1e-5, atol=1e-6)
    if bootstrap:
        assert nat.oob_score_ == sc.oob_score_
        np.testing.assert_array_equal(nat.oob_decision_function_,
                                      sc.oob_decision_function_)


def test_native_regressor_agrees_with_the_scatter_forest():
    X, _, s = _data(8)
    kw = dict(n_estimators=6, max_depth=5, n_bins=16, bootstrap=False,
              max_features=None, random_state=1, device="cpu")
    nat = tf.RandomForestRegressor(hist_mode="native", **kw).fit(X, s)
    sc = tf.RandomForestRegressor(hist_mode="scatter", **kw).fit(X, s)
    np.testing.assert_array_equal(nat._trees["feat"][:, :3],
                                  sc._trees["feat"][:, :3])
    gap = np.abs(nat.predict(X) - sc.predict(X)).max()
    assert gap <= 0.05 * float(np.std(s)), gap


@pytest.mark.parametrize("mode", ["predict", "apply"])
def test_c_walker_equals_torch_walker(mode):
    X, y, _ = _data(9)
    forest = tf.RandomForestClassifier(n_estimators=7, max_depth=5,
                                       random_state=0, hist_mode="scatter",
                                       device="cpu").fit(X, y)
    Xq = np.random.RandomState(10).rand(120, X.shape[1]).astype(np.float32)
    Xb = apply_bins_np(Xq, forest._edges)
    got = native.forest_walk_native(Xb, forest._trees, forest.max_depth,
                                    mode=mode)
    walk = tt.tree_predict_kernel(forest.max_depth,
                                  return_nodes=(mode == "apply"))
    trees = {k: torch.as_tensor(forest._trees[k])
             for k in ("feat", "thr", "is_split", "leaf")}
    res = walk(trees, torch.as_tensor(Xb))
    if mode == "apply":
        np.testing.assert_array_equal(got, res.T.numpy())
        np.testing.assert_array_equal(forest.apply(Xq), res.T.numpy())
    else:
        np.testing.assert_allclose(got, res.mean(0).numpy(), rtol=0,
                                   atol=1e-6)


def test_threads_do_not_change_the_trees():
    X, y, _ = _data(11)
    kw = dict(n_estimators=6, max_depth=5, max_features="sqrt",
              random_state=2, hist_mode="native", device="cpu")
    runs = [tf.ExtraTreesClassifier(n_jobs=j, **kw).fit(X, y)
            for j in (1, 3, -1)]
    for other in runs[1:]:
        for k in runs[0]._trees:
            np.testing.assert_array_equal(other._trees[k], runs[0]._trees[k])
        np.testing.assert_array_equal(other.predict_proba(X),
                                      runs[0].predict_proba(X))


def test_auto_takes_the_native_engine_where_the_jax_package_does(
        monkeypatch):
    X, y, _ = _data(12, n=200)
    calls = []
    real = nf.grow_forest_native

    def spy(*a, **k):
        calls.append(len(a[3]))
        return real(*a, **k)

    monkeypatch.setattr(nf, "grow_forest_native", spy)
    tt.DecisionTreeClassifier(max_depth=3, device="cpu").fit(X, y)
    assert calls == [1]
    tf.RandomForestClassifier(n_estimators=4, max_depth=3,
                              device="cpu").fit(X, y)
    assert calls == [1, 4]
    te.DistRandomForestClassifier(
        n_estimators=4, max_depth=3, device="cpu",
        backend=LocalBackend(device="cpu")).fit(X, y)
    assert calls == [1, 4, 4]
    # a CUDABackend forest round is a batched kernel: the scatter
    te.DistRandomForestClassifier(
        n_estimators=4, max_depth=3, device="cpu",
        backend=CUDABackend(device="cpu")).fit(X, y)
    te.DistRandomForestClassifier(n_estimators=4, max_depth=3,
                                  device="cpu").fit(X, y)
    tf.RandomForestClassifier(n_estimators=4, max_depth=3,
                              hist_mode="scatter", device="cpu").fit(X, y)
    assert calls == [1, 4, 4]
