"""Trees on the batched paths of the port's searches and multiclass
meta-estimators (``_BaseTree._build_fit_kernel``), against the JAX
package's, on the same numpy inputs made from a seed.

- ``DistGridSearchCV`` over ``DecisionTreeClassifier``/``Regressor``
  (``device="cpu"``, ``CUDABackend(device="cpu")``) runs batched, not
  generic, and its ``split*_test_score``/``mean_test_score`` equal the
  JAX package's batched search (pinned to ``hist_mode="scatter"``)
  within 1e-6, with the same ``best_params_``: both bin X once under the
  edges of the whole X and grow each fold's tree on fold-masked weights.
- One-vs-rest and one-vs-one over a tree base run batched (a class or a
  class pair a lane, with its own labels and pair weights) and predict
  as the JAX package's within 1e-6.
- Each lane of a round is bitwise the lone fit of its weights and
  labels, in any slot.
- The searches fall to the generic path exactly where the JAX package's
  do: a proba-only metric (trees have no proba kernel), a searched param
  that is not a tree parameter, a sample_weight that is not a full-length
  vector.
"""

import numpy as np
import pytest
import torch

from skdist_tpu.distribute.multiclass import (
    DistOneVsOneClassifier as JaxOvO,
    DistOneVsRestClassifier as JaxOvR,
)
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.models import tree as jt
from skdist_tpu_torch import (
    CUDABackend,
    DistGridSearchCV,
    DistOneVsOneClassifier,
    DistOneVsRestClassifier,
)
from skdist_tpu_torch.models import tree as tt

GRID = {"max_depth": [2, 4], "min_samples_leaf": [1, 10]}


def _data(seed=0, n=400, d=6, classes=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    s = X @ rng.randn(d) + 0.3 * rng.randn(n)
    y = np.digitize(s, np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1]))
    return X, y, s.astype(np.float32)


def _cpu():
    return CUDABackend(device="cpu")


def _score_keys(results):
    return [k for k in results if k.endswith("test_score")
            and not k.startswith("rank")]


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_tree_search_runs_batched_and_equals_jax(kind):
    X, y, s = _data(0)
    if kind == "clf":
        ref = JaxGrid(jt.DecisionTreeClassifier(hist_mode="scatter"), GRID,
                      cv=3).fit(X, y)
        ours = DistGridSearchCV(tt.DecisionTreeClassifier(device="cpu"),
                                GRID, cv=3, backend=_cpu()).fit(X, y)
    else:
        ref = JaxGrid(jt.DecisionTreeRegressor(hist_mode="scatter"), GRID,
                      cv=3).fit(X, s)
        ours = DistGridSearchCV(tt.DecisionTreeRegressor(device="cpu"),
                                GRID, cv=3, backend=_cpu()).fit(X, s)
    # one bucket a candidate (every tree parameter shapes the kernel), one
    # classic round of 3 fold lanes each
    assert [st["mode"] for st in ours.round_stats_] == ["classic"] * 4
    assert all(st["tasks"] == 3 for st in ours.round_stats_)
    for k in _score_keys(ref.cv_results_):
        np.testing.assert_allclose(ours.cv_results_[k], ref.cv_results_[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert ours.best_params_ == ref.best_params_
    assert ours.best_estimator_.get_params()["max_depth"] == \
        ours.best_params_["max_depth"]


def test_tree_search_fractional_weights_equal_jax():
    """A full-length fractional sample_weight rides the batched path (the
    fold masks multiply it; the histogram sums it in float)."""
    X, y, _ = _data(1)
    sw = np.random.RandomState(2).uniform(0.2, 2.0, len(y)).astype(np.float32)
    grid = {"max_depth": [3], "min_samples_leaf": [1, 5]}
    ref = JaxGrid(jt.DecisionTreeClassifier(hist_mode="scatter"), grid,
                  cv=3).fit(X, y, sample_weight=sw)
    ours = DistGridSearchCV(tt.DecisionTreeClassifier(device="cpu"), grid,
                            cv=3, backend=_cpu()).fit(X, y, sample_weight=sw)
    assert ours.round_stats_[0]["mode"] == "classic"
    for k in _score_keys(ref.cv_results_):
        np.testing.assert_allclose(ours.cv_results_[k], ref.cv_results_[k],
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["proba_metric", "outside_param",
                                  "scalar_weight"])
def test_tree_search_falls_to_generic_where_jax_does(case):
    X, y, _ = _data(3, n=200)
    est = tt.DecisionTreeClassifier(max_depth=3, device="cpu")
    grid, kw, fit_kw = {"min_samples_leaf": [1, 5]}, {}, {}
    if case == "proba_metric":
        kw["scoring"] = "neg_log_loss"
    elif case == "outside_param":
        grid = {"device": ["cpu"]}
    else:
        fit_kw["sample_weight"] = 2.0
    gs = DistGridSearchCV(est, grid, cv=3, backend=_cpu(), **kw).fit(
        X, y, **fit_kw)
    assert gs.round_stats_[0]["mode"] == "generic"
    assert np.all(np.isfinite(gs.cv_results_["mean_test_score"]))


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_lanes_are_lone_fits_in_any_slot(kind):
    """A round of T lanes (fold masks times fractional or integral
    weights, one label vector a lane for a classifier) grows, in every
    slot, the bitwise tree of the lone fit of that lane."""
    X, y, s = _data(4, n=300)
    est = (tt.DecisionTreeClassifier(max_depth=4, device="cpu")
           if kind == "clf" else
           tt.DecisionTreeRegressor(max_depth=4, device="cpu"))
    data, meta = est._prep_fit_data(X, y if kind == "clf" else s)
    static = tuple(sorted(est._static_config(meta).items()))
    kernel = type(est)._build_fit_kernel(meta, static)
    Xb = type(est)._fit_operand(torch.as_tensor(data["X"]), meta, static)
    rng = np.random.RandomState(5)
    T, n = 5, X.shape[0]
    W = (rng.rand(T, n) < 0.7) * np.where(rng.rand(n) < 0.5, 1.0,
                                          rng.uniform(0.5, 2.0, n))
    W = torch.as_tensor(W.astype(np.float32))
    Y = torch.as_tensor(data["y"])
    if kind == "clf":  # one-vs-rest style lane labels
        Y = torch.stack([(Y == t % 3).to(torch.int32) for t in range(T)])
        meta2 = dict(meta, n_classes=2, classes=np.arange(2))
        static = tuple(sorted(est._static_config(meta2).items()))
        kernel = type(est)._build_fit_kernel(meta2, static)
    with torch.no_grad():
        batch = kernel(Xb, Y, W, {})
        for order in (np.arange(T), np.array([3, 0, 4, 1, 2])):
            lanes = kernel(Xb, Y[order] if Y.ndim == 2 else Y, W[order], {})
            for slot, t in enumerate(order):
                lone = kernel(Xb, Y[t:t + 1] if Y.ndim == 2 else Y,
                              W[t:t + 1], {})
                for k in lone:
                    assert torch.equal(lanes[k][slot], lone[k][0]), (k, t)
                    assert torch.equal(batch[k][t], lone[k][0]), (k, t)


@pytest.mark.parametrize("meta_cls", ["ovr", "ovo"])
def test_multiclass_tree_base_runs_batched_and_equals_jax(meta_cls):
    X, y, _ = _data(6, classes=4)
    base = dict(max_depth=4, min_samples_leaf=3)
    if meta_cls == "ovr":
        ref = JaxOvR(jt.DecisionTreeClassifier(hist_mode="scatter", **base))
        ours = DistOneVsRestClassifier(
            tt.DecisionTreeClassifier(device="cpu", **base), backend=_cpu())
    else:
        ref = JaxOvO(jt.DecisionTreeClassifier(hist_mode="scatter", **base))
        ours = DistOneVsOneClassifier(
            tt.DecisionTreeClassifier(device="cpu", **base), backend=_cpu())
    ref.fit(X, y)
    ours.fit(X, y)
    n_lanes = 4 if meta_cls == "ovr" else 6
    assert ours.round_stats_[0]["mode"] == "classic"
    assert ours.round_stats_[0]["tasks"] == n_lanes
    for a, b in zip(ref.estimators_, ours.estimators_):
        for k in ("feat", "thr", "is_split"):
            np.testing.assert_array_equal(b._params[k],
                                          np.asarray(a._params[k]))
    Xq = np.random.RandomState(7).rand(100, X.shape[1]).astype(np.float32)
    if meta_cls == "ovr":
        np.testing.assert_allclose(ours.predict_proba(Xq),
                                   ref.predict_proba(Xq), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(ours.decision_function(Xq),
                                   ref.decision_function(Xq), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(ours.predict(Xq), ref.predict(Xq))
