"""The port's forests (skdist_tpu_torch.models.forest and
skdist_tpu_torch.distribute.ensemble) against the JAX package's, on the
same numpy inputs made from a seed.

- With ``bootstrap=False, max_features=None`` no random draw is
  involved, and the port must grow the JAX package's forest tree for
  tree (the JAX reference pinned to ``hist_mode="scatter"``, never
  ``"auto"``, whose CPU default is a host engine with other streams):
  ``feat``/``thr``/``is_split`` and the stored seeds equal, ``leaf``
  atol 1e-5, ``predict_proba`` atol 1e-6 (a mean over trees summed in
  another order).
- With bootstrap and ``max_features="sqrt"`` the two draw from
  different generators (``jax.random`` against the port's counter
  hash), so parity is statistical: over four random states, the mean
  held-out accuracy within 0.03 and the mean ``oob_score_`` within 0.05
  (a problem whose 2000-row held-out set keeps the accuracy's noise
  well below that).
- Warm start, class_weight, ``apply``, ``feature_importances_``,
  ``estimators_``, ``RandomTreesEmbedding.transform``, the clean pickle,
  ``get_oof``, and the conversion of a fitted JAX forest, which must
  predict and apply as the JAX one and refuse OOB scoring over its
  ``jax.random`` draws.
"""

import pickle

import numpy as np
import pytest
import torch

from skdist_tpu.distribute import ensemble as je
from skdist_tpu.models import forest as jf
from skdist_tpu_torch.convert import forest_from_reference
from skdist_tpu_torch.distribute import ensemble as te
from skdist_tpu_torch.models import forest as tf
from skdist_tpu_torch.parallel import CUDABackend

SMALL = dict(n_estimators=8, max_depth=4)


def _clf(seed, n, d=6):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] + 0.5 * X[:, 2]) > 1.25).astype(np.int64)
    return X, y


def _multi(seed=0, n=300, d=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    s = X @ rng.randn(d) + 0.3 * rng.randn(n)
    y = np.digitize(s, np.quantile(s, [0.3, 0.8]))
    return X, np.array(["a", "b", "c"])[y]


def _reg(seed=0, n=300, d=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.2 * rng.randn(n)).astype(np.float32)
    return X, y


def _same_forest(ours, ref):
    for k in ("feat", "thr", "is_split", "seed"):
        np.testing.assert_array_equal(ours._trees[k], ref._trees[k],
                                      err_msg=k)
    np.testing.assert_allclose(ours._trees["leaf"], ref._trees["leaf"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours._edges, ref._edges)


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_deterministic_forests_equal_jax(kind):
    kw = dict(SMALL, bootstrap=False, max_features=None, random_state=3)
    if kind == "clf":
        X, y = _multi()
        ref = je.DistRandomForestClassifier(hist_mode="scatter", **kw)
        ours = te.DistRandomForestClassifier(device="cpu", **kw)
    else:
        X, y = _reg()
        ref = je.DistRandomForestRegressor(hist_mode="scatter", **kw)
        ours = te.DistRandomForestRegressor(device="cpu", **kw)
    ref.fit(X, y)
    ours.fit(X, y)
    _same_forest(ours, ref)
    Xq = np.random.RandomState(1).rand(200, X.shape[1]).astype(np.float32)
    if kind == "clf":
        np.testing.assert_allclose(ours.predict_proba(Xq),
                                   ref.predict_proba(Xq), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ours.predict(Xq), ref.predict(Xq))
    else:
        np.testing.assert_allclose(ours.predict(Xq), ref.predict(Xq),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.apply(Xq), ref.apply(Xq))
    np.testing.assert_allclose(ours.feature_importances_,
                               ref.feature_importances_, rtol=1e-5)
    assert ours.backend is None  # stripped: the artifact pickles clean


def test_class_weight_forest_equals_jax():
    """class_weight folds fractional weights into the channels."""
    X, y = _multi(seed=2)
    kw = dict(SMALL, bootstrap=False, max_features=None, random_state=0,
              class_weight={"a": 2.0, "b": 0.5})
    ref = jf.RandomForestClassifier(hist_mode="scatter", **kw).fit(X, y)
    ours = tf.RandomForestClassifier(device="cpu", **kw).fit(X, y)
    _same_forest(ours, ref)
    bal = tf.RandomForestClassifier(device="cpu", **dict(
        kw, class_weight="balanced")).fit(X, y)
    assert not np.array_equal(bal._trees["leaf"], ours._trees["leaf"])


def test_randomised_forests_agree_statistically():
    Xte, yte = _clf(100, 2000)
    acc, oob = [], []
    for rs in range(4):
        X, y = _clf(rs, 400)
        kw = dict(SMALL, random_state=rs, oob_score=True)
        ref = je.DistRandomForestClassifier(hist_mode="scatter", **kw)
        ours = te.DistRandomForestClassifier(device="cpu", **kw)
        with pytest.warns(UserWarning, match="in-bag"):
            ref.fit(X, y)
        with pytest.warns(UserWarning, match="in-bag"):
            ours.fit(X, y)
        acc.append((ref.score(Xte, yte), ours.score(Xte, yte)))
        oob.append((ref.oob_score_, ours.oob_score_))
        assert ours.oob_decision_function_.shape == (400, 2)
    acc, oob = np.mean(acc, axis=0), np.mean(oob, axis=0)
    assert acc[1] > 0.8
    assert abs(acc[0] - acc[1]) <= 0.03, acc
    assert abs(oob[0] - oob[1]) <= 0.05, oob


def test_rounds_do_not_change_the_trees():
    """partitions cuts the tree axis into rounds of batched_map, which
    returns each tree's (N,) and (N, K) arrays with their trailing axes
    and records the rounds; a tree's draws depend on its seed alone, so
    the cut changes no tree."""
    X, y = _clf(1, 300)
    kw = dict(SMALL, random_state=4, device="cpu")
    backend = CUDABackend(device="cpu")
    cut = te.DistRandomForestClassifier(partitions=3, backend=backend, **kw)
    cut.fit(X, y)
    stats = backend.last_round_stats
    assert stats["rounds"] == 3 and stats["tasks"] == 8
    assert stats["bytes_per_task"] > 0
    whole = te.DistRandomForestClassifier(**kw).fit(X, y)
    for k in whole._trees:
        np.testing.assert_array_equal(cut._trees[k], whole._trees[k])
    assert cut._trees["leaf"].shape == (8, 31, 2)


def test_warm_start_appends_and_keeps_edges():
    X, y = _clf(0, 300)
    kw = dict(max_depth=4, random_state=5, device="cpu")
    cold = tf.RandomForestClassifier(n_estimators=8, **kw).fit(X, y)
    warm = tf.RandomForestClassifier(n_estimators=4, warm_start=True, **kw)
    warm.fit(X, y)
    edges = warm._edges
    X2 = X * 2.0  # new data: the edges must not move
    warm.set_params(n_estimators=8).fit(X2, y)
    assert warm._edges is edges
    assert warm._trees["feat"].shape[0] == 8
    # the seed stream advances past the grown trees: the 8 seeds are the
    # cold fit's, and the first 4 trees are the cold fit's first 4
    np.testing.assert_array_equal(warm._trees["seed"], cold._trees["seed"])
    for k in ("feat", "thr", "leaf"):
        np.testing.assert_array_equal(warm._trees[k][:4], cold._trees[k][:4])
    with pytest.raises(ValueError, match="smaller"):
        warm.set_params(n_estimators=2).fit(X, y)
    # no new trees, then OOB over the stored seeds only
    warm.set_params(n_estimators=8, oob_score=True)
    with pytest.warns(UserWarning, match="in-bag"):
        warm.fit(X2, y)
    assert np.isfinite(warm.oob_score_)


def test_estimators_apply_importances_and_pickle():
    X, y = _multi(seed=4)
    f = te.DistExtraTreesClassifier(device="cpu", random_state=1, **SMALL)
    f.fit(X, y)
    leaves = f.apply(X)
    assert leaves.shape == (len(X), 8)
    ests = f.estimators_
    assert len(ests) == 8
    for t in (0, 7):
        np.testing.assert_array_equal(ests[t].apply(X), leaves[:, t])
    mean = np.mean([e.predict_proba(X) for e in ests], axis=0)
    np.testing.assert_allclose(f.predict_proba(X), mean, atol=1e-6)
    imp = f.feature_importances_
    assert imp.shape == (5,) and abs(imp.sum() - 1.0) < 1e-6
    loaded = pickle.loads(pickle.dumps(f))
    np.testing.assert_array_equal(loaded.predict_proba(X), f.predict_proba(X))
    np.testing.assert_array_equal(loaded.predict(X), f.predict(X))
    with pytest.raises(TypeError, match="cannot be pickled"):
        pickle.dumps(CUDABackend(device="cpu"))


def test_random_trees_embedding_layout():
    X, _ = _reg(seed=5)
    emb = te.DistRandomTreesEmbedding(n_estimators=4, max_depth=3,
                                      random_state=0, device="cpu")
    out = emb.fit_transform(X)
    N = 2 ** 4 - 1
    assert out.shape == (len(X), 4 * N)
    dense = out.toarray()
    assert (dense.sum(axis=1) == 4).all()  # one leaf per tree
    for t in range(4):
        block = dense[:, t * N:(t + 1) * N]
        assert (block.sum(axis=1) == 1).all()
        np.testing.assert_array_equal(block.argmax(axis=1),
                                      emb.apply(X)[:, t])
    assert emb.get_params()["hist_mode"] == "auto"


def test_regressors_extra_trees_and_get_oof():
    X, y = _reg(seed=6)
    r = te.DistExtraTreesRegressor(device="cpu", random_state=0, **SMALL)
    assert r.fit(X, y).score(X, y) > 0.5
    rf = te.DistRandomForestRegressor(device="cpu", random_state=0,
                                      oob_score=True, n_estimators=8,
                                      max_depth=4)
    with pytest.warns(UserWarning, match="in-bag"):
        rf.fit(X, y)
    assert rf.oob_prediction_.shape == (len(X),)
    assert np.isfinite(rf.oob_score_)

    Xc, yc = _clf(3, 200)
    clf = te.DistRandomForestClassifier(device="cpu", random_state=0,
                                        **SMALL)
    clf, oof = te.get_oof(clf, Xc, yc, n_splits=4)
    assert oof.shape == (200, 2)
    np.testing.assert_allclose(oof.sum(axis=1), 1.0, atol=1e-6)
    assert clf.predict(Xc).shape == (200,)


def test_converted_jax_forest_predicts_identically_and_refuses_oob():
    X, y = _multi(seed=7)
    ref = je.DistRandomForestClassifier(hist_mode="scatter", random_state=2,
                                        **SMALL).fit(X, y)
    ours = forest_from_reference(ref, device="cpu")
    assert type(ours) is te.DistRandomForestClassifier
    Xq = np.random.RandomState(3).rand(150, X.shape[1]).astype(np.float32)
    np.testing.assert_allclose(ours.predict_proba(Xq), ref.predict_proba(Xq),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.predict(Xq), ref.predict(Xq))
    np.testing.assert_array_equal(ours.apply(Xq), ref.apply(Xq))
    np.testing.assert_allclose(ours.feature_importances_,
                               ref.feature_importances_, rtol=1e-6)
    ours.set_params(oob_score=True, warm_start=True)
    with pytest.raises(ValueError, match="jax.random"):
        ours.fit(X, y)
    with pytest.raises(ValueError, match="jax.random"):
        ours._compute_oob(X, np.zeros(len(X), np.int64), "cpu")
    # a warm start without OOB appends the port's own trees
    ours.set_params(oob_score=False, n_estimators=10).fit(X, y)
    assert ours._trees["feat"].shape[0] == 10

    tree = ref.estimators_[0]
    one = forest_from_reference(tree, device="cpu")
    np.testing.assert_allclose(one.predict_proba(Xq), tree.predict_proba(Xq),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(one.apply(Xq), tree.apply(Xq))

    emb = je.DistRandomTreesEmbedding(n_estimators=3, max_depth=3,
                                      random_state=0,
                                      hist_mode="scatter").fit(X)
    ours_emb = forest_from_reference(emb, device="cpu")
    assert (ours_emb.transform(Xq) != emb.transform(Xq)).nnz == 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the no-card path cannot run")
    X, y = _clf(0, 50)
    from skdist_tpu_torch.models import DecisionTreeClassifier

    for est in (te.DistRandomForestClassifier(n_estimators=2),
                tf.RandomForestClassifier(n_estimators=2),
                tf.ExtraTreesRegressor(n_estimators=2),
                DecisionTreeClassifier()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            est.fit(X, y)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.RandomForestClassifier(n_estimators=2, hist_mode="native",
                                  device="cpu").fit(X, y)
