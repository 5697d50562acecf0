"""The port's histogram trees (skdist_tpu_torch.models.tree) against the
JAX package's (skdist_tpu.models.tree), on the same binned inputs made
from a seed.

Where no random draw is involved (``max_features=d``, best splits), the
port must grow the JAX package's tree: every engine of the port
(``"pallas"``, which on the CPU is K4's plain version, ``"scatter"``,
``"matmul"``, ``"matmul_sib"``) against the JAX ``"pallas"`` engine in
interpret mode. Tolerances: ``feat``/``thr``/``is_split`` equal;
``leaf`` atol 1e-5 and ``gain`` rtol 1e-5 (the channel sums are taken
in another order, which moves fractional sums by a few ulps; the
classification channels are integer counts and sum exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skdist_tpu.models import tree as jt
from skdist_tpu.ops.binning import apply_bins as jax_apply_bins
from skdist_tpu_torch.models import tree as tt
from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges

N_BINS = 16


def _problem(kind, seed=0, n=300, d=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    w = rng.randn(d)
    if kind == "clf":
        y = np.digitize(X @ w + 0.3 * rng.randn(n),
                        np.quantile(X @ w, [0.4, 0.7])).astype(np.int32)
    else:
        y = (X @ w + 0.2 * rng.randn(n)).astype(np.float32)
    sw = rng.randint(0, 3, n).astype(np.float32)  # bootstrap-like counts
    edges = quantile_bin_edges(X, N_BINS)
    Xb = apply_bins(torch.as_tensor(X), edges).numpy()
    return X, y, sw, edges, Xb


def _channels(kind, y, sw):
    if kind == "clf":
        return np.array(jt.classification_channels(
            jnp.asarray(y), jnp.asarray(sw), 3))
    return np.array(jt.regression_channels(jnp.asarray(y),
                                             jnp.asarray(sw)))


def _cfg(kind, d, **over):
    cfg = dict(n_features=d, n_bins=N_BINS, channels=4, max_depth=4,
               max_features=d, min_samples_split=2, min_samples_leaf=1,
               min_impurity_decrease=0.0, extra=False,
               classification=(kind == "clf"))
    cfg.update(over)
    return cfg


def _assert_same_tree(ours, ref, t=0):
    for k in ("feat", "thr", "is_split"):
        np.testing.assert_array_equal(ours[k][t].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ours["leaf"][t].numpy(), np.asarray(ref["leaf"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours["gain"][t].numpy(), np.asarray(ref["gain"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_engines_grow_the_jax_tree(kind):
    X, y, sw, edges, Xb = _problem(kind)
    Ych = _channels(kind, y, sw)
    cfg = _cfg(kind, X.shape[1])
    ref = jt.build_tree_kernel(hist_mode="pallas", **cfg)(
        jnp.asarray(Xb), jnp.asarray(Ych), jax.random.PRNGKey(0))
    assert int(np.asarray(ref["is_split"]).sum()) >= 5  # a real tree
    for mode in ("pallas", "scatter", "matmul", "matmul_sib"):
        ours = tt.build_tree_kernel(hist_mode=mode, **cfg)(
            torch.as_tensor(Xb), torch.as_tensor(Ych)[None],
            torch.tensor([0]))
        _assert_same_tree(ours, ref)


def test_round_of_trees_equals_single_trees():
    """A round of T trees with their own channels grows what T single
    calls grow (the tree axis folded into the kernel)."""
    X, y, _sw, edges, Xb = _problem("clf", seed=2)
    rng = np.random.RandomState(5)
    sws = rng.randint(0, 3, size=(3, X.shape[0])).astype(np.float32)
    Ych = np.stack([_channels("clf", y, s) for s in sws])
    grow = tt.build_tree_kernel(hist_mode="auto", **_cfg("clf", X.shape[1]))
    seeds = torch.tensor([11, 12, 13])
    batch = grow(torch.as_tensor(Xb), torch.as_tensor(Ych), seeds)
    for t in range(3):
        one = grow(torch.as_tensor(Xb), torch.as_tensor(Ych[t])[None],
                   seeds[t:t + 1])
        for k in batch:
            torch.testing.assert_close(batch[k][t], one[k][0], rtol=0, atol=0)


def test_newton_tree_matches_jax():
    X, _y, sw, edges, Xb = _problem("reg", seed=4)
    rng = np.random.RandomState(1)
    g = rng.randn(X.shape[0]).astype(np.float32)
    h = (rng.rand(X.shape[0]) + 0.5).astype(np.float32)
    Ych = np.array(jt.newton_channels(jnp.asarray(g), jnp.asarray(h),
                                        jnp.asarray(sw)))
    cfg = _cfg("reg", X.shape[1], channels=3, newton=True)
    ref = jt.build_tree_kernel(hist_mode="scatter", **cfg)(
        jnp.asarray(Xb), jnp.asarray(Ych), jax.random.PRNGKey(0),
        jnp.float32(0.5))
    ours = tt.build_tree_kernel(hist_mode="scatter", **cfg)(
        torch.as_tensor(Xb), torch.as_tensor(Ych)[None], torch.tensor([0]),
        0.5)
    _assert_same_tree(ours, ref)


def test_predict_walk_matches_jax_on_a_jax_tree():
    X, y, sw, edges, Xb = _problem("clf", seed=3)
    cfg = _cfg("clf", X.shape[1])
    ref = jt.build_tree_kernel(hist_mode="scatter", **cfg)(
        jnp.asarray(Xb), jnp.asarray(_channels("clf", y, sw)),
        jax.random.PRNGKey(0))
    Xq = np.random.RandomState(9).rand(150, X.shape[1]).astype(np.float32)
    Xqb = np.array(jax_apply_bins(jnp.asarray(Xq), jnp.asarray(edges)))
    tree_t = {k: torch.as_tensor(np.array(v)) for k, v in ref.items()}
    for nodes in (False, True):
        jwalk = jt.tree_predict_kernel(4, return_nodes=nodes)
        twalk = tt.tree_predict_kernel(4, return_nodes=nodes)
        want = np.asarray(jwalk(ref, jnp.asarray(Xqb)))
        got = twalk(tree_t, torch.as_tensor(Xqb)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_single_tree_estimators_match_jax(kind):
    X, y, sw, _edges, _Xb = _problem(kind, seed=6)
    Xq = np.random.RandomState(8).rand(100, X.shape[1]).astype(np.float32)
    if kind == "clf":
        ref = jt.DecisionTreeClassifier(max_depth=4, hist_mode="scatter")
        ours = tt.DecisionTreeClassifier(max_depth=4, device="cpu")
    else:
        ref = jt.DecisionTreeRegressor(max_depth=4, hist_mode="scatter")
        ours = tt.DecisionTreeRegressor(max_depth=4, device="cpu")
    ref.fit(X, y, sample_weight=sw)
    ours.fit(X, y, sample_weight=sw)
    if kind == "clf":
        np.testing.assert_allclose(ours.predict_proba(Xq),
                                   ref.predict_proba(Xq), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ours.classes_, ref.classes_)
    np.testing.assert_allclose(ours.predict(Xq), ref.predict(Xq),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.apply(Xq), ref.apply(Xq))
    np.testing.assert_allclose(ours.feature_importances_,
                               ref.feature_importances_, rtol=1e-5)
    np.testing.assert_allclose(ours.score(X, y), ref.score(X, y), atol=1e-6)


def test_draws_shape_randomised_trees():
    """max_features and ExtraTrees draws come from the tree's seed: the
    same seed grows the same tree, another seed another one, and every
    split of a max_features=1 tree stays on a valid feature."""
    X, y, sw, _edges, Xb = _problem("clf", seed=7)
    Ych = torch.as_tensor(_channels("clf", y, sw))[None].expand(2, -1, -1)
    grow = tt.build_tree_kernel(hist_mode="scatter", **_cfg(
        "clf", X.shape[1], max_features=1, extra=True))
    a = grow(torch.as_tensor(Xb), Ych, torch.tensor([3, 3]))
    b = grow(torch.as_tensor(Xb), Ych, torch.tensor([4, 4]))
    torch.testing.assert_close(a["thr"][0], a["thr"][1], rtol=0, atol=0)
    assert not torch.equal(a["feat"], b["feat"])
    assert int(a["feat"].max()) < X.shape[1]


def test_hist_modes_resolve_and_native_raises():
    """The engine table: on the CPU ``"auto"`` is the host C engine where
    it may run (a single tree, a LocalBackend forest) and the scatter in
    a batched kernel; on the card it is K4. An explicit ``"native"``
    resolves and fits on the CPU, and raises for the card, inside a
    batched kernel and with ``n_bins=300``."""
    assert tt.resolve_hist_config("auto", "cpu") == "scatter"
    assert tt.resolve_hist_config("auto", "cpu", allow_native=True) == "native"
    assert tt.resolve_hist_config("auto", "cuda", allow_native=True) == "pallas"
    assert tt.resolve_hist_config("matmul", "cpu") == "matmul"
    assert tt.resolve_hist_config("native", "cpu", allow_native=True) \
        == "native"
    with pytest.raises(ValueError, match="card"):
        tt.resolve_hist_config("native", "cuda", allow_native=True)
    with pytest.raises(ValueError, match="batched kernel"):
        tt.resolve_hist_config("native", "cpu")
    with pytest.raises(ValueError, match="batched kernel"):
        tt.build_tree_kernel(hist_mode="native", **_cfg("clf", 3))
    with pytest.raises(ValueError, match="n_bins"):
        tt.resolve_hist_config("native", "cpu", allow_native=True,
                               n_bins=300)
    with pytest.raises(ValueError, match="hist_mode"):
        tt.build_tree_kernel(hist_mode="bogus", **_cfg("clf", 3))
    X, y, _sw, _e, _Xb = _problem("clf")
    est = tt.DecisionTreeClassifier(hist_mode="native", device="cpu").fit(X, y)
    assert est.predict_proba(X).shape == (len(X), 3)
    with pytest.raises(ValueError, match="n_bins"):
        tt.DecisionTreeClassifier(hist_mode="native", n_bins=300,
                                  device="cpu").fit(X, y)


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_pallas_engine_hands_k4_its_layout_proof_and_live_keys(kind,
                                                               monkeypatch):
    """Under ``hist_mode="pallas"`` the tree kernel gives K4, once a round,
    uint8 rows padded to 16 bytes and the proof of which channels are
    integral (classification: all of them, bootstrap counts times unit
    weights; regression: w and the count, not w*y or w*y**2), and marks a
    sample whose channels are all 0 as off the level; the tree is the
    scatter engine's."""
    calls = []

    def spy(Xb, node_key, Ych, nl, n_bins, integer=None):
        calls.append((Xb, node_key, Ych, nl, integer))
        return tt.level_histogram_ref(Xb, node_key, Ych, nl, n_bins)

    monkeypatch.setattr(tt, "level_histogram", spy)
    X, y, sw, edges, Xb = _problem(kind, seed=3)
    Ych = torch.as_tensor(_channels(kind, y, sw))[None]
    cfg = _cfg(kind, X.shape[1])
    ours = tt.build_tree_kernel(hist_mode="pallas", **cfg)(
        torch.as_tensor(Xb), Ych, torch.tensor([0]))
    plain = tt.build_tree_kernel(hist_mode="scatter", **cfg)(
        torch.as_tensor(Xb), Ych, torch.tensor([0]))
    for k in ours:
        torch.testing.assert_close(ours[k], plain[k], rtol=0, atol=0)
    assert len(calls) == cfg["max_depth"]
    dead = (Ych == 0).all(dim=-1)
    assert bool(dead.any())  # zero bootstrap counts
    for Xk, key, Yk, nl, proof in calls:
        assert Xk.dtype == torch.uint8 and Xk.stride() == (16, 1)
        assert torch.equal(Xk.long(), torch.as_tensor(Xb).long())
        assert Yk is Ych and proof is not None and proof.matches(Ych)
        assert proof.mask == (0b1111 if kind == "clf" else 0b1001)
        assert bool((key[dead] == nl).all())
    assert calls[0][4] is calls[-1][4]  # one proof a round


def test_pallas_engine_gives_no_proof_for_fractional_channels(monkeypatch):
    seen = []

    def spy(Xb, node_key, Ych, nl, n_bins, integer=None):
        seen.append(integer)
        return tt.level_histogram_ref(Xb, node_key, Ych, nl, n_bins)

    monkeypatch.setattr(tt, "level_histogram", spy)
    X, y, sw, edges, Xb = _problem("clf", seed=4)
    Ych = torch.as_tensor(_channels("clf", y, sw * 0.75))[None]
    Ych[..., -1] += 0.5  # no channel is whole: no proof at all
    tt.build_tree_kernel(hist_mode="pallas", **_cfg("clf", X.shape[1]))(
        torch.as_tensor(Xb), Ych, torch.tensor([0]))
    assert seen and all(p is None for p in seen)
