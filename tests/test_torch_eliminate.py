"""The port's feature eliminator (``skdist_tpu_torch/distribute/
eliminate.py``) against the JAX package's (``skdist_tpu/distribute/
eliminate.py``) on the CPU, on the same numpy inputs made from a seed.

The cases of ``tests/test_eliminate.py`` and the two eliminator cases of
``tests/test_asha.py``, each held to the JAX package: ``scores_`` within
1e-5 (the searches' standing tolerance: both packages run the same
float32 fits and differ in the summation order of a few sums) and equal
``best_features_``/``n_features_``. Linear estimators are pinned to
``engine="xla"`` on both sides (the JAX package's CPU ``"auto"`` is its
f64 host engine) and the JAX side runs on ``TPUBackend`` (its batched
path); trees are pinned to ``hist_mode="scatter"``, the engine of the
JAX package's batched kernels on the CPU.

The port's own contracts, bitwise: the masked operator equals the
materialised ``X * fmask`` in every product, a masked tree lane is the
lone fit of the column-zeroed X under the same edges,
``feature_mask=None`` (or all True) gives the unmasked bits, and the
compacted path equals the classic one at equal round size.
"""

import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu.distribute.adaptive import HalvingSpec as JaxHalving
from skdist_tpu.distribute.eliminate import DistFeatureEliminator as JaxElim
from skdist_tpu.distribute.multiclass import DistOneVsRestClassifier as JaxOvR
from skdist_tpu.models import (
    DecisionTreeClassifier as JaxTree,
    DistHistGradientBoostingClassifier as JaxGBDT,
    GaussianNB as JaxGNB,
    LinearSVC as JaxSVC,
    LogisticRegression as JaxLR,
    MultinomialNB as JaxMNB,
    RandomForestClassifier as JaxForest,
    RidgeClassifier as JaxRidge,
    SGDClassifier as JaxSGD,
)
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import (
    CUDABackend,
    DistFeatureEliminator,
    DistHistGradientBoostingClassifier,
    DistOneVsRestClassifier,
    GaussianNB,
    HalvingSpec,
    LinearSVC,
    LocalBackend,
    LogisticRegression,
    MultinomialNB,
    RidgeClassifier,
    SGDClassifier,
    convert,
)
from skdist_tpu_torch.distribute import eliminate as elim_mod
from skdist_tpu_torch.distribute.adaptive import RungKilledWarning
from skdist_tpu_torch.models.forest import RandomForestClassifier
from skdist_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    build_tree_kernel,
    classification_channels,
)
from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges
from skdist_tpu_torch.sparse import (
    LinearOperator,
    MaskedLinearOperator,
    pack_csr_rows,
    PackedX,
)

CPU = CUDABackend(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small solves: the
    tier-1 run shares the host's cores among its workers, and torch's
    default of a thread a core makes each small op wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planted_data():
    """5 features: column 0 is noise, columns 1-4 carry the label (the
    JAX package's test data)."""
    rng = np.random.RandomState(0)
    n = 300
    y = rng.randint(0, 2, size=n)
    X = np.zeros((n, 5), dtype=np.float32)
    X[:, 0] = rng.normal(size=n)
    for j in range(1, 5):
        X[:, j] = y * 2.0 + rng.normal(scale=0.8, size=n)
    return X, y


def _race_data():
    """16 features, 3 overlapping classes on the first 8 and 8 wide
    noise columns (``tests/test_asha.py``'s eliminator data)."""
    rng = np.random.RandomState(0)
    X = np.vstack([
        rng.normal(loc=c, scale=1.0, size=(60, 8)) for c in (-0.8, 0.0, 0.8)
    ]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    perm = rng.permutation(len(y))
    X, y = X[perm], y[perm]
    Xw = np.hstack(
        [X, rng.normal(scale=3.0, size=(X.shape[0], 8)).astype(np.float32)])
    return Xw, y


def _clf_data():
    rng = np.random.RandomState(0)
    X = np.vstack([
        rng.normal(loc=c, scale=0.5, size=(60, 8)) for c in (-2.0, 0.0, 2.0)
    ]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def _same(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.scores_, ref.scores_, atol=atol)
    np.testing.assert_array_equal(port.best_features_, ref.best_features_)
    assert port.n_features_ == ref.n_features_


def _accuracy(est, X, y):
    """A host scorer callable: it sends both packages down their generic
    paths."""
    return float(np.mean(est.predict(X) == y))


# ---------------------------------------------------------------------------
# the masked views, against a materialised X * fmask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_masked_operator_equals_materialised(packed, fit_intercept):
    rng = np.random.RandomState(0)
    n, d, T, k = 40, 7, 3, 2
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.rand(n, d) < 0.5] = 0.0
    fmask = torch.as_tensor(rng.rand(T, d) < 0.6)
    W = torch.as_tensor(rng.normal(size=(T, d + int(fit_intercept), k)),
                        dtype=torch.float32)
    Xt = torch.as_tensor(X)
    if packed:
        idx, val = pack_csr_rows(sp.csr_matrix(X))
        base = PackedX(torch.as_tensor(idx), torch.as_tensor(val), d)
    else:
        base = Xt
    view = MaskedLinearOperator(LinearOperator(base, fit_intercept), fmask)
    ref = [LinearOperator(Xt * fmask[t].float(), fit_intercept)
           for t in range(T)]
    # matvec, and its gradient: a masked weight gets none
    Wg = W.clone().requires_grad_(True)
    z = view.matvec(Wg)
    g = torch.autograd.grad(z.square().sum(), Wg)[0]
    for t in range(T):
        Wr = W[t].clone().requires_grad_(True)
        zr = ref[t].matvec(Wr)
        gr = torch.autograd.grad(zr.square().sum(), Wr)[0]
        torch.testing.assert_close(z[t], zr, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(g[t], gr, atol=1e-4, rtol=1e-5)
        assert (g[t][:d][~fmask[t]] == 0).all()
    # rmatvec
    r = torch.as_tensor(rng.normal(size=(T, n, k)), dtype=torch.float32)
    rm = view.rmatvec(r)
    for t in range(T):
        torch.testing.assert_close(rm[t], ref[t].rmatvec(r[t]), atol=1e-5,
                                   rtol=1e-5)
    # the ridge normal equations
    sw = torch.as_tensor(rng.rand(T, n), dtype=torch.float32)
    Y = torch.as_tensor(rng.normal(size=(n, k)), dtype=torch.float32)
    G, b = view.weighted_gram_rhs(sw, Y)
    for t in range(T):
        Gr, br = ref[t].weighted_gram_rhs(sw[t], Y)
        torch.testing.assert_close(G[t], Gr, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(b[t], br, atol=1e-4, rtol=1e-5)
    # the SGD row forms on a (T, B) mini-batch a lane
    rows_idx = torch.as_tensor(rng.randint(0, n, size=(T, 5)))
    rows = view.row_batch(rows_idx)
    zb = view.row_matvec(rows, W)
    gz = torch.as_tensor(rng.normal(size=(T, 5, k)), dtype=torch.float32)
    gb = view.row_rmatvec(rows, gz)
    for t in range(T):
        Xa = ref[t].Xa
        torch.testing.assert_close(zb[t], Xa[rows_idx[t]] @ W[t], atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(gb[t], Xa[rows_idx[t]].T @ gz[t],
                                   atol=1e-5, rtol=1e-5)


def _tree_round(X, y, masks, **kw):
    edges = quantile_bin_edges(X, 16)
    Xb = apply_bins(torch.as_tensor(X), edges)
    grow = build_tree_kernel(
        n_features=X.shape[1], n_bins=16, channels=3, max_depth=4,
        max_features=kw.get("max_features", X.shape[1]), min_samples_split=2,
        min_samples_leaf=1, min_impurity_decrease=0.0,
        extra=kw.get("extra", False), classification=True,
        hist_mode="scatter")
    T = len(masks)
    sw = torch.ones((T, X.shape[0]))
    Ych = classification_channels(torch.as_tensor(y), sw, 2)
    seeds = torch.arange(T)
    return grow, edges, Xb, Ych, seeds


@pytest.mark.parametrize("kw", [{}, {"max_features": 3},
                                {"extra": True}])
def test_tree_lanes_equal_lone_fits_of_zeroed_columns(kw):
    """A masked lane of one ``build_tree_kernel`` round is bitwise the
    lone fit over its X with the masked columns zeroed and binned under
    the whole X's edges (the JAX package's ``X * fmask``); no lane
    splits a masked feature; an all-True mask and None give the
    unmasked bits."""
    X, y = _planted_data()
    rng = np.random.RandomState(1)
    masks = rng.rand(4, 5) < 0.6
    masks[0] = True
    grow, edges, Xb, Ych, seeds = _tree_round(X, y, masks, **kw)
    fm = torch.as_tensor(masks)
    out = grow(Xb, Ych, seeds, feature_mask=fm)
    plain = grow(Xb, Ych, seeds)
    full = grow(Xb, Ych, seeds, feature_mask=torch.ones_like(fm))
    for key in out:
        torch.testing.assert_close(plain[key], full[key], atol=0, rtol=0)
    for t in range(len(masks)):
        Xz = apply_bins(torch.as_tensor(X * masks[t]), edges)
        lone = grow(Xz, Ych[t:t + 1], seeds[t:t + 1])
        for key in out:
            torch.testing.assert_close(out[key][t], lone[key][0], atol=0,
                                       rtol=0)
        used = out["feat"][t][out["is_split"][t]].long()
        assert fm[t][used].all()
    for key in ("feat", "thr", "is_split"):
        torch.testing.assert_close(out[key][0], plain[key][0], atol=0,
                                   rtol=0)
    with pytest.raises(ValueError, match="feature_mask"):
        grow(Xb, Ych, seeds, feature_mask=fm[:2])


# ---------------------------------------------------------------------------
# the cases of tests/test_eliminate.py, against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted_pair():
    X, y = _planted_data()
    ref = JaxElim(JaxLR(max_iter=100, engine="xla"), backend=TPUBackend(),
                  min_features_to_select=4, cv=3, scoring="accuracy").fit(X, y)
    port = DistFeatureEliminator(
        LogisticRegression(max_iter=100, engine="xla", device="cpu"),
        min_features_to_select=4, cv=3, scoring="accuracy").fit(X, y)
    return X, y, ref, port


def test_fit_eliminates_junk_feature(planted_pair):
    X, y, ref, port = planted_pair
    _same(port, ref)
    assert list(port.best_features_) == [1, 2, 3, 4]
    assert port.n_features_ == 4
    assert abs(port.best_score_ - ref.best_score_) < 1e-5
    assert port.score(X, y) > 0.9
    assert port.round_stats_[0]["mode"] == "classic"
    # the round sizer bills the mask leaf and the masked products
    st = port.round_stats_[0]
    from skdist_tpu_torch.models.linear import _freeze

    est = LogisticRegression(max_iter=100, engine="xla", device="cpu")
    _, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    assert st["bytes_per_task"] > LogisticRegression._batched_task_bytes(
        meta, static, len(y)) + 4 * X.shape[1]
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X),
                               atol=1e-5)


def test_best_estimator_alias_and_pickle(planted_pair):
    X, _y, _ref, port = planted_pair
    assert port.best_estimator_ is port.estimator_
    assert port.backend is None
    loaded = pickle.loads(pickle.dumps(port))
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    np.testing.assert_array_equal(loaded.decision_function(X),
                                  port.decision_function(X))


def test_generic_path_matches_batched(planted_pair):
    """The host scorer's generic path against the batched grid of
    ``planted_pair`` (its settings; two host threads)."""
    X, y, _ref, batched = planted_pair
    kw = dict(min_features_to_select=4, cv=3)
    generic = DistFeatureEliminator(
        LogisticRegression(max_iter=100, engine="xla", device="cpu"),
        scoring=_accuracy, n_jobs=2, **kw).fit(X, y)
    ref = JaxElim(JaxLR(max_iter=100, engine="xla"), backend=TPUBackend(),
                  scoring=_accuracy, **kw).fit(X, y)
    assert generic.round_stats_[0]["mode"] == "generic"
    np.testing.assert_allclose(batched.scores_, generic.scores_, atol=1e-5)
    assert list(batched.best_features_) == list(generic.best_features_)
    _same(generic, ref)


def test_nan_scores_never_win():
    X, y = _planted_data()

    class ExplodingOnNarrow(LogisticRegression):
        def fit(self, X, y=None, sample_weight=None):
            if X.shape[1] < 5:
                raise RuntimeError("boom")
            return super().fit(X, y, sample_weight=sample_weight)

    class ExplodingOnFolds(LogisticRegression):
        def fit(self, X, y=None, sample_weight=None):
            if X.shape[0] < 300:
                raise RuntimeError("boom")
            return super().fit(X, y, sample_weight=sample_weight)

    kw = dict(min_features_to_select=2, cv=3, scoring=_accuracy)
    with pytest.warns(Warning):
        fe = DistFeatureEliminator(
            ExplodingOnNarrow(max_iter=30, engine="xla", device="cpu"),
            **kw).fit(X, y)
    assert len(fe.best_features_) == 5
    assert not np.isnan(fe.best_score_)
    assert np.isnan(fe.scores_[1:]).all()
    with pytest.warns(Warning):
        with pytest.raises(RuntimeError, match="feature-set fits failed"):
            DistFeatureEliminator(
                ExplodingOnFolds(max_iter=30, engine="xla", device="cpu"),
                **kw).fit(X, y)


def test_nested_in_ovr_stays_wrapped():
    """A fitted eliminator inside one-vs-rest is not unwrapped to its
    inner model, which was refit on a feature subset and needs the
    eliminator's column cut at predict time."""
    X, y = _planted_data()
    ovr = DistOneVsRestClassifier(
        DistFeatureEliminator(
            LogisticRegression(max_iter=100, engine="xla", device="cpu"),
            min_features_to_select=4, cv=3, scoring="accuracy"),
        backend=CPU).fit(X, y)
    ref = JaxOvR(JaxElim(JaxLR(max_iter=100, engine="xla"),
                         backend=TPUBackend(), min_features_to_select=4,
                         cv=3, scoring="accuracy")).fit(X, y)
    assert all(isinstance(e, DistFeatureEliminator) for e in ovr.estimators_)
    assert len(ovr.estimators_) == len(ref.estimators_)
    for e, r in zip(ovr.estimators_, ref.estimators_):
        _same(e, r)
    np.testing.assert_array_equal(ovr.predict(X), ref.predict(X))
    assert ovr.score(X, y) > 0.9


def test_sklearn_estimator_path():
    from sklearn.linear_model import LogisticRegression as SkLR

    X, y = _planted_data()
    fe = DistFeatureEliminator(SkLR(max_iter=200), backend=LocalBackend(
        device="cpu"), min_features_to_select=4, cv=3).fit(X, y)
    ref = JaxElim(SkLR(max_iter=200), min_features_to_select=4,
                  cv=3).fit(X, y)
    assert list(fe.best_features_) == [1, 2, 3, 4]
    _same(fe, ref, atol=0)


def test_single_tree_batched_elimination(monkeypatch):
    """A decision tree rides the batched column-mask path (K4's plain
    version here); the generic path is disabled so that a silent
    fallback fails. Scores and the refit tree equal the JAX package's."""
    import skdist_tpu.distribute.eliminate as jax_elim_mod

    X, y = _planted_data()
    boom = (lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("fell back to the generic path")))
    monkeypatch.setattr(elim_mod, "_fit_and_score", boom)
    monkeypatch.setattr(jax_elim_mod, "_fit_and_score", boom)
    kw = dict(min_features_to_select=3, cv=2, scoring="accuracy")
    fe = DistFeatureEliminator(
        DecisionTreeClassifier(max_depth=4, hist_mode="scatter",
                               device="cpu"), **kw).fit(X, y)
    ref = JaxElim(JaxTree(max_depth=4, hist_mode="scatter"),
                  backend=TPUBackend(), **kw).fit(X, y)
    assert fe.round_stats_[0]["mode"] == "classic"
    _same(fe, ref)
    assert fe.best_score_ > 0.8
    for key in ("feat", "thr", "is_split"):
        np.testing.assert_array_equal(fe.estimator_._params[key],
                                      ref.estimator_._params[key])
    np.testing.assert_allclose(fe.predict_proba(X), ref.predict_proba(X),
                               atol=1e-6)


def test_forest_generic_path():
    X, y = _planted_data()
    kw = dict(n_estimators=2, max_depth=4, random_state=0, bootstrap=False,
              max_features=None)
    fe = DistFeatureEliminator(
        RandomForestClassifier(hist_mode="scatter", device="cpu", **kw),
        backend=LocalBackend(device="cpu"), min_features_to_select=4, cv=2,
        scoring="accuracy").fit(X, y)
    ref = JaxElim(JaxForest(hist_mode="scatter", **kw),
                  min_features_to_select=4, cv=2,
                  scoring="accuracy").fit(X, y)
    assert fe.round_stats_[0]["mode"] == "generic"
    _same(fe, ref)
    assert 0 not in set(fe.best_features_) or fe.n_features_ == 5


def test_step_and_scores_shape():
    X, y = _planted_data()
    kw = dict(min_features_to_select=1, step=2, cv=2, scoring="accuracy")
    fe = DistFeatureEliminator(
        LogisticRegression(max_iter=50, engine="xla", device="cpu"),
        **kw).fit(X, y)
    ref = JaxElim(JaxLR(max_iter=50, engine="xla"), backend=TPUBackend(),
                  **kw).fit(X, y)
    assert len(fe.scores_) == 3
    _same(fe, ref)
    frac = DistFeatureEliminator(
        LogisticRegression(max_iter=50, engine="xla", device="cpu"),
        min_features_to_select=1, step=0.4, cv=2,
        scoring="accuracy").fit(X, y)
    assert len(frac.scores_) == 3  # int(0.4 * 5) = 2 a set


def test_rejects_bad_input():
    X, y = _planted_data()
    with pytest.raises(ValueError):
        DistFeatureEliminator(LogisticRegression(device="cpu")).fit(
            X[:, :1], y)
    with pytest.raises(ValueError, match="Step"):
        DistFeatureEliminator(LogisticRegression(device="cpu"),
                              step=0).fit(X, y)


# ---------------------------------------------------------------------------
# the batched families under column masks
# ---------------------------------------------------------------------------

_FAMILIES = {
    "logreg_multinomial": (
        lambda: LogisticRegression(max_iter=60, engine="xla", device="cpu"),
        lambda: JaxLR(max_iter=60, engine="xla"), "clf"),
    "logreg_balanced_no_intercept": (
        lambda: LogisticRegression(max_iter=60, engine="xla",
                                   class_weight="balanced",
                                   fit_intercept=False, device="cpu"),
        lambda: JaxLR(max_iter=60, engine="xla", class_weight="balanced",
                      fit_intercept=False), "planted"),
    "linear_svc": (
        lambda: LinearSVC(C=0.03, tol=1e-2, max_iter=60, engine="xla",
                          device="cpu"),
        lambda: JaxSVC(C=0.03, tol=1e-2, max_iter=60, engine="xla"),
        "planted"),
    "sgd_elasticnet": (
        lambda: SGDClassifier(loss="log_loss", penalty="elasticnet",
                              max_iter=5, shuffle=False, device="cpu"),
        lambda: JaxSGD(loss="log_loss", penalty="elasticnet", max_iter=5,
                       shuffle=False), "clf"),
    "ridge_classifier": (
        lambda: RidgeClassifier(alpha=1.0, device="cpu"),
        lambda: JaxRidge(alpha=1.0), "clf"),
    "multinomial_nb": (
        lambda: MultinomialNB(alpha=0.5, device="cpu"),
        lambda: JaxMNB(alpha=0.5), "counts"),
}


def _family_data(kind):
    if kind == "planted":
        return _planted_data()
    X, y = _clf_data()
    if kind == "counts":
        X = np.floor(np.abs(X) * 3.0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_batched_family_matches_jax(family):
    """Every column reduction of a family's path sees the masked columns
    as zeros: the logits and margins (LogisticRegression with a balanced
    class weight and no intercept, LinearSVC, SGD with the elastic-net
    truncation), the ridge gram and right-hand side, MultinomialNB's
    smoothing denominator (which keeps counting all d columns)."""
    port_est, jax_est, kind = _FAMILIES[family]
    X, y = _family_data(kind)
    kw = dict(min_features_to_select=2, step=2, cv=3, scoring="accuracy")
    fe = DistFeatureEliminator(port_est(), **kw).fit(X, y)
    ref = JaxElim(jax_est(), backend=TPUBackend(), **kw).fit(X, y)
    assert fe.round_stats_[0]["mode"] == "classic"
    _same(fe, ref)
    np.testing.assert_array_equal(fe.predict(X), ref.predict(X))


def test_no_ranking_attribute_raises():
    """GaussianNB and the boosting models expose neither ``coef_`` nor
    ``feature_importances_``: both packages refuse at the ranking
    step."""
    X, y = _planted_data()
    for port_est, jax_est in (
            (GaussianNB(device="cpu"), JaxGNB()),
            (DistHistGradientBoostingClassifier(max_iter=3, max_depth=2,
                                                device="cpu"),
             JaxGBDT(max_iter=3, max_depth=2))):
        with pytest.raises(RuntimeError, match="coef_"):
            DistFeatureEliminator(port_est, cv=2).fit(X, y)
        with pytest.raises(RuntimeError, match="coef_"):
            JaxElim(jax_est, backend=TPUBackend(), cv=2).fit(X, y)


def test_sparse_input_matches_dense():
    """CSR input densifies onto the batched path and scores as the dense
    array does; the refit and prediction take the column-cut CSR."""
    X, y = _planted_data()
    kw = dict(min_features_to_select=2, cv=3, scoring="accuracy")
    dense = DistFeatureEliminator(
        LogisticRegression(max_iter=50, engine="xla", device="cpu"),
        **kw).fit(X, y)
    csr = DistFeatureEliminator(
        LogisticRegression(max_iter=50, engine="xla", device="cpu"),
        **kw).fit(sp.csr_matrix(X), y)
    np.testing.assert_array_equal(dense.scores_, csr.scores_)
    np.testing.assert_array_equal(dense.best_features_, csr.best_features_)
    np.testing.assert_allclose(csr.predict_proba(sp.csr_matrix(X)),
                               dense.predict_proba(X), atol=1e-6)


# ---------------------------------------------------------------------------
# the compacted path and the ASHA race (tests/test_asha.py's cases)
# ---------------------------------------------------------------------------

def _race_est():
    return LogisticRegression(max_iter=60, tol=1e-6, engine="xla",
                              device="cpu")


RACE_KW = dict(step=1, cv=3, min_features_to_select=6, scoring="accuracy")


@pytest.fixture(scope="module")
def race():
    X, y = _race_data()
    ref = JaxElim(JaxLR(max_iter=60, tol=1e-6, engine="xla"),
                  backend=TPUBackend(), **RACE_KW).fit(X, y)
    exhaustive = DistFeatureEliminator(_race_est(), partitions=3,
                                       **RACE_KW).fit(X, y)
    return X, y, ref, exhaustive


def test_compacted_matches_classic_and_jax(race, monkeypatch):
    X, y, ref, compacted = race
    assert compacted.round_stats_[0]["mode"] == "compacted"
    _same(compacted, ref)
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    classic = DistFeatureEliminator(_race_est(), partitions=3,
                                    **RACE_KW).fit(X, y)
    assert classic.round_stats_[0]["mode"] == "classic"
    np.testing.assert_array_equal(classic.scores_, compacted.scores_)


def test_compacted_refill_matches_resident(race, monkeypatch):
    """Refilled lanes restart under their own column masks."""
    X, y, _ref, resident = race
    monkeypatch.setattr(CUDABackend, "round_cap",
                        lambda self, *a, **k: 6)
    refill = DistFeatureEliminator(_race_est(), partitions=3,
                                   **RACE_KW).fit(X, y)
    st = refill.round_stats_[0]
    assert st["regime"] == "refill" and st["refilled_lanes"] > 0
    np.testing.assert_array_equal(refill.scores_, resident.scores_)


@pytest.fixture(scope="module")
def race_adaptive(race):
    X, y, _ref, _exhaustive = race
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        ad = DistFeatureEliminator(_race_est(),
                                   adaptive=HalvingSpec(eta=2),
                                   **RACE_KW).fit(X, y)
    jad = JaxElim(JaxLR(max_iter=60, tol=1e-6, engine="xla"),
                  backend=TPUBackend(), adaptive=JaxHalving(eta=2),
                  **RACE_KW).fit(X, y)
    return ad, jad, ws


def test_eliminate_adaptive(race, race_adaptive):
    X, y, ref, exhaustive = race
    ad, jad, ws = race_adaptive
    assert any(issubclass(w.category, RungKilledWarning) for w in ws)
    assert (ad.rung_ >= 0).any() and (ad.rung_ == -1).any()
    assert np.isnan(np.asarray(ad.scores_)[ad.rung_ >= 0]).all()
    np.testing.assert_array_equal(ad.best_features_, exhaustive.best_features_)
    np.testing.assert_array_equal(ad.best_features_, ref.best_features_)
    assert ad.rung_[int(np.nanargmax(np.asarray(ad.scores_)))] == -1
    np.testing.assert_array_equal(ad.rung_, jad.rung_)
    np.testing.assert_allclose(ad.scores_, jad.scores_, atol=1e-5)


def test_eliminate_adaptive_not_engaged_warns():
    X, y = _clf_data()  # 4 sets x 3 folds: below the compaction floor
    with pytest.warns(UserWarning, match="could not engage"):
        el = DistFeatureEliminator(
            LogisticRegression(max_iter=40, engine="xla", device="cpu"),
            step=2, cv=3, scoring="accuracy",
            adaptive=HalvingSpec(eta=2)).fit(X, y)
    assert np.all(el.rung_ == -1)


# ---------------------------------------------------------------------------
# conversion from the JAX package
# ---------------------------------------------------------------------------

def test_eliminator_from_reference(planted_pair, race, race_adaptive):
    X, _y, ref, _port = planted_pair
    conv = convert.eliminator_from_reference(ref, device="cpu")
    _same(conv, ref, atol=0)
    assert conv.best_score_ == ref.best_score_
    np.testing.assert_allclose(conv.predict_proba(X), ref.predict_proba(X),
                               atol=1e-6)
    np.testing.assert_array_equal(conv.predict(X), ref.predict(X))
    Xr, _yr, _ref, _exhaustive = race
    _ad, jad, _ws = race_adaptive
    conv = convert.model_from_reference(jad, device="cpu")
    np.testing.assert_array_equal(conv.rung_, jad.rung_)
    assert isinstance(conv.adaptive, HalvingSpec)
    np.testing.assert_array_equal(conv.predict(Xr), jad.predict(Xr))
    assert isinstance(pickle.loads(pickle.dumps(conv)), DistFeatureEliminator)
