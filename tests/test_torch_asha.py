"""The port's adaptive (ASHA) search on the CPU, against the JAX
package's: ``HalvingSpec`` and its validation, ``RungController`` on the
same arrays as the JAX package's, ``resolve_rung_scorer``, and
``DistGridSearchCV(adaptive=...)`` on ``CUDABackend(device="cpu")``
against the JAX package's on ``TPUBackend()`` over the conftest CPU
mesh (mirroring tests/test_asha.py):

- ``eta=inf`` scores every rung and kills nothing: ``cv_results_`` are
  bitwise those of ``adaptive=None`` (slice sizes and both X forms);
- ``eta=3`` kills the same candidates at the same rungs as the JAX
  package (the ``rung_`` column), survivors score as the JAX package's
  to 1e-5 (the standing tolerance of tests/test_torch_search.py), and
  killed rows follow the ``error_score`` rules (numeric, NaN, and
  ``'raise'`` mapped to NaN) with one ``RungKilledWarning``;
- where the rungs cannot run (a grid under the compaction floor, a
  metric with no device kernel for the label set, the refill regime
  that does not hold every lane at once) the search warns and runs
  exhaustively, with ``adaptive=None``'s results.
"""

import warnings

import numpy as np
import pytest
import torch

from bench import make_20news_sparse
from skdist_tpu.distribute.adaptive import HalvingSpec as JaxHalving
from skdist_tpu.distribute.search import DistGridSearchCV as JaxGrid
from skdist_tpu.metrics import DEVICE_SCORERS as JAX_SCORERS
from skdist_tpu.metrics import resolve_rung_scorer as jax_resolve_rung
from skdist_tpu.models import LogisticRegression as JaxLR
from skdist_tpu.parallel import RungController as JaxRung
from skdist_tpu.parallel import TPUBackend
from skdist_tpu_torch import CUDABackend
from skdist_tpu_torch.base import clone
from skdist_tpu_torch.distribute.adaptive import (
    HalvingSpec,
    RungKilledWarning,
    rung_per_candidate,
)
from skdist_tpu_torch.distribute.search import DistGridSearchCV as TorchGrid
from skdist_tpu_torch.metrics import DEVICE_SCORERS
from skdist_tpu_torch.metrics import resolve_rung_scorer
from skdist_tpu_torch.models import LogisticRegression as TorchLR
from skdist_tpu_torch.parallel import RungController

#: 9 C x 3 folds = 27 tasks (over the compaction floor of 24), in the
#: well-conditioned range of tests/test_torch_search.py; tol=1e-4 keeps
#: lanes live past the first rungs
CS = list(np.logspace(-2, 0, 9))
EST = dict(tol=1e-4, max_iter=100)
#: the runs held to adaptive=None bitwise need no long solves
SHORT = dict(tol=1e-4, max_iter=40)


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


def _form(data, form):
    X, y = data
    return (X.toarray() if form == "dense" else X), y


@pytest.fixture(scope="module")
def base(data):
    """``base(form)``: adaptive=None on the compacted path at SHORT,
    fitted once a form for the module."""
    fitted = {}

    def get(form):
        if form not in fitted:
            fitted[form] = _torch(*_form(data, form), est=SHORT)[0]
        return fitted[form]

    return get


def _nontime_cols(cv):
    return [c for c in cv if c != "params" and "_time" not in c]


def _torch(X, y, adaptive=None, grid=None, est=EST, **kw):
    backend = kw.pop("backend", None) or CUDABackend(device="cpu")
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        gs = TorchGrid(TorchLR(device="cpu", **est), grid or {"C": CS}, cv=3,
                       scoring=kw.pop("scoring", "f1_weighted"),
                       backend=backend, refit=False, adaptive=adaptive,
                       **kw).fit(X, y)
    return gs, ws


def _jax(X, y, adaptive=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxGrid(JaxLR(engine="xla", **EST), {"C": CS}, cv=3,
                       scoring="f1_weighted", backend=TPUBackend(),
                       refit=False, adaptive=adaptive, **kw).fit(X, y)


# ---------------------------------------------------------------------------
# HalvingSpec, RungController, resolve_rung_scorer
# ---------------------------------------------------------------------------

def test_halvingspec_validation():
    for bad in (dict(eta=1.0), dict(eta=0.5), dict(eta=float("nan")),
                dict(min_slices=0), dict(metric=123)):
        with pytest.raises(ValueError):
            HalvingSpec(**bad)
        with pytest.raises(ValueError):
            JaxHalving(**bad)
    for kw in (dict(), dict(eta=float("inf")), dict(eta=2.5, min_slices=3,
                                                    metric="accuracy")):
        assert HalvingSpec(**kw).get_params() == JaxHalving(**kw).get_params()
        assert repr(HalvingSpec(**kw)) == repr(JaxHalving(**kw))


def test_adaptive_validated_at_fit_and_seen_by_get_params(data):
    X, y = data
    with pytest.raises(ValueError, match="HalvingSpec"):
        _torch(X, y, adaptive="eta=3")
    spec = HalvingSpec(eta=3)
    gs = TorchGrid(TorchLR(device="cpu"), {"C": CS}, adaptive=spec)
    assert gs.get_params()["adaptive"] is spec
    assert gs.get_params()["adaptive__eta"] == 3.0
    assert clone(gs).adaptive.get_params() == spec.get_params()


def _both_rungs(*args, **kw):
    return RungController(*args, **kw), JaxRung(*args, **kw)


def _same_decisions(ours, theirs, ids, scores, slice_idx):
    k1 = ours.decide(ids, scores, slice_idx)
    k2 = theirs.decide(ids, scores, slice_idx)
    np.testing.assert_array_equal(k1, k2)
    assert ours.killed == theirs.killed and ours.history == theirs.history
    return k1


def test_rung_controller_groups_and_ties():
    # 6 groups x 2 lanes; eta=3 keeps ceil(6/3)=2 groups by mean score
    groups = np.repeat(np.arange(6), 2)
    ours, theirs = _both_rungs(eta=3, every=1, groups=groups)
    scores = np.repeat([0.9, 0.1, 0.9, 0.5, 0.3, 0.2], 2)
    killed = _same_decisions(ours, theirs, np.arange(12), scores, 1)
    # groups 0 and 2 tie at 0.9: both kept; all others die
    assert sorted(np.unique(groups[killed])) == [1, 3, 4, 5]
    assert ours.history[0]["n_killed"] == 8
    # a later rung over the survivors: ties break toward the lower group
    killed2 = _same_decisions(ours, theirs, np.array([0, 1, 4, 5]),
                              np.array([0.7, 0.7, 0.7, 0.7]), 2)
    assert sorted(np.unique(groups[killed2])) == [2]
    ours.reset()
    assert ours.killed == {} and ours.history == [] and ours.active
    ours.deactivate()
    assert ours.active is False


def test_rung_controller_fractional_eta():
    """eta=1.5 keeps ceil(6 / 1.5) = 4 lanes, not int(1.5) = 1's all."""
    ours, theirs = _both_rungs(eta=1.5, every=1)
    killed = _same_decisions(ours, theirs, np.arange(6),
                             np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6]), 1)
    assert sorted(killed.tolist()) == [0, 1]


def test_rung_controller_nonfinite_and_inf_eta():
    ours, theirs = _both_rungs(eta=2, every=1)
    killed = _same_decisions(ours, theirs, np.arange(4),
                             np.array([0.5, np.nan, 0.6, np.inf]), 1)
    assert 1 in killed  # NaN ranks below every finite score
    ours, theirs = _both_rungs(eta=float("inf"), every=2)
    assert not ours.due(1) and ours.due(2)
    assert _same_decisions(ours, theirs, np.arange(4),
                           np.array([1, 2, 3, 4.0]), 2).size == 0
    assert ours.history[0]["n_live"] == 4  # scored, nothing killed
    for bad in (dict(eta=1.0), dict(every=0)):
        with pytest.raises(ValueError):
            RungController(**bad)


def test_resolve_rung_scorer_matches_jax():
    def spec(table, name, out="score"):
        return (out, name, table[name][0], table[name][1])

    classes = np.arange(5)
    for metric, refit, names in [
            ("auto", True, ["f1_weighted"]),
            ("auto", "accuracy", ["f1_weighted", "accuracy"]),
            ("accuracy", True, ["f1_weighted"]),
            ("neg_log_loss", True, ["f1_weighted"]),
            ("roc_auc", True, ["f1_weighted"]),
            ("r2", True, ["f1_weighted"]),
            ("no_such_metric", True, ["f1_weighted"])]:
        outs = ["score"] if len(names) == 1 else names
        ours = resolve_rung_scorer(
            metric, [spec(DEVICE_SCORERS, n, o) for n, o in zip(names, outs)],
            refit, classes, est_cls=TorchLR)
        theirs = jax_resolve_rung(
            metric, [spec(JAX_SCORERS, n, o) for n, o in zip(names, outs)],
            refit, classes, est_cls=JaxLR)
        assert (ours is None) == (theirs is None), metric
        if ours is not None:
            assert (ours[0], ours[1], ours[3]) == \
                (theirs[0], theirs[1], theirs[3])


def test_rung_per_candidate():
    np.testing.assert_array_equal(
        rung_per_candidate(4, 3, {0: 0, 1: 0, 2: 0, 9: 1, 10: 2}),
        [0, -1, -1, 2])


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slice_iters", ["", "3", "17"])
@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_inf_eta_is_bitwise_adaptive_none(data, base, monkeypatch,
                                          slice_iters, form):
    """eta=inf scores every rung and kills nothing: cv_results_ are
    bitwise adaptive=None's (the rung reads carries, never writes),
    whatever the slice size."""
    base = base(form)
    if slice_iters:
        monkeypatch.setenv("SKDIST_SLICE_ITERS", slice_iters)
    inf, ws = _torch(*_form(data, form), est=SHORT,
                     adaptive=HalvingSpec(eta=float("inf")))
    st = inf.round_stats_[0]
    assert st["mode"] == "compacted" and st["rung_history"]
    assert st["retired_rung"] == 0
    assert not any(issubclass(w.category, RungKilledWarning) for w in ws)
    for col in _nontime_cols(base.cv_results_):
        np.testing.assert_array_equal(np.asarray(base.cv_results_[col]),
                                      np.asarray(inf.cv_results_[col]),
                                      err_msg=col)
    np.testing.assert_array_equal(inf.cv_results_["rung_"], -1)


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_kills_match_jax(data, form):
    """eta=3 kills the same candidates at the same rungs as the JAX
    package; survivors score as its survivors do."""
    X, y = _form(data, form)
    tg, ws = _torch(X, y, adaptive=HalvingSpec(eta=3))
    jg = _jax(X, y, adaptive=JaxHalving(eta=3))
    rung = np.asarray(tg.cv_results_["rung_"])
    np.testing.assert_array_equal(rung, jg.cv_results_["rung_"])
    assert (rung >= 0).sum() >= len(CS) // 2
    mean = np.asarray(tg.cv_results_["mean_test_score"])
    assert np.all(np.isnan(mean[rung >= 0]))
    surv = rung == -1
    np.testing.assert_allclose(
        mean[surv], np.asarray(jg.cv_results_["mean_test_score"])[surv],
        atol=1e-5)
    np.testing.assert_array_equal(tg.cv_results_["rank_test_score"],
                                  jg.cv_results_["rank_test_score"])
    kills = [w for w in ws if issubclass(w.category, RungKilledWarning)]
    assert len(kills) == 1
    st = tg.round_stats_[0]
    assert st["retired_rung"] == 3 * (rung >= 0).sum()
    assert st["retired_rung"] + st["retired_convergence"] == 3 * len(CS)
    assert sum(h["n_killed"] for h in st["rung_history"]) == \
        st["retired_rung"]
    assert (np.asarray(st["lane_status"]) == 3).sum() == st["retired_rung"]


@pytest.mark.parametrize("error_score", [0.25, np.nan, "raise"])
def test_killed_rows_follow_error_score(data, error_score):
    """A numeric error_score substitutes for a killed row's scores;
    np.nan and 'raise' record NaN (a kill is not a failed fit), as in
    the JAX package."""
    X, y = data
    tg, _ = _torch(X, y, adaptive=HalvingSpec(eta=3),
                   error_score=error_score, return_train_score=True)
    jg = _jax(X, y, adaptive=JaxHalving(eta=3), error_score=error_score,
              return_train_score=True)
    rung = np.asarray(tg.cv_results_["rung_"])
    killed = rung >= 0
    assert killed.any()
    for col in ("mean_test_score", "split0_test_score", "mean_train_score"):
        ours = np.asarray(tg.cv_results_[col])[killed]
        np.testing.assert_array_equal(
            ours, np.asarray(jg.cv_results_[col])[killed])
        if error_score == 0.25:
            np.testing.assert_array_equal(ours, 0.25)
        else:
            assert np.all(np.isnan(ours))


def _assert_exhaustive(gs, ws, base):
    assert any("could not engage" in str(w.message) for w in ws)
    np.testing.assert_array_equal(gs.cv_results_["rung_"], -1)
    for col in _nontime_cols(base.cv_results_):
        np.testing.assert_array_equal(np.asarray(base.cv_results_[col]),
                                      np.asarray(gs.cv_results_[col]),
                                      err_msg=col)


def test_refill_regime_runs_exhaustive(data, base, monkeypatch):
    """When the lanes do not fit at once (the refill regime) the rungs
    cannot compare them at one slice: the search warns and runs every
    lane to its end."""
    base = base("sparse")
    monkeypatch.setattr(
        CUDABackend, "round_cap",
        lambda self, bytes_per_task, headroom=0.85, bytes_per_round=0: 9)
    gs, ws = _torch(*data, est=SHORT, adaptive=HalvingSpec(eta=3))
    assert gs.round_stats_[0]["regime"] == "refill"
    assert gs.round_stats_[0]["rung_history"] == []
    _assert_exhaustive(gs, ws, base)


def test_small_grid_runs_exhaustive(data):
    X, y = data
    grid = {"C": CS[:6]}  # 18 tasks: the classic path
    base, _ = _torch(X, y, grid=grid, est=SHORT)
    gs, ws = _torch(X, y, adaptive=HalvingSpec(eta=3), grid=grid, est=SHORT)
    assert gs.round_stats_[0]["mode"] == "classic"
    _assert_exhaustive(gs, ws, base)


def test_rung_metric_without_device_kernel_runs_exhaustive(data, base):
    """roc_auc holds only for binary labels: on 5 classes the rung has
    no metric, so the search warns and runs exhaustively."""
    base = base("sparse")
    gs, ws = _torch(*data, est=SHORT,
                    adaptive=HalvingSpec(eta=3, metric="roc_auc"))
    _assert_exhaustive(gs, ws, base)
