"""The port's device scorers (skdist_tpu_torch.metrics) against the JAX
package's kernels on the same (y, out, w): one task, and a batch of
tasks against ``jax.vmap`` of the JAX kernel.

Tolerance: atol 1e-6. The scores are ratios of f32 sums of at most a
few hundred weights or log-probabilities, summed in different orders;
predictions, confusion counts and ranks are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skdist_tpu import metrics as jm
from skdist_tpu_torch import metrics as tm

ATOL = 1e-6
N = 150


def _case(k, seed, ties=False):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, N).astype(np.int32)
    if k == 2:
        out = rng.randn(N).astype(np.float32)
        if ties:
            out = np.round(out * 2) / 2  # many tied scores
    else:
        out = rng.randn(N, k).astype(np.float32)
    w = (rng.rand(N) < 0.6).astype(np.float32)  # a fold mask
    w *= rng.uniform(0.5, 2.0, N).astype(np.float32)
    return y, out, w


def _proba(out, k):
    if k == 2:
        p1 = 1.0 / (1.0 + np.exp(-out))
        return np.stack([1 - p1, p1], axis=1).astype(np.float32)
    e = np.exp(out - out.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


SCORERS = ["accuracy", "f1_weighted", "f1_macro", "f1_micro",
           "neg_log_loss"]
# roc_auc is binary-only in both packages
CASES = [(name, k) for name in SCORERS for k in (2, 5)] + [("roc_auc", 2)]


@pytest.mark.parametrize("name,k", CASES)
def test_scorer_matches_jax(name, k):
    tk, kind = tm.DEVICE_SCORERS[name]
    jk, jkind = jm.DEVICE_SCORERS[name]
    assert kind == jkind
    meta = {"n_classes": k}
    for seed, ties in ((0, False), (1, True)):
        y, out, w = _case(k, seed, ties)
        if kind == "proba":
            out = _proba(out, k)
        got = float(tk(torch.as_tensor(y), torch.as_tensor(out),
                       torch.as_tensor(w), meta))
        want = float(jk(jnp.asarray(y), jnp.asarray(out), jnp.asarray(w),
                        meta))
        np.testing.assert_allclose(got, want, atol=ATOL)

    # a batch of T tasks: outputs and masks differ per task, y is shared
    cases = [_case(k, 10 + t) for t in range(3)]
    y = cases[0][0]
    outs = np.stack([c[1] for c in cases])
    if kind == "proba":
        outs = np.stack([_proba(o, k) for o in outs])
    ws = np.stack([c[2] for c in cases])
    got = tk(torch.as_tensor(y), torch.as_tensor(outs), torch.as_tensor(ws),
             meta).numpy()
    want = np.asarray(jax.vmap(lambda o, w: jk(jnp.asarray(y), o, w, meta))(
        jnp.asarray(outs), jnp.asarray(ws)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_compatibility_and_defaults():
    assert tm.device_scorer_compatible("roc_auc", np.array([0, 1]))
    assert not tm.device_scorer_compatible("roc_auc", np.array([0, 1, 2]))
    assert not tm.device_scorer_compatible("roc_auc", np.array([1, 2]))
    assert tm.device_scorer_compatible("f1_weighted", np.array([0, 1, 2]))

    class Clf:
        _estimator_type = "classifier"

    assert tm.default_device_scorer(Clf()) == "accuracy"
    assert tm.accuracy_score([1, 2, 3], [1, 2, 0]) == pytest.approx(2 / 3)


REGRESSION = ["r2", "neg_mean_squared_error", "neg_root_mean_squared_error",
              "neg_mean_absolute_error"]


@pytest.mark.parametrize("name", REGRESSION)
def test_regression_scorer_matches_jax(name):
    """One task and a batch of tasks (``pred (T, n)``, ``w (T, n)``),
    against the JAX kernel and ``jax.vmap`` of it."""
    tk, kind = tm.DEVICE_SCORERS[name]
    jk, jkind = jm.DEVICE_SCORERS[name]
    assert kind == jkind == "predict"
    rng = np.random.RandomState(3)
    y = rng.randn(N).astype(np.float32)
    preds = (y + 0.3 * rng.randn(3, N)).astype(np.float32)
    ws = ((rng.rand(3, N) < 0.6) * rng.uniform(0.5, 2.0, (3, N))).astype(
        np.float32)
    got = float(tk(torch.as_tensor(y), torch.as_tensor(preds[0]),
                   torch.as_tensor(ws[0]), {}))
    want = float(jk(jnp.asarray(y), jnp.asarray(preds[0]),
                    jnp.asarray(ws[0]), {}))
    np.testing.assert_allclose(got, want, atol=ATOL)
    got = tk(torch.as_tensor(y), torch.as_tensor(preds), torch.as_tensor(ws),
             {}).numpy()
    want = np.asarray(jax.vmap(lambda p, w: jk(jnp.asarray(y), p, w, {}))(
        jnp.asarray(preds), jnp.asarray(ws)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_task_kind_guards_match_jax():
    for name in tm.DEVICE_SCORERS:
        for kind in ("classifier", "regressor"):
            assert tm.scorer_task_compatible(name, kind) == \
                jm.scorer_task_compatible(name, kind), (name, kind)
    assert tm.CLASSIFICATION_ONLY_SCORERS | tm.REGRESSION_ONLY_SCORERS == \
        set(tm.DEVICE_SCORERS)

    class Reg:
        _estimator_type = "regressor"

    assert tm.default_device_scorer(Reg()) == "r2"
