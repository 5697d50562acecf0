"""The port's batched L-BFGS (skdist_tpu_torch.models.solvers) against
``jax.vmap`` of the JAX package's ``lbfgs_minimize``, on T binary and
multinomial logistic tasks that differ in C and in their fold weights.

Tolerances: final loss rel 1e-5 and weights atol 1e-4. Both run the same
algorithm in f32 and differ only in summation order. The convergence
tolerances stop every lane well above the f32 noise floor of these
gradients (a loss of ~1e2 has an ulp of ~1e-5, and gradient noise near
1e-3 would let the two trajectories wander apart), so both packages
stop each lane at the same iterate to that accuracy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skdist_tpu.models.solvers import lbfgs_minimize as jax_lbfgs
from skdist_tpu_torch.models.solvers import (
    LBFGS_CARRY_KEYS,
    lbfgs_carry_init,
    lbfgs_minimize,
)

N, D = 120, 8
CS = np.array([1e-2, 0.1, 1.0, 10.0], np.float32)
TOL = np.array([1e-2, 1e-2, 5e-3, 1e-2], np.float32)
MAX_ITER = 200


def _problem(k):
    rng = np.random.RandomState(3 + k)
    X = rng.randn(N, D).astype(np.float32)
    y = rng.randint(0, k, N)
    # per-task fold weights: each task drops a different fifth of rows
    sw = np.ones((len(CS), N), np.float32)
    for t in range(len(CS)):
        sw[t, t::5] = 0.0
    return X, y, sw


def _jax_losses(X, y, k):
    Xj = jnp.asarray(X)
    if k == 2:
        yj = jnp.asarray(y, jnp.float32)

        def loss(w, C, sw):
            z = Xj @ w
            return jnp.sum(sw * (jax.nn.softplus(z) - yj * z)) + \
                0.5 / C * jnp.dot(w, w)

        return loss, D
    oh = jax.nn.one_hot(jnp.asarray(y), k)

    def loss(w, C, sw):
        W = w.reshape(D, k)
        lg = Xj @ W
        return jnp.sum(sw * (jax.nn.logsumexp(lg, axis=1)
                             - jnp.sum(oh * lg, axis=1))) + \
            0.5 / C * jnp.sum(W * W)

    return loss, D * k


def _torch_loss(X, y, k, sw):
    Xt = torch.as_tensor(X)
    C = torch.as_tensor(CS)
    swt = torch.as_tensor(sw)
    if k == 2:
        yt = torch.as_tensor(y, dtype=torch.float32)

        def loss(w):
            z = (Xt @ w[:, :, None])[..., 0]
            ce = torch.sum(
                swt * (torch.logaddexp(z, torch.zeros_like(z)) - yt * z), 1)
            return ce + 0.5 / C * torch.sum(w * w, 1)

        return loss
    oh = torch.nn.functional.one_hot(torch.as_tensor(y), k).float()

    def loss(w):
        W = w.reshape(w.shape[0], D, k)
        lg = Xt @ W
        ce = torch.sum(swt * (torch.logsumexp(lg, 2)
                              - torch.sum(oh * lg, 2)), 1)
        return ce + 0.5 / C * torch.sum(W * W, dim=(1, 2))

    return loss


@pytest.mark.parametrize("k", [2, 4])
def test_batched_lbfgs_matches_vmapped_jax(k):
    X, y, sw = _problem(k)
    jloss, P = _jax_losses(X, y, k)

    @jax.jit
    def solve(C, sw_t, tol):
        w, it = jax_lbfgs(lambda w: jloss(w, C, sw_t), jnp.zeros(P),
                          max_iter=MAX_ITER, tol=tol)
        return w, it, jloss(w, C, sw_t)

    jw, jit_, jf = jax.vmap(solve)(jnp.asarray(CS), jnp.asarray(sw),
                                   jnp.asarray(TOL))
    tloss = _torch_loss(X, y, k, sw)
    tw, tit = lbfgs_minimize(tloss, torch.zeros(len(CS), P),
                             tol=torch.as_tensor(TOL), max_iter=MAX_ITER)
    tf = tloss(tw)
    jit_ = np.asarray(jit_)
    assert (jit_ < MAX_ITER).all(), "every reference lane must converge"
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4)
    # lanes finish at their own iteration counts: one lane is done while
    # others run on, and the masked update froze it there
    its = tit.numpy()
    assert its.min() < its.max()
    assert (np.abs(its - jit_) <= 2).all()


def test_carry_holds_the_contract_keys():
    X, y, sw = _problem(2)
    carry = lbfgs_carry_init(_torch_loss(X, y, 2, sw),
                             torch.zeros(len(CS), D), 1e-3, history=5)
    assert tuple(carry) == LBFGS_CARRY_KEYS
    assert carry["S"].shape == (len(CS), 5, D)
    assert carry["done"].dtype == torch.bool


def test_max_iter_caps_every_lane():
    X, y, sw = _problem(4)
    tloss = _torch_loss(X, y, 4, sw)
    _, it = lbfgs_minimize(tloss, torch.zeros(len(CS), D * 4), tol=0.0,
                           max_iter=3)
    assert (it.numpy() == 3).all()
