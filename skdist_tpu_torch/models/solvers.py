"""
Batched L-BFGS for the linear-model fits.

Counterpart of ``skdist_tpu/models/solvers.py``'s ``lbfgs_minimize``.
The JAX package runs one fit per ``vmap`` lane of a ``lax.while_loop``;
here the task axis is written out: every state tensor has a leading
task axis ``T`` (the carry of :data:`LBFGS_CARRY_KEYS`), the loops are
Python loops, and each lane's update is masked by its own flags, which
is what ``vmap`` of the ``while_loop`` does:

- an iteration updates only the lanes that are not ``done``;
- each lane's Armijo backtracking halves its own step only while its own
  condition fails (at most ``max_ls`` halvings);
- the body is ``_lbfgs_body``'s: the two-loop recursion over a ring of
  ``history`` pairs, the steepest-descent fallback, the normalisation of
  a raw ``-g`` direction, the ``s.y > 1e-10`` curvature check,
  ``max|g| <= tol`` per task, and ``done`` latching ``it + 1 >=
  max_iter``.

The caller's ``fun(w)`` maps ``(T, P)`` weights to ``(T,)`` losses of
independent tasks; the gradient is ``torch.autograd.grad`` of their
sum, so each lane gets its own gradient (on packed X the backward of the
forward matvec is the K2 kernel).

State is updated in place where that saves device memory (the ``S``/
``Y``/``rho`` history ring).
"""

import torch

_EPS = 1e-12

#: order of the L-BFGS carry leaves (the JAX package's carry contract)
LBFGS_CARRY_KEYS = ("w", "f", "g", "S", "Y", "rho", "k", "it", "done")


def _dot(a, b):
    """Per-task dot product of two ``(T, P)`` tensors."""
    return torch.einsum("tp,tp->t", a, b)


def _value_and_grad(fun):
    def vg(w):
        with torch.enable_grad():
            wv = w.detach().requires_grad_(True)
            f = fun(wv)
            (g,) = torch.autograd.grad(f.sum(), wv)
        return f.detach(), g

    return vg


def _two_loop(g, S, Y, rho, k, m):
    """The L-BFGS two-loop recursion, per lane over its own ring."""
    lanes = torch.arange(g.shape[0], device=g.device)
    n_corr = torch.clamp(k, max=m)
    used = int(n_corr.max())
    q = g
    alphas = torch.zeros(rho.shape, dtype=g.dtype, device=g.device)
    for i in range(used):
        idx = (k - 1 - i) % m
        valid = i < n_corr
        alpha = rho[lanes, idx] * _dot(S[lanes, idx], q)
        alpha = torch.where(valid, alpha, 0.0)
        q = q - alpha[:, None] * Y[lanes, idx]
        alphas[lanes, idx] = alpha
    last = (k - 1) % m
    S_last, Y_last = S[lanes, last], Y[lanes, last]
    sy = _dot(S_last, Y_last)
    yy = _dot(Y_last, Y_last)
    del S_last, Y_last
    gamma = torch.where(k > 0, sy / (yy + _EPS), 1.0)
    r = gamma[:, None] * q
    for i in range(used):
        idx = (k - n_corr + i) % m
        valid = i < n_corr
        beta = rho[lanes, idx] * _dot(Y[lanes, idx], r)
        upd = S[lanes, idx] * (alphas[lanes, idx] - beta)[:, None]
        r = r + torch.where(valid[:, None], upd, 0.0)
    return -r


def lbfgs_carry_init(fun, w0, tol, max_iter=100, history=10):
    """Initial batched carry (dict over :data:`LBFGS_CARRY_KEYS`) for
    ``fun((T, P)) -> (T,)`` from ``w0 (T, P)``; ``tol`` is a scalar or a
    ``(T,)`` tensor."""
    T, P = w0.shape
    f0, g0 = _value_and_grad(fun)(w0)
    tol = torch.as_tensor(tol, dtype=w0.dtype, device=w0.device)
    done0 = (g0.abs().amax(dim=1) <= tol) | (max_iter <= 0)
    zeros_hist = dict(dtype=w0.dtype, device=w0.device)
    return dict(zip(LBFGS_CARRY_KEYS, (
        w0.clone(), f0, g0,
        torch.zeros((T, history, P), **zeros_hist),
        torch.zeros((T, history, P), **zeros_hist),
        torch.zeros((T, history), **zeros_hist),
        torch.zeros(T, dtype=torch.int64, device=w0.device),
        torch.zeros(T, dtype=torch.int64, device=w0.device),
        done0,
    )))


def _lbfgs_step(carry, fun, vg, tol, max_iter, m, max_ls, active):
    """One L-BFGS iteration on the lanes in ``active``; the others keep
    their state."""
    w, f, g = carry["w"], carry["f"], carry["g"]
    S, Y, rho, k, it = carry["S"], carry["Y"], carry["rho"], carry["k"], \
        carry["it"]
    lanes = torch.arange(w.shape[0], device=w.device)

    d = _two_loop(g, S, Y, rho, k, m)
    # safeguard: fall back to steepest descent if d isn't a descent dir
    descent = _dot(g, d) < 0
    d = torch.where(descent[:, None], d, -g)
    # a raw -g direction (first iteration, or the fallback above) has
    # arbitrary scale; normalise it so the unit backtracking grid covers
    # it (curvature-scaled directions are already well-sized)
    raw_scale = ~descent | (k == 0)
    d = torch.where(
        raw_scale[:, None],
        d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + _EPS), d,
    )

    # Armijo backtracking, each lane on its own step
    gd = _dot(g, d)
    t = torch.ones_like(f)
    with torch.no_grad():
        f_new = fun(w + t[:, None] * d)
        n_ls = torch.zeros_like(k)
        while True:
            armijo = f_new <= f + 1e-4 * t * gd
            backtrack = ~armijo & (n_ls < max_ls) & active
            if not bool(backtrack.any()):
                break
            t = torch.where(backtrack, t * 0.5, t)
            f_new = torch.where(backtrack, fun(w + t[:, None] * d), f_new)
            n_ls = n_ls + backtrack
    ok = f_new <= f + 1e-4 * t * gd
    w_new = w + t[:, None] * d
    del d
    f_new2, g_new = vg(w_new)
    s = w_new - w
    yv = g_new - g
    sy = _dot(s, yv)
    # curvature check: only store pairs with s.y > 0
    store = (sy > 1e-10) & active
    if bool(store.any()):
        sel = lanes[store]
        slot = (k % m)[store]
        S[sel, slot] = s[store]
        Y[sel, slot] = yv[store]
        rho[sel, slot] = 1.0 / (sy[store] + _EPS)
    del s, yv
    converged = g_new.abs().amax(dim=1) <= tol
    stalled = ~ok  # line search failed to find decrease
    done_new = converged | stalled | (it + 1 >= max_iter)

    act = active[:, None]
    carry["w"] = torch.where(act, w_new, w)
    carry["f"] = torch.where(active, f_new2, f)
    carry["g"] = torch.where(act, g_new, g)
    carry["k"] = k + store
    carry["it"] = it + active
    carry["done"] = torch.where(active, done_new, carry["done"])
    return carry


def lbfgs_resume(fun, carry, n_steps, tol, max_iter=100, history=10,
                 max_ls=20):
    """Advance a batched carry by at most ``n_steps`` iterations; each
    lane stops when it converges, stalls or reaches ``max_iter``."""
    vg = _value_and_grad(fun)
    w = carry["w"]
    tol = torch.as_tensor(tol, dtype=w.dtype, device=w.device)
    for _ in range(int(n_steps)):
        active = ~carry["done"] & (carry["it"] < max_iter)
        if not bool(active.any()):
            break
        carry = _lbfgs_step(carry, fun, vg, tol, max_iter, history, max_ls,
                            active)
    return carry


def lbfgs_minimize(fun, w0, tol=1e-4, max_iter=100, history=10, max_ls=20):
    """Minimise ``T`` independent objectives ``fun((T, P)) -> (T,)`` from
    ``w0 (T, P)``. Returns ``(w (T, P), n_iter (T,))``. Convergence per
    task: ``max|grad| <= tol`` (``tol`` scalar or ``(T,)``)."""
    carry = lbfgs_carry_init(fun, w0, tol, max_iter=max_iter,
                             history=history)
    carry = lbfgs_resume(fun, carry, max_iter, tol, max_iter=max_iter,
                         history=history, max_ls=max_ls)
    return carry["w"], carry["it"]
