"""
Batched L-BFGS and mini-batch SGD for the linear-model fits.

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

Resumable carry form (the convergence-compacted scheduler of
``parallel/backend.py``): :func:`lbfgs_minimize` is
:func:`lbfgs_carry_init` plus one full-length :func:`lbfgs_resume`, so
chained shorter resumes are bitwise the same solve; they only change
where the caller observes the carry. :func:`lbfgs_carry_restart` starts
some lanes of a fixed-shape carry afresh in place (a freed slot taking a
new task), and :func:`carry_iterate` is the live iterate a rung scores.
Every per-lane value is computed on the carry's full ``(T, ...)``
tensors, so a lane's bits do not depend on its slot or its neighbours.

The SGD half (:func:`sgd_minimize` and its carry form) is the counterpart
of the JAX package's ``sgd_*`` solvers: the same per-lane update, epoch
freeze and early-stopping rule, over a task axis written out. Each lane
reads its own batch rows (an epoch's row order is keyed by the lane's
global epoch index, which differs between lanes once a freed slot is
restarted), so a step gathers a ``(T, batch, p)`` block; the products
are batched matmuls.
"""

import numpy as np
import torch

from ..utils import draws

_EPS = 1e-12

#: order of the L-BFGS carry leaves (the JAX package's carry contract)
LBFGS_CARRY_KEYS = ("w", "f", "g", "S", "Y", "rho", "k", "it", "done")


def carry_iterate(carry):
    """The current weight iterate of a carry: ``w`` is written only
    after an accepted (or stalled-in-place) step, so it is a usable
    model at every slice boundary (what an adaptive rung scores)."""
    return carry["w"]


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


def lbfgs_carry_init(fun, w0, tol, max_iter=100, history=10, vg=None):
    """Initial batched carry (dict over :data:`LBFGS_CARRY_KEYS`) for
    ``fun((T, P)) -> (T,)`` from ``w0 (T, P)``; ``tol`` is a scalar or a
    ``(T,)`` tensor. ``vg(w) -> (f, g)`` replaces autograd of ``fun``
    where the caller computes both another way (the streamed fit's
    block-accumulated passes)."""
    T, P = w0.shape
    f0, g0 = (vg or _value_and_grad(fun))(w0)
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


def lbfgs_carry_restart(fun, carry, slots, w0, tol, max_iter=100):
    """Start the lanes at ``slots`` (an int64 tensor of slot ids) of a
    batched carry afresh, in place: their weights become ``w0`` (one row
    a slot), their loss and gradient are evaluated with the rest of the
    carry's lanes (the full ``(T, P)`` batch, so the values are those a
    fresh :func:`lbfgs_carry_init` gives), their history rows, ``k`` and
    ``it`` are zeroed and ``done`` is set as at init. No second history
    ring is allocated. ``fun`` must already be the objective of the
    slots' new tasks; ``tol`` is a scalar or a ``(T,)`` tensor."""
    w = carry["w"]
    w.index_copy_(0, slots, w0.to(w.dtype))
    f, g = _value_and_grad(fun)(w)
    f, g = f.index_select(0, slots), g.index_select(0, slots)
    carry["f"].index_copy_(0, slots, f)
    carry["g"].index_copy_(0, slots, g)
    for key in ("S", "Y", "rho", "k", "it"):
        carry[key].index_fill_(0, slots, 0)
    tol = torch.as_tensor(tol, dtype=w.dtype, device=w.device)
    if tol.ndim:
        tol = tol.index_select(0, slots)
    carry["done"].index_copy_(
        0, slots, (g.abs().amax(dim=1) <= tol) | (max_iter <= 0))
    return carry


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
                 max_ls=20, vg=None):
    """Advance a batched carry by at most ``n_steps`` iterations; each
    lane stops when it converges, stalls or reaches ``max_iter``.
    ``fun`` gives the Armijo probes' values, ``vg`` (autograd of ``fun``
    by default) each accepted point's value and gradient."""
    vg = vg or _value_and_grad(fun)
    w = carry["w"]
    tol = torch.as_tensor(tol, dtype=w.dtype, device=w.device)
    for _ in range(int(n_steps)):
        active = ~carry["done"] & (carry["it"] < max_iter)
        if not bool(active.any()):
            break
        carry = _lbfgs_step(carry, fun, vg, tol, max_iter, history, max_ls,
                            active)
    return carry


def lbfgs_minimize(fun, w0, tol=1e-4, max_iter=100, history=10, max_ls=20,
                   vg=None):
    """Minimise ``T`` independent objectives ``fun((T, P)) -> (T,)`` from
    ``w0 (T, P)``. Returns ``(w (T, P), n_iter (T,))``. Convergence per
    task: ``max|grad| <= tol`` (``tol`` scalar or ``(T,)``). ``vg`` as in
    :func:`lbfgs_resume`."""
    carry = lbfgs_carry_init(fun, w0, tol, max_iter=max_iter,
                             history=history, vg=vg)
    carry = lbfgs_resume(fun, carry, max_iter, tol, max_iter=max_iter,
                         history=history, max_ls=max_ls, vg=vg)
    return carry["w"], carry["it"]


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

#: order of the SGD carry leaves: the JAX package's, with its post-step
#: pytree ``pstate`` written out as ``u`` (the L1 penalty rate accrued,
#: ``(T,)``) and ``q`` (what each weight has absorbed of it, ``(T, P)``);
#: both stay zero without an L1 term
SGD_CARRY_KEYS = ("w", "u", "q", "step", "best", "bad", "n_done", "it",
                  "done")


def sgd_batch_scan(grad_fn, learning_rate_fn, post_step, loss_fn, carry4,
                   n_batches, batch):
    """Advance the ``(w, pstate, step, acc)`` quadruple of a lane batch
    over ``n_batches`` mini-batches, ``batch(b)`` giving the b-th: the
    JAX package's inner loop. Each step is ``w - lr * grad``, then the
    post-step (the L1 truncation), then the batch's loss after the
    update added to ``acc``. The rates of the epoch's steps come from
    one call of ``learning_rate_fn`` over the ``(T, n_batches)`` step
    counts: the same elementwise float32 ops as one step at a time. No
    host read."""
    w, pstate, step, acc = carry4
    counts = step[:, None] + torch.arange(n_batches, device=step.device)
    rates = learning_rate_fn(counts)  # (T, n_batches)
    for b in range(n_batches):
        xb = batch(b)
        lr = rates[:, b]
        w = w - lr[:, None] * grad_fn(w, xb)
        if post_step is not None:
            w, pstate = post_step(w, pstate, lr)
        acc = acc + loss_fn(w, xb)
    return w, pstate, step + n_batches, acc


def _lane_orders(carry, seed, n_samples, padded, max_epochs, shuffle):
    """Each lane's row order for its next epoch, ``(T, padded)`` int64
    (an expanded view when every lane reads one order), or None when no
    lane is live. The one host read of an epoch: the lanes' epoch clocks
    and done flags. A frozen lane borrows a live lane's order (its
    update is discarded), so an epoch draws one order per distinct live
    epoch; the resident regime's lanes share one."""
    it, done = carry["it"], carry["done"]
    T, device = it.shape[0], it.device
    host = torch.stack([it, done.to(torch.int64)]).cpu().numpy()
    live = (host[1] == 0) & (host[0] < max_epochs)
    if not live.any():
        return None
    if not shuffle:
        order = torch.arange(padded, device=device) % n_samples
        return order.expand(T, padded)
    epochs = np.where(live, host[0], host[0][live][0])
    uniq, pos = np.unique(epochs, return_inverse=True)
    orders = [draws.epoch_permutation(seed, e, padded, n_samples, device)
              for e in uniq]
    if len(orders) == 1:
        return orders[0].expand(T, padded)
    return torch.stack(orders).index_select(
        0, torch.as_tensor(pos, device=device))


def _sgd_epoch_body(problem, max_epochs, tol, n_iter_no_change):
    """One SGD epoch on a carry, given each lane's row order: the JAX
    package's epoch. Frozen lanes (stopped early, or at ``max_epochs``)
    keep every leaf but their epoch clock ``it``; the mean post-update
    batch loss of the epoch must beat ``best - tol`` within
    ``n_iter_no_change`` epochs or the lane stops (a ``tol`` of -inf,
    sklearn's ``tol=None``, never stops one)."""

    def epoch(carry, rows):
        n_batches, batch = problem["batches"](rows)
        scanned = sgd_batch_scan(
            problem["grad_fn"], problem["lr_fn"], problem["post_step"],
            problem["loss_fn"], sgd_scan_start(carry), n_batches, batch)
        return sgd_epoch_end(carry, scanned, n_batches, max_epochs, tol,
                             n_iter_no_change)

    return epoch


def sgd_scan_start(carry):
    """The ``(w, (u, q), step, acc)`` quadruple an epoch's batch scan
    starts from: the carry's, with the epoch's loss sum at zero."""
    return (carry["w"], (carry["u"], carry["q"]), carry["step"],
            torch.zeros_like(carry["best"]))


def sgd_epoch_end(carry, scanned, n_batches, max_epochs, tol,
                  n_iter_no_change):
    """The end of an SGD epoch whose ``n_batches`` mini-batches advanced
    the carry's quadruple to ``scanned`` (:func:`sgd_batch_scan`): the
    mean post-update batch loss against ``best - tol``, the
    no-improvement count, and frozen lanes (stopped, or at
    ``max_epochs``) keeping every leaf but their epoch clock ``it``.
    The resident epoch and the streamed one (whose scan runs block by
    block) share it."""
    w, u, q, step, best, bad, n_done, it, done = (
        carry[key] for key in SGD_CARRY_KEYS)
    w_new, (u_new, q_new), step_new, acc = scanned
    keep = done | (it >= max_epochs)
    loss = acc / n_batches
    bad_new = torch.where(loss < best - tol, 0, bad + 1)
    stopped = bad_new >= n_iter_no_change
    best_new = torch.minimum(best, loss)
    it_new = torch.where(it >= max_epochs, it, it + 1)
    col = keep[:, None]
    return dict(zip(SGD_CARRY_KEYS, (
        torch.where(col, w, w_new),
        torch.where(keep, u, u_new),
        torch.where(col, q, q_new),
        torch.where(keep, step, step_new),
        torch.where(keep, best, best_new),
        torch.where(keep, bad, bad_new),
        torch.where(keep, n_done, n_done + 1),
        it_new,
        keep | stopped | (it_new >= max_epochs),
    )))


def sgd_carry_init(w0):
    """Initial SGD carry (dict over :data:`SGD_CARRY_KEYS`) for the lane
    weights ``w0 (T, P)``; no epoch is run."""
    T, device = w0.shape[0], w0.device
    count = torch.zeros(T, dtype=torch.int64, device=device)
    return dict(zip(SGD_CARRY_KEYS, (
        w0.clone(), torch.zeros(T, dtype=w0.dtype, device=device),
        torch.zeros_like(w0), count,
        torch.full((T,), float("inf"), dtype=w0.dtype, device=device),
        count.clone(), count.clone(), count.clone(),
        torch.zeros(T, dtype=torch.bool, device=device),
    )))


def sgd_carry_restart(carry, slots, w0):
    """Start the lanes at ``slots`` (an int64 tensor of slot ids) of an
    SGD carry afresh, in place: weights ``w0`` (one row a slot) and every
    other leaf as :func:`sgd_carry_init` sets it (penalty state, step
    and epoch counts zero, ``best`` infinite, not done). The counterpart
    of :func:`lbfgs_carry_restart` for the refill regime."""
    carry["w"].index_copy_(0, slots, w0.to(carry["w"].dtype))
    for key in ("u", "q", "step", "bad", "n_done", "it"):
        carry[key].index_fill_(0, slots, 0)
    carry["best"].index_fill_(0, slots, float("inf"))
    carry["done"].index_fill_(0, slots, False)
    return carry


def sgd_resume(problem, carry, n_steps, tol, max_epochs, batch_size, seed=0,
               shuffle=True, n_iter_no_change=5):
    """Advance an SGD carry by at most ``n_steps`` epochs; stopped lanes
    (and lanes at ``max_epochs``) freeze in place, and the loop ends
    early once no lane is live (no leaf but the frozen lanes' epoch
    clock would change). Each epoch's row order is keyed by the lane's
    global epoch index, so slice boundaries cannot change it. ``tol`` is
    a scalar or a ``(T,)`` tensor.

    ``problem`` is the dict of the fit problem: ``n`` (rows),
    ``batches(rows) -> (n_batches, batch)`` (the epoch's batches from
    the lanes' ``(T, padded)`` row orders), ``grad_fn(w, xb)``,
    ``loss_fn(w, xb)`` (the weighted mean batch data loss, ``(T,)``),
    ``lr_fn(step counts)`` and ``post_step(w, (u, q), lr)`` or None."""
    n = problem["n"]
    padded = -(-n // batch_size) * batch_size
    epoch = _sgd_epoch_body(problem, max_epochs, tol, n_iter_no_change)
    for _ in range(int(n_steps)):
        rows = _lane_orders(carry, seed, n, padded, max_epochs, shuffle)
        if rows is None:
            break
        carry = epoch(carry, rows)
    return carry


def sgd_minimize(problem, w0, tol, max_epochs, batch_size, seed=0,
                 shuffle=True, n_iter_no_change=5):
    """Mini-batch SGD of ``T`` independent lanes from ``w0 (T, P)``:
    :func:`sgd_carry_init` plus one ``max_epochs``-long
    :func:`sgd_resume`, so epoch-sliced runs share its exact sequence.
    Fixed-shape batches: the ``n`` rows are padded up to whole batches
    with wrap-around indices. Returns ``(w (T, P), n_epochs (T,))``."""
    carry = sgd_resume(problem, sgd_carry_init(w0), max_epochs, tol,
                       max_epochs, batch_size, seed=seed, shuffle=shuffle,
                       n_iter_no_change=n_iter_no_change)
    return carry["w"], carry["n_done"]
