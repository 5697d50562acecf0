"""
Streamed (out-of-core) fits and scores over a
:class:`~skdist_tpu_torch.data.ChunkedDataset`, block by block.

Counterpart of ``skdist_tpu/models/streaming.py``. The blocks come
through the block feeder
(:class:`~skdist_tpu_torch.parallel.backend.BlockFeeder`: pinned host
buffers and a copy stream on the card), one cycling feeder for all the
passes over one dataset, in a fixed block order, so a serial feed
(``sync=True``) and the pipelined one give the same bits. Each family's
streamed fit is selected by its ``_stream_fit_kind``:

- ``"lbfgs"`` (``LogisticRegression``, ``LinearSVC``): the data term is
  row-additive, so one evaluation of the loss and its gradient is a
  streamed reduction. Each block's data term is the resident problem's
  own expression on that block (through the same
  :class:`~skdist_tpu_torch.sparse.LinearOperator`, dense or packed; on
  packed blocks the forward is K1 and the gradient's backward K2), the
  partial sums add in place on the device in block order, and the
  regulariser is added once. The solver is the resident one,
  :func:`~skdist_tpu_torch.models.solvers.lbfgs_minimize`, with the
  streamed value pass as its ``fun`` and the streamed value-and-gradient
  pass as its ``vg``. Block sums reorder the float32 reductions, so the
  fit agrees with the resident one to rounding, not bitwise.
- ``"gram"`` (the ridge family): each block adds its normal equations
  ``(X~.T S X~, (S X~).T T)`` over a round's lanes (one
  ``weighted_gram_rhs`` call: K3 and K2 on packed blocks) in place into
  the round's sums, and the resident solve finishes
  (``_RidgeKernelMixin._gram_solve``). A lane's ``(p, p)`` gram is
  large, so lanes run in rounds sized from free device memory, each
  round one pass.
- ``"sgd"`` (``SGDClassifier``): epochs are block streams. Each block's
  mini-batches advance the ``(w, (u, q), step, acc)`` carry through the
  resident scan (:func:`~skdist_tpu_torch.models.solvers.sgd_batch_scan`,
  K1's and K2's row forms on packed blocks), and the resident epoch end
  (:func:`~skdist_tpu_torch.models.solvers.sgd_epoch_end`) applies the
  stopping rule. With ``shuffle=False`` and blocks that hold whole
  batches, every batch is the resident scan's, so the streamed fit is
  bitwise the resident one; a shuffled epoch draws a block-local order
  keyed by (seed, epoch, block) (``utils/draws.py block_permutation``).

A fit's lanes see one block tree a block (X, the fit's per-row vectors);
``derive(block, task) -> (y, sw)`` makes their labels (``(rows,)`` or
one row a lane) and weights ``(T, rows)`` from it on the device: the
search's fold masks, one-vs-rest's class columns, one-vs-one's pair
masks (:func:`default_derive` is a single fit's). :func:`stream_scores`
scores fitted lanes in one more pass: the family's decision kernel (K1
on packed blocks), the proba kernel only where a metric needs it, and
per-block sufficient statistics (``metrics.STREAM_SCORERS``) summed on
the device, combined on the host.

Not ported yet: item 9c's streamed boosting fit and the streamed ASHA
rungs of the search; item 10's block retries and elastic replans. A
fault in a streamed pass raises.
"""

import time

import numpy as np
import torch

from ..parallel.backend import BlockFeeder, CUDABackend
from ..sparse import LinearOperator, PackedX
from ..utils import draws
from ..utils.device import exact_matmuls, resolve_device
from .solvers import (
    lbfgs_minimize,
    sgd_batch_scan,
    sgd_carry_init,
    sgd_epoch_end,
    sgd_scan_start,
)

__all__ = ["StreamedObjective", "default_derive", "open_feeder",
           "stream_fit_estimator", "stream_fit_tasks", "stream_hyper",
           "stream_hyper_names", "stream_scores"]


def _pad_value(name):
    """What a padded tail row holds in a per-row vector: a weight of 0
    (no contraction reads it), label 0 (a valid class whose row weighs
    nothing), and fold id -1 (equal to no split id)."""
    return -1 if name == "fold" else 0


def _make_block_read(dataset, row_arrays, pad=True):
    """``read(i) -> host block tree``: the dataset's X block with the
    fit's own per-row vectors (encoded labels, weights, fold ids) sliced
    to the block's global rows; ``pad`` pads the tail to ``block_rows``
    (see :func:`_pad_value`)."""

    def read(i):
        b = dataset.read_block(i, pad=pad)
        tree = {"X": b.X}
        pad_n = dataset.block_rows - b.n_real if pad else 0
        for name, arr in row_arrays.items():
            sl = np.asarray(arr[b.start:b.stop])
            if pad_n:
                sl = np.concatenate([
                    sl, np.full((pad_n,) + sl.shape[1:], _pad_value(name),
                                sl.dtype)])
            tree[name] = sl
        return tree

    return read


def open_feeder(dataset, row_arrays, device, sync=False, stats=None):
    """The cycling :class:`BlockFeeder` of padded blocks that the passes
    over ``dataset`` share (the fit's and the scoring pass's): one ring of
    pinned buffers, one copy stream and one worker. The caller closes it."""
    return BlockFeeder(_make_block_read(dataset, row_arrays),
                       dataset.n_blocks, torch.device(device), sync=sync,
                       stats=stats, cycle=True)


def new_stream_stats(sync):
    """The stats dict of a streamed fit: the feeder's keys
    (:class:`BlockFeeder`) and the passes run: ``value_passes`` (the
    Armijo probes, K1 only on packed blocks), ``grad_passes`` (value and
    gradient, K1 and K2), ``gram_passes`` (a round of the ridge family's
    lanes), ``epochs`` and ``steps`` (SGD), ``score_passes``, ``passes``
    (their sum) and ``dispatch_s`` (the consumer's time on the blocks'
    work, launches included)."""
    return {"mode": "streamed", "stream_mode": "serial" if sync
            else "pipelined", "tasks": 0, "passes": 0, "value_passes": 0,
            "grad_passes": 0, "gram_passes": 0, "epochs": 0, "steps": 0,
            "score_passes": 0, "dispatch_s": 0.0}


def _count(stats, kind):
    stats["passes"] += 1
    stats[kind] += 1


def _streamed_sum(fn, feeder, stats):
    """``sum(fn(block))`` over one pass of a cycling ``feeder``'s blocks,
    in block order: each ``fn`` returns a tuple of fresh device tensors,
    added in place into the first block's (no second accumulator of the
    gradient's size); nothing is read back to the host here. A pass that
    raises leaves the feeder at block 0 again."""
    acc = None
    try:
        for _ in range(feeder.n_blocks):
            _i, block = feeder.next()
            t0 = time.perf_counter()
            out = fn(block)
            if acc is None:
                acc = out
            else:
                for a, b in zip(acc, out):
                    a.add_(b)
            # the next block's partials are made with this one's freed
            del out
            stats["dispatch_s"] += time.perf_counter() - t0
    except BaseException:
        feeder.seek(0)
        raise
    return acc


def _n_lanes(task):
    return int(next(iter(task["hyper"].values())).shape[0])


def default_derive(block, task):
    """A plain fit's labels and weights: the block's, one weight row a
    lane."""
    return block["y"], block["sw"][None].expand(_n_lanes(task), -1)


def _place_task(hyper, task, device):
    """The lanes' device tree: ``hyper`` as float32 ``(T,)`` tensors
    under ``"hyper"`` beside the other ``(T,)`` host arrays of ``task``
    (fold ids, classes, pairs)."""
    out = {"hyper": {k: torch.as_tensor(np.asarray(v, np.float32),
                                        device=device)
                     for k, v in hyper.items()}}
    for k, v in (task or {}).items():
        out[k] = torch.as_tensor(np.asarray(v), device=device)
    return out


def _take_lanes(task, lo, hi):
    """Lanes ``lo:hi`` of a device task tree."""
    return {k: (_take_lanes(v, lo, hi) if isinstance(v, dict) else v[lo:hi])
            for k, v in task.items()}


def _zero_block(dataset, row_arrays, device):
    """A one-row zero block of ``dataset``'s layout on ``device``, from
    which a fit problem's regulariser, zero start and unpacking are
    built (none of them reads X)."""
    if dataset.x_format == "packed":
        X = PackedX.checked_copy(
            torch.zeros((1, dataset.packed_m), dtype=torch.int32,
                        device=device),
            torch.zeros((1, dataset.packed_m), dtype=torch.float32,
                        device=device), dataset.n_features)
    else:
        X = torch.zeros((1, dataset.n_features), dtype=torch.float32,
                        device=device)
    tree = {"X": X}
    for name, arr in row_arrays.items():
        a = np.asarray(arr[:0])
        tree[name] = torch.zeros((1,) + a.shape[1:],
                                 dtype=torch.from_numpy(a).dtype,
                                 device=device)
    return tree


class StreamedObjective:
    """The objective of ``T`` L-BFGS fits of ``est_cls`` over a
    ``dataset``, evaluated by streamed passes on ``device``.

    ``row_arrays`` maps per-row vector names (``y`` the encoded labels,
    ``sw`` the weights, ``fold`` the search's fold ids: ``(n_rows,)``
    host arrays) to what is sliced per block; ``hyper`` maps each
    ``_hyper_names`` entry to a ``(T,)`` array, ``task`` other ``(T,)``
    lane arrays that ``derive`` reads (:func:`default_derive` without
    one). :meth:`value` is one value pass (``(T,)``),
    :meth:`value_and_grad` one value-and-gradient pass (``(T,)``, ``(T,
    P)``), both with the regulariser added once; ``w0`` is the problem's
    zero start and ``unpack`` its fitted-params shaper. Every pass takes
    its blocks from one cycling :class:`BlockFeeder` (:func:`open_feeder`;
    the caller's ``feeder`` when given, which it closes itself; else one
    of its own, stopped by :meth:`close`)."""

    def __init__(self, est_cls, meta, static, dataset, row_arrays, hyper,
                 device, sync=False, stats=None, task=None, derive=None,
                 feeder=None):
        st = dict(static)
        self.problem = est_cls._build_fit_problem(meta, static)
        self.fit_intercept = st["fit_intercept"]
        self.matmul_dtype = st.get("matmul_dtype")
        self.dataset = dataset
        self.device = torch.device(device)
        self.stats = stats if stats is not None else new_stream_stats(sync)
        self._own_feeder = feeder is None
        self.feeder = (open_feeder(dataset, row_arrays, self.device, sync,
                                   self.stats)
                       if feeder is None else feeder)
        self.task = _place_task(hyper, task, self.device)
        self.hyper = self.task["hyper"]
        self.derive = derive or default_derive
        self.T = _n_lanes(self.task)
        zero = _zero_block(dataset, row_arrays, self.device)
        _loss, self.w0, self.unpack, _data, self.reg_loss = self._parts(zero)

    def _parts(self, block, grad=False):
        """The problem's ``(loss, w0, unpack, data_loss, reg_loss)`` over
        one device block. Only a gradient pass's operator sorts the
        columns K2 reads, and up front, before the forward's activations
        exist (the sort's temporaries are the block's largest); a value
        pass runs K1 alone."""
        op = LinearOperator(block["X"], self.fit_intercept,
                            matmul_dtype=self.matmul_dtype,
                            sort_columns=grad)
        y, sw = self.derive(block, self.task)
        return self.problem(op, y, sw, self.hyper, parts=True)

    def value(self, w):
        """The objective at ``w (T, P)``: one value pass, ``(T,)``."""
        _count(self.stats, "value_passes")
        with torch.no_grad():
            (f,) = _streamed_sum(lambda block: (self._parts(block)[3](w),),
                                 self.feeder, self.stats)
            return f + self.reg_loss(w)

    def value_and_grad(self, w):
        """The objective and its gradient at ``w (T, P)``: one pass."""
        _count(self.stats, "grad_passes")

        def part(block):
            data_loss = self._parts(block, grad=True)[3]
            with torch.enable_grad():
                wv = w.detach().requires_grad_(True)
                f = data_loss(wv)
                (g,) = torch.autograd.grad(f.sum(), wv)
            return f.detach(), g

        f, g = _streamed_sum(part, self.feeder, self.stats)
        with torch.enable_grad():
            wv = w.detach().requires_grad_(True)
            fr = self.reg_loss(wv)
            gr = (torch.autograd.grad(fr.sum(), wv)[0] if fr.requires_grad
                  else torch.zeros_like(w))
        return f + fr.detach(), g + gr

    def close(self):
        """Stop the feeder this objective opened (a prefetched block is
        discarded)."""
        if self._own_feeder:
            self.feeder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fit_lbfgs_stream(est_cls, meta, static, dataset, row_arrays, hyper,
                      task, derive, device, sync, stats, w_init, feeder):
    st = dict(static)
    obj = StreamedObjective(est_cls, meta, static, dataset, row_arrays,
                            hyper, device, sync=sync, stats=stats, task=task,
                            derive=derive, feeder=feeder)
    w0 = obj.w0
    if w_init is not None:
        w0 = torch.as_tensor(np.asarray(w_init, np.float32),
                             device=obj.device).reshape(w0.shape).clone()
    with obj, exact_matmuls():
        w, n_iter = lbfgs_minimize(
            obj.value, w0, tol=obj.hyper["tol"], max_iter=int(st["max_iter"]),
            history=int(st["history"]), vg=obj.value_and_grad)
        params = obj.unpack(w.detach(), n_iter)
    return {k: v.cpu().numpy() for k, v in params.items()}


def _gram_round_lanes(est_cls, meta, static, dataset, T, device):
    """Lanes a round of the streamed ridge fit holds, spread evenly over
    the rounds, sized as the resident fit sizes its rounds
    (``_batched_task_bytes``/``_batched_round_bytes`` at the block's
    rows) from free device memory: a lane also holds the running sum of
    its ``(p, p)`` gram beside the block's, and a round once K3's pair
    table of a block (its build's temporaries billed at 64 bytes a pair
    of entries) and two fed blocks. All lanes on the CPU. Returns
    ``(lanes, bytes per lane, bytes a round holds once)``."""
    st = dict(static)
    rows = dataset.block_rows
    p = meta["n_features"] + (1 if st["fit_intercept"] else 0)
    per = est_cls._batched_task_bytes(meta, static, rows) + p * p * 4
    once = (est_cls._batched_round_bytes(meta, static, rows)
            + 2 * dataset.block_nbytes)
    if dataset.x_format == "packed":
        m = dataset.packed_m + (1 if st["fit_intercept"] else 0)
        once += 64 * rows * m * m
    lanes = CUDABackend(device=device).plan_round_size(
        T, per, bytes_per_round=once)
    return lanes, per, once


def _fit_gram_stream(est_cls, meta, static, dataset, row_arrays, hyper,
                     task, derive, device, sync, stats, w_init, feeder):
    """Block-accumulated normal equations of the ridge family, a round of
    lanes a pass, each lane finished by the resident solve. ``w_init`` is
    accepted and ignored: a direct solve has no iterate to seed."""
    st = dict(static)
    d = meta["n_features"]
    tree = _place_task(hyper, task, device)
    T = _n_lanes(tree)
    alpha = tree["hyper"].get("alpha")
    if alpha is None:  # LinearRegression
        alpha = torch.zeros(T, dtype=torch.float32, device=device)
    lanes, per, once = _gram_round_lanes(est_cls, meta, static, dataset, T,
                                         device)
    stats["gram_rounds"] = stats.get("gram_rounds", 0) + -(-T // lanes)
    stats["gram_lanes_per_round"] = lanes
    stats["gram_round_bytes"] = lanes * per + once
    W = []
    with exact_matmuls():
        for lo in range(0, T, lanes):
            sub = _take_lanes(tree, lo, min(lo + lanes, T))

            def part(block, sub=sub):
                y, sw = derive(block, sub)
                sw, targets = est_cls._gram_terms(meta, static, y, sw,
                                                  torch.float32)
                op = LinearOperator(block["X"], st["fit_intercept"])
                return op.weighted_gram_rhs(sw, targets)

            _count(stats, "gram_passes")
            G, b = _streamed_sum(part, feeder, stats)
            Wr = est_cls._gram_solve(G, b, alpha[lo:lo + lanes], d)
            del G, b
            W.append(est_cls._gram_params(meta, Wr)["W"].cpu().numpy())
    return {"W": np.concatenate(W)}


def _sgd_epoch_stream(dataset, row_arrays, batch_size):
    """An SGD epoch as a block stream: ``(read, n_stream_blocks)``. Blocks
    hold whole batches (``block_rows % batch_size == 0`` unless there is
    one block); the last block carries the epoch's wrap rows, the
    resident scan's ``arange(padded) % n`` tail: global rows ``j % n``
    for ``j < wrap``, the dataset's head, which a dataset smaller than
    one batch cycles (it is then one block, so block 0 holds every row
    the cycle touches). A whole last block with a wrap (one block that
    is not whole batches) is that tail too."""
    R, n = dataset.block_rows, dataset.n_rows
    if R % batch_size and dataset.n_blocks > 1:
        raise ValueError(
            f"streamed SGD needs block_rows ({R}) divisible by "
            f"batch_size ({batch_size}) so mini-batches never straddle "
            "blocks; rebuild the ChunkedDataset with an aligned "
            "block_rows")
    base = _make_block_read(dataset, row_arrays, pad=False)
    full = n // R
    rem = n - full * R
    if rem == 0 and n % batch_size:
        full, rem = full - 1, R
    wrap_tree = None
    if rem:
        wrap = -(-rem // batch_size) * batch_size - rem
        if wrap:
            head = base(0)
            idx = np.arange(wrap) % min(rem if full == 0 else R, n)
            wrap_tree = {k: (PackedX(v.idx[idx], v.val[idx], v.n_cols)
                             if isinstance(v, PackedX) else np.asarray(v)[idx])
                         for k, v in head.items()}

    def read(i):
        tree = base(i)
        if wrap_tree is not None and i == full:
            tree = {k: (PackedX(np.concatenate([v.idx, wrap_tree[k].idx]),
                                np.concatenate([v.val, wrap_tree[k].val]),
                                v.n_cols)
                        if isinstance(v, PackedX)
                        else np.concatenate([v, wrap_tree[k]]))
                    for k, v in tree.items()}
        return tree

    return read, full + (1 if rem else 0)


def _fit_sgd_stream(est_cls, meta, static, dataset, row_arrays, hyper,
                    task, derive, device, sync, stats, w_init, feeder):
    """Epochs as block streams through the resident scan and epoch end
    (module docstring). The SGD feed reads unpadded blocks and the wrap
    tail, so it opens a cycling feeder of its own (``feeder`` is not
    used)."""
    st = dict(static)
    args = est_cls._solve_args(static)
    bs, max_epochs = args["batch_size"], int(args["max_epochs"])
    read, n_stream = _sgd_epoch_stream(dataset, row_arrays, bs)
    problem = est_cls._build_fit_problem(meta, static)
    tree = _place_task(hyper, task, device)
    tol = tree["hyper"]["tol"]
    zero = _zero_block(dataset, row_arrays, device)
    op0 = LinearOperator(zero["X"], st["fit_intercept"], sort_columns=False)
    pb0 = problem(op0, *derive(zero, tree), tree["hyper"])
    w0 = pb0["W0"]
    if w_init is not None:
        w0 = torch.as_tensor(np.asarray(w_init, np.float32),
                             device=w0.device).reshape(w0.shape)
    carry = sgd_carry_init(w0)
    n_batches = -(-dataset.n_rows // bs)
    with BlockFeeder(read, n_stream, device, sync=sync, stats=stats,
                     cycle=True) as fd, exact_matmuls():
        for e in range(max_epochs):
            if bool(carry["done"].all()):
                break
            _count(stats, "epochs")
            quad = sgd_scan_start(carry)
            try:
                for _ in range(n_stream):
                    i, block = fd.next()
                    t0 = time.perf_counter()
                    op = LinearOperator(block["X"], st["fit_intercept"],
                                        sort_columns=False)
                    pb = problem(op, *derive(block, tree), tree["hyper"])
                    rows = (draws.block_permutation(args["seed"], e, i, op.n,
                                                    device)
                            if args["shuffle"]
                            else torch.arange(op.n, device=device))
                    nb, batch = pb["batches"](rows.expand(w0.shape[0], -1))
                    quad = sgd_batch_scan(pb["grad_fn"], pb["lr_fn"],
                                          pb["post_step"], pb["loss_fn"],
                                          quad, nb, batch)
                    stats["steps"] += nb
                    stats["dispatch_s"] += time.perf_counter() - t0
            except BaseException:
                fd.seek(0)
                raise
            carry = sgd_epoch_end(carry, quad, n_batches, max_epochs, tol,
                                  args["n_iter_no_change"])
        params = pb0["unpack"](carry["w"], carry["n_done"])
    return {k: v.cpu().numpy() for k, v in params.items()}


_KINDS = {"lbfgs": _fit_lbfgs_stream, "gram": _fit_gram_stream,
          "sgd": _fit_sgd_stream}


def _check_kind(est_cls):
    """The family's streamed fit kind; the boosting kind is not ported."""
    kind = getattr(est_cls, "_stream_fit_kind", None)
    if kind is None:
        raise TypeError(
            f"{est_cls.__name__} has no out-of-core fit path "
            "(_stream_fit_kind is unset); materialise the dataset or use a "
            "family with a streamed fit (the linear families)")
    if kind not in _KINDS:
        raise NotImplementedError(
            f"{est_cls.__name__}.fit over a ChunkedDataset (the streamed "
            f"{kind} kind) is not ported to skdist_tpu_torch yet (see "
            "ROADMAP.md, queue 1 item 9c)")
    return kind


def stream_hyper_names(est_cls):
    """The names a streamed fit's ``hyper`` carries: the family's
    ``_hyper_names``, and ``alpha`` for the ridge family, whose solve
    reads it where it is not a hyperparameter (``LinearRegression``'s
    fixed 0.0)."""
    names = list(est_cls._hyper_names)
    if est_cls._stream_fit_kind == "gram" and "alpha" not in names:
        names.append("alpha")
    return names


def stream_hyper(est, n_lanes):
    """``n_lanes`` copies of ``est``'s :func:`stream_hyper_names` values as
    float32 ``(n_lanes,)`` arrays."""
    from .linear import hyper_float

    return {name: np.full(n_lanes, hyper_float(getattr(est, name)),
                          np.float32)
            for name in stream_hyper_names(type(est))}


def stream_fit_tasks(est_cls, meta, static, dataset, row_arrays, hyper,
                     device, sync=False, stats=None, w_init=None, task=None,
                     derive=None, feeder=None):
    """Fit ``T`` tasks of ``est_cls`` (``hyper``: each ``_hyper_names``
    entry a ``(T,)`` array, and ``alpha`` for the ridge family) over
    ``dataset`` with the family's streamed fit, on ``device``.
    ``task`` holds other ``(T,)`` lane arrays and ``derive(block, task)
    -> (y, sw)`` the lanes' labels and weights (module docstring;
    :func:`default_derive` without one). ``w_init`` (``(T, width)``
    flat-layout seeds) starts the iterative fits there (warm start; the
    ridge family ignores it). ``feeder`` is an :func:`open_feeder` feeder
    of ``row_arrays`` that the caller shares with a later scoring pass
    (one is opened and closed here otherwise). Returns the stacked
    ``(T, ...)`` fitted params as host arrays; ``stats``
    (:func:`new_stream_stats`) gathers the feed's and the passes'
    counts."""
    fit = _KINDS[_check_kind(est_cls)]
    device = torch.device(device)
    if stats is None:
        stats = new_stream_stats(sync)
    stats["tasks"] += int(np.asarray(next(iter(hyper.values()))).shape[0])
    own = feeder is None and fit is not _fit_sgd_stream
    if own:
        feeder = open_feeder(dataset, row_arrays, device, sync, stats)
    try:
        return fit(est_cls, meta, static, dataset, row_arrays, hyper, task,
                   derive or default_derive, device, sync, stats, w_init,
                   feeder)
    finally:
        if own:
            feeder.close()


def stream_scores(est_cls, meta, static, dataset, row_arrays, task, params,
                  scorer_specs, weight_fns, device, sync=False, stats=None,
                  feeder=None):
    """Score fitted lanes over ``dataset`` in one streamed pass:
    ``params`` are the stacked ``(T, ...)`` fitted params (host arrays),
    ``scorer_specs`` ``[(out_name, metric)]`` over
    :data:`~skdist_tpu_torch.metrics.STREAM_SCORERS`, and ``weight_fns``
    maps an output prefix (``"test"``, ``"train"``) to ``fn(block, task)
    -> (T, rows)`` weights (``task``: the lanes' ``(T,)`` host arrays,
    placed). Each block runs the family's decision kernel (K1 on packed
    blocks) and its proba kernel only where a metric needs it, and adds
    each metric's statistics in place on the device, in block order; the
    host combines each lane in float64. Returns ``{f"{prefix}_{name}":
    (T,) float64}``. ``feeder`` as in :func:`stream_fit_tasks`."""
    from ..metrics import STREAM_SCORERS

    device = torch.device(device)
    if stats is None:
        stats = new_stream_stats(sync)
    decision = est_cls._build_decision_kernel(meta, static)
    proba = (est_cls._build_proba_kernel(meta, static)
             if any(STREAM_SCORERS[m][2] == "proba" for _n, m in scorer_specs)
             else None)
    W = torch.as_tensor(np.asarray(est_cls._decision_params(params),
                                   np.float32), device=device)
    lanes = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in task.items()}
    keys = []

    def part(block):
        outputs = {"decision": decision(W, block["X"])}
        outputs["predict"] = outputs["decision"]
        if proba is not None:
            outputs["proba"] = proba(W, block["X"])
        out = []
        keys.clear()
        for prefix, wfn in weight_fns.items():
            wv = wfn(block, lanes)
            for name, metric in scorer_specs:
                kernel, _combine, kind = STREAM_SCORERS[metric]
                for stat, v in kernel(block["y"], outputs[kind], wv,
                                      meta).items():
                    keys.append((f"{prefix}_{name}", metric, stat))
                    out.append(v)
        return tuple(out)

    own = feeder is None
    if own:
        feeder = open_feeder(dataset, row_arrays, device, sync, stats)
    _count(stats, "score_passes")
    try:
        with exact_matmuls(), torch.no_grad():
            acc = _streamed_sum(part, feeder, stats)
    finally:
        if own:
            feeder.close()
    parts = {}
    for (key, metric, stat), v in zip(keys, acc):
        parts.setdefault((key, metric), {})[stat] = v.cpu().numpy()
    out = {}
    for (key, metric), stat in parts.items():
        combine = STREAM_SCORERS[metric][1]
        T = next(iter(stat.values())).shape[0]
        out[key] = np.asarray([
            combine({s: v[t] for s, v in stat.items()}, meta)
            for t in range(T)], dtype=np.float64)
    return out


def stream_fit_estimator(est, dataset, y=None, sample_weight=None,
                         coef_init=None, intercept_init=None, sync=False):
    """``est.fit(dataset)`` out of core: labels and weights from the
    dataset unless given, blocks streamed through the feeder on the
    estimator's device (the card unless ``device="cpu"``), the fitted
    state set as a resident fit sets it. ``coef_init``/``intercept_init``
    (scikit-learn's shapes) warm-start the iterative families (the ridge
    family accepts and ignores them). The fit's stats
    (:func:`new_stream_stats`) are kept as ``est.stream_stats_``."""
    from .linear import _freeze

    _check_kind(type(est))
    if getattr(est, "engine", None) == "host":
        raise ValueError(
            "engine='host' cannot fit a ChunkedDataset: the f64 host "
            "engine needs X resident. Use engine='auto' or 'xla' for the "
            "streamed fit.")
    device = resolve_device(est.device)
    if y is None:
        y = dataset.load_y()
    if sample_weight is None:
        sample_weight = dataset.load_sw()
    y_enc, sw, meta = est._prep_stream_fit(dataset, y, sample_weight)
    static = _freeze(est._static_config(meta))
    w_init = None
    if coef_init is not None or intercept_init is not None:
        k = meta.get("n_classes", 2)
        w_init = est._warm_w0_flat(meta["n_features"], 1 if k <= 2 else k,
                                   coef_init, intercept_init)[None]
    stats = new_stream_stats(sync)
    params = stream_fit_tasks(type(est), meta, static, dataset,
                              {"y": y_enc, "sw": sw}, stream_hyper(est, 1),
                              device, sync=sync, stats=stats, w_init=w_init)
    est._set_fitted({k: v[0] for k, v in params.items()}, meta)
    est.stream_stats_ = stats
    return est
