"""
Streamed (out-of-core) fits: the linear families' L-BFGS solve over a
:class:`~skdist_tpu_torch.data.ChunkedDataset`, block by block.

Counterpart of the ``"lbfgs"`` kind of ``skdist_tpu/models/streaming.py``
(``LogisticRegression``, ``LinearSVC``). Their objective's data term is
row-additive, so one evaluation of the loss and its gradient at an
iterate is a streamed reduction: the blocks come through the block feeder
(:class:`~skdist_tpu_torch.parallel.backend.BlockFeeder`: pinned host
buffers and a copy stream on the card), each block's data term is the
resident problem's own expression on that block (through the same
:class:`~skdist_tpu_torch.sparse.LinearOperator`, dense or packed; on
packed blocks the forward is K1 and the gradient's backward K2), the
partial sums accumulate on the device in block order, and the
regulariser is added once. The solver is the resident one,
:func:`~skdist_tpu_torch.models.solvers.lbfgs_minimize`, driven with the
streamed value pass as its ``fun`` (each Armijo probe is one pass, K1
only) and the streamed value-and-gradient pass as its ``vg``: the same
constants, direction rule, curvature filter and stopping rule lane for
lane, with its state on the device. The JAX package runs a numpy copy of
that state machine on the host instead.

The block order is fixed, so a serial feed (``sync=True``) and the
pipelined one give the same bits. Block sums reorder the float32
reductions of the resident fit, so a streamed fit agrees with the
resident one to rounding, not bitwise.

Not ported yet (ROADMAP Queue 1 item 9b): the gram and SGD kinds,
``stream_scores``, the streamed search and one-vs-rest; item 9c: the
streamed boosting fit; item 10: the block retries, the rung hook and the
elastic replans. A fault in a streamed pass raises.
"""

import time

import numpy as np
import torch

from ..parallel.backend import BlockFeeder
from ..sparse import LinearOperator, PackedX
from ..utils.device import exact_matmuls, resolve_device
from .solvers import lbfgs_minimize

__all__ = ["StreamedObjective", "stream_fit_estimator", "stream_fit_tasks"]


def _make_block_read(dataset, row_arrays):
    """``read(i) -> host block tree``: the dataset's padded X block with
    the fit's own per-row vectors (encoded labels, weights) sliced to
    the block's global rows and padded with zeros (a weight of 0, and
    label 0, a valid class whose row weighs nothing)."""

    def read(i):
        b = dataset.read_block(i)
        tree = {"X": b.X}
        pad_n = dataset.block_rows - b.n_real
        for name, arr in row_arrays.items():
            sl = np.asarray(arr[b.start:b.stop])
            if pad_n:
                sl = np.concatenate([
                    sl, np.zeros((pad_n,) + sl.shape[1:], sl.dtype)])
            tree[name] = sl
        return tree

    return read


def new_stream_stats(sync):
    """The stats dict of a streamed fit: the feeder's keys
    (:class:`BlockFeeder`) and the passes run: ``value_passes`` (the
    Armijo probes, K1 only on packed blocks), ``grad_passes`` (value and
    gradient, K1 and K2), ``passes`` (their sum) and ``dispatch_s`` (the
    consumer's time on the blocks' work, launches included)."""
    return {"mode": "streamed", "stream_mode": "serial" if sync
            else "pipelined", "tasks": 0, "passes": 0, "value_passes": 0,
            "grad_passes": 0, "dispatch_s": 0.0}


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
            stats["dispatch_s"] += time.perf_counter() - t0
    except BaseException:
        feeder.seek(0)
        raise
    return acc


class StreamedObjective:
    """The objective of ``T`` L-BFGS fits of ``est_cls`` over a
    ``dataset``, evaluated by streamed passes on ``device``.

    ``row_arrays`` maps per-row vector names (``y`` the encoded labels,
    ``sw`` the weights, ``(n_rows,)`` host arrays) to what is sliced per
    block; ``hyper`` maps each ``_hyper_names`` entry to a ``(T,)``
    array. :meth:`value` is one value pass (``(T,)``), :meth:`value_and_grad`
    one value-and-gradient pass (``(T,)``, ``(T, P)``), both with the
    regulariser added once; ``w0`` is the problem's zero start and
    ``unpack`` its fitted-params shaper. Every pass takes its blocks from
    one cycling :class:`BlockFeeder` (one ring of pinned buffers and one
    copy stream for the whole fit; the next pass's first block is fed
    while the last one is in use); :meth:`close` stops it."""

    def __init__(self, est_cls, meta, static, dataset, row_arrays, hyper,
                 device, sync=False, stats=None):
        st = dict(static)
        self.problem = est_cls._build_fit_problem(meta, static)
        self.fit_intercept = st["fit_intercept"]
        self.matmul_dtype = st.get("matmul_dtype")
        self.dataset = dataset
        self.device = torch.device(device)
        self.stats = stats if stats is not None else new_stream_stats(sync)
        self.feeder = BlockFeeder(_make_block_read(dataset, row_arrays),
                                  dataset.n_blocks, self.device, sync=sync,
                                  stats=self.stats, cycle=True)
        self.hyper = {k: torch.as_tensor(np.asarray(v, np.float32),
                                         device=self.device)
                      for k, v in hyper.items()}
        self.T = int(next(iter(self.hyper.values())).shape[0])
        # the regulariser, the zero start and the unpacking come from the
        # problem over one zero-weight row (none of them reads X)
        zero = self._zero_block(dataset, row_arrays)
        _loss, self.w0, self.unpack, _data, self.reg_loss = self._parts(zero)

    def _zero_block(self, dataset, row_arrays):
        if dataset.x_format == "packed":
            X = PackedX.checked_copy(
                torch.zeros((1, dataset.packed_m), dtype=torch.int32,
                            device=self.device),
                torch.zeros((1, dataset.packed_m), dtype=torch.float32,
                            device=self.device), dataset.n_features)
        else:
            X = torch.zeros((1, dataset.n_features), dtype=torch.float32,
                            device=self.device)
        tree = {"X": X}
        for name, arr in row_arrays.items():
            tree[name] = torch.zeros(1, dtype=torch.from_numpy(
                np.asarray(arr[:0])).dtype, device=self.device)
        return tree

    def _parts(self, block, grad=False):
        """The problem's ``(loss, w0, unpack, data_loss, reg_loss)`` over
        one device block. Only a gradient pass's operator sorts the
        columns K2 reads, and up front, before the forward's activations
        exist (the sort's temporaries are the block's largest); a value
        pass runs K1 alone."""
        op = LinearOperator(block["X"], self.fit_intercept,
                            matmul_dtype=self.matmul_dtype,
                            sort_columns=grad)
        sw = block["sw"][None].expand(self.T, -1)
        return self.problem(op, block["y"], sw, self.hyper, parts=True)

    def _count(self, kind):
        self.stats["passes"] += 1
        self.stats[kind] += 1

    def value(self, w):
        """The objective at ``w (T, P)``: one value pass, ``(T,)``."""
        self._count("value_passes")
        with torch.no_grad():
            (f,) = _streamed_sum(lambda block: (self._parts(block)[3](w),),
                                 self.feeder, self.stats)
            return f + self.reg_loss(w)

    def value_and_grad(self, w):
        """The objective and its gradient at ``w (T, P)``: one pass."""
        self._count("grad_passes")

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
        """Stop the feeder (a prefetched block is discarded)."""
        self.feeder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _check_kind(est_cls):
    """Only the ``"lbfgs"`` kind of streamed fit is ported."""
    kind = getattr(est_cls, "_stream_fit_kind", None)
    if kind != "lbfgs":
        raise NotImplementedError(
            f"{est_cls.__name__}.fit over a ChunkedDataset (the streamed "
            f"{kind or 'fit'} kind) is not ported to skdist_tpu_torch yet "
            "(see ROADMAP.md, queue 1 item 9b)")


def stream_fit_tasks(est_cls, meta, static, dataset, row_arrays, hyper,
                     device, sync=False, stats=None, w_init=None):
    """Fit ``T`` tasks of ``est_cls`` (``hyper``: each ``_hyper_names``
    entry a ``(T,)`` array) over ``dataset`` with the family's streamed
    fit, on ``device``. ``w_init`` (``(T, width)`` flat-layout seeds)
    starts the solves there (warm start). Returns the stacked ``(T,
    ...)`` fitted params as host arrays. Only the ``"lbfgs"`` kind is
    ported; ``stats`` (:func:`new_stream_stats`) gathers the feed's and
    the passes' counts."""
    _check_kind(est_cls)
    st = dict(static)
    obj = StreamedObjective(est_cls, meta, static, dataset, row_arrays,
                            hyper, device, sync=sync, stats=stats)
    obj.stats["tasks"] += obj.T
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


def stream_fit_estimator(est, dataset, y=None, sample_weight=None,
                         coef_init=None, intercept_init=None, sync=False):
    """``est.fit(dataset)`` out of core: labels and weights from the
    dataset unless given, blocks streamed through the feeder on the
    estimator's device (the card unless ``device="cpu"``), the fitted
    state set as a resident fit sets it. ``coef_init``/``intercept_init``
    (scikit-learn's shapes) warm-start the solve. The fit's stats
    (:func:`new_stream_stats`) are kept as ``est.stream_stats_``."""
    from .linear import _freeze, hyper_float

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
    hyper = {name: np.asarray([hyper_float(getattr(est, name))], np.float32)
             for name in type(est)._hyper_names}
    w_init = None
    if coef_init is not None or intercept_init is not None:
        k = meta.get("n_classes", 2)
        w_init = est._warm_w0_flat(meta["n_features"], 1 if k <= 2 else k,
                                   coef_init, intercept_init)[None]
    stats = new_stream_stats(sync)
    params = stream_fit_tasks(type(est), meta, static, dataset,
                              {"y": y_enc, "sw": sw}, hyper, device,
                              sync=sync, stats=stats, w_init=w_init)
    est._set_fitted({k: v[0] for k, v in params.items()}, meta)
    est.stream_stats_ = stats
    return est
