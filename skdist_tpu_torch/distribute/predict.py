"""
Batch prediction of the port: :func:`batch_predict`,
:func:`get_prediction_udf` and :func:`device_predict_plan`.

Counterpart of ``skdist_tpu/distribute/predict.py``:

- :func:`device_predict_plan` is the one construction of a fitted port
  estimator's block-inference program: its decision or proba kernel, the
  fitted arrays that kernel reads, and how raw outputs become the
  method's answer. A model without the kernels (a forest, the multiclass
  meta-estimators, a tree's ``predict_proba``, any duck-typed model) has
  no plan.
- :func:`batch_predict` runs a plan over row blocks on the backend's
  device, with the fitted arrays placed once a call. The last block is
  padded by repeating the last row; every block has one shape, and the
  padding is sliced off. Sparse rows are packed
  (:func:`~skdist_tpu_torch.sparse.pack_csr_rows`) and a linear model's
  kernel runs on each packed row block through K1 (``packed_matvec``),
  the function its own ``predict_proba`` computes on sparse X; a kernel
  that takes dense blocks gets each packed block rebuilt on the device.
  Models without a plan are cut into ``batch_size`` chunks of their own
  method, fanned out by ``backend.run_tasks``.
- a :class:`~skdist_tpu_torch.data.ChunkedDataset` streams: its blocks
  come through the block feeder (pinned host buffers and a copy stream on
  the card) into the same plan's kernel, K1 for a linear model over
  packed blocks, and only the outputs gather on the host; a model without
  a plan takes a serial host loop over the blocks.
- :func:`get_prediction_udf` wraps either path as a columnar function in
  the JAX package's three layouts ('numpy', 'pandas', 'text'). The port
  returns numpy, not ``pandas.Series`` (the card's machine has no
  pandas): ``predict`` gives a 1-D array, ``predict_proba`` a 1-D object
  array with one row of probabilities (a float32 array in ``classes_``
  order) an input row.

Only float32 plans are ported: the bfloat16 and int8 serve tiers wait
for ``serve/quantize.py`` (ROADMAP Queue 1 item 12).
"""

import numpy as np
import torch

from ..data import is_chunked, packed_block_dense
from ..models.linear import _freeze, as_dense_f32
from ..parallel import LocalBackend, resolve_backend
from ..parallel.backend import BlockFeeder
from ..sparse import (
    PackedX,
    is_sparse_2d,
    max_nnz_per_row,
    pack_csr_rows,
    packed_to_dense,
)
from ..utils.device import exact_matmuls
from ..utils.meminfo import densify_budget_bytes
from ..utils.validation import num_samples

__all__ = ["DevicePredictPlan", "batch_predict", "device_predict_plan",
           "get_prediction_udf"]

#: the ceiling of the default block size (and the CPU's default, where
#: the device reports no free memory)
_MAX_DEFAULT_BATCH = 1 << 18


class DevicePredictPlan:
    """A fitted estimator's block-inference program: ``kernel(params,
    X)`` over a device block ``X`` (a dense tensor, or a ``PackedX`` when
    ``packed``), ``params`` the fitted arrays it reads (host numpy,
    placed by the caller), and :meth:`postprocess` for the method's
    answer."""

    __slots__ = ("model", "method", "kernel", "params", "packed",
                 "n_features", "out_width", "row_bytes")

    def postprocess(self, out):
        """Raw kernel outputs as the method's answer (a classifier's
        ``predict`` maps them to ``classes_``)."""
        return _postprocess_predict(self.model, out, self.method)


#: the methods a device plan serves, and the kernel each runs
_PLAN_KERNELS = {"predict": "decision", "decision_function": "decision",
                 "predict_proba": "proba", "predict_log_proba": "proba"}


def device_predict_plan(model, method="predict", serve_dtype="float32"):
    """The :class:`DevicePredictPlan` of a fitted port estimator for
    ``method``, or None for a model without the kernels and for a method
    no kernel serves: it reads the model's ``_static_config``, its
    ``_build_decision_kernel`` (``predict``, ``decision_function``) or
    ``_build_proba_kernel`` (``predict_proba``, ``predict_log_proba``)
    and the fitted arrays of ``_kernel_params``."""
    if serve_dtype != "float32":
        if serve_dtype in ("bfloat16", "int8"):
            raise NotImplementedError(
                f"serve_dtype={serve_dtype!r} needs serve/quantize.py, which "
                "is not ported to skdist_tpu_torch yet (see ROADMAP.md, "
                "queue 1 item 12)")
        raise ValueError(f"unknown serve_dtype {serve_dtype!r}")
    which = _PLAN_KERNELS.get(method)
    if which is None or (which == "proba"
                         and not hasattr(model, "predict_proba")):
        # another method, or probabilities the model does not give (an
        # SGD classifier's hinge loss): host chunks of the method itself
        return None
    build_kernel = getattr(type(model), f"_build_{which}_kernel", None)
    if build_kernel is None or not all(
            hasattr(model, a) for a in ("_params", "_meta", "_static_config",
                                        "_kernel_params")):
        return None
    static = _freeze(model._static_config(model._meta))
    plan = DevicePredictPlan()
    plan.model = model
    plan.method = method
    plan.kernel = build_kernel(model._meta, static)
    plan.params = model._kernel_params()
    plan.packed = bool(getattr(type(model), "_supports_packed_X", False))
    plan.n_features = int(model._meta["n_features"])
    classes = getattr(model, "classes_", None)
    plan.out_width = len(classes) if classes is not None else 1
    # a row's input and output as float32, and what the kernel holds a
    # row beside them (``_plan_row_bytes``: a boosted bank's node ids)
    extra = getattr(type(model), "_plan_row_bytes", None)
    plan.row_bytes = 4 * (plan.n_features + plan.out_width) + (
        int(extra(model._meta, static)) if extra is not None else 0)
    return plan


def _resolve_predict_backend(backend, model):
    """``backend=None`` is a serial :class:`LocalBackend` on the model's
    ``device`` (the card unless the model says ``"cpu"``)."""
    if backend is None:
        return LocalBackend(device=getattr(model, "device", None))
    return resolve_backend(backend)


def batch_predict(model, X, method="predict", backend=None, batch_size=None,
                  _plan=None):
    """``model.<method>(X)`` in row blocks: through the model's
    :func:`device_predict_plan` on the backend's device, or, for a model
    without one, in host chunks fanned out by ``backend.run_tasks``.
    ``_plan`` lets a long-lived caller (the prediction UDF) pass a plan
    built once. A ChunkedDataset ``X`` streams block by block
    (:func:`_batch_predict_chunked`; ``batch_size`` is its block size)."""
    fn = getattr(model, method)  # a model without the method raises here
    backend = _resolve_predict_backend(backend, model)
    if _plan is None:
        _plan = device_predict_plan(model, method)
    if is_chunked(X):
        return _batch_predict_chunked(model, X, method, backend, _plan)
    n = num_samples(X)
    if batch_size is None:
        batch_size = _default_batch_size(n, backend, _plan)

    if _plan is not None and is_sparse_2d(X):
        return _predict_sparse(X, backend, batch_size, _plan)

    groups = _sparse_row_groups(X, n)
    if groups is not None:
        # sparse rows bound for a host model whose dense whole would not
        # fit the memory budget: each group's densified rows do
        X = X.tocsr()
        return np.concatenate([
            batch_predict(model, X[i:j], method=method, backend=backend,
                          batch_size=batch_size, _plan=_plan)
            for i, j in groups
        ], axis=0)

    if _plan is not None:
        return _predict_dense(as_dense_f32(X), backend, batch_size, _plan)

    if n <= batch_size:
        return np.asarray(fn(X))
    chunks = [
        (X.iloc[i:i + batch_size] if hasattr(X, "iloc")
         else X[i:i + batch_size])
        for i in range(0, n, batch_size)
    ]
    outs = backend.run_tasks(lambda c: np.asarray(fn(c)), chunks)
    return np.concatenate(outs, axis=0)


def _default_batch_size(n, backend, plan):
    """Rows a block by default: what the backend's free device memory
    fits, each row billed the plan's ``row_bytes`` (its input and output
    as float32, and what the model's kernel holds a row beside them), at
    most ``1 << 18``. With no memory reading (the CPU, a model without a
    plan) it is ``1 << 18``."""
    cap = None
    if plan is not None and hasattr(backend, "round_cap"):
        cap = backend.round_cap(plan.row_bytes)
    size = _MAX_DEFAULT_BATCH if cap is None else min(_MAX_DEFAULT_BATCH,
                                                       int(cap))
    return max(1, min(n, size))


def _rows(a, lo, block):
    """Rows ``lo:lo + block`` of ``a``; the last block is filled to
    ``block`` rows by repeating ``a``'s last row, so every block has one
    shape and only that block is copied."""
    rows = a[lo:lo + block]
    short = block - rows.shape[0]
    if short:
        rows = np.concatenate([rows, np.repeat(a[-1:], short, axis=0)])
    return rows


def _run_blocks(plan, backend, n, batch_size, to_device):
    """The plan's kernel over ``n`` rows in blocks of ``batch_size``,
    ``to_device(lo, block)`` the device block of the rows from ``lo``, the
    fitted arrays placed once, under full-float32 matmuls; the host
    outputs concatenated, the padding sliced off, and post-processed."""
    block = max(1, min(batch_size, n))
    params = backend.place(plan.params)
    outs = []
    with exact_matmuls(), torch.no_grad():
        for lo in range(0, n, block):
            outs.append(plan.kernel(params, to_device(lo, block))
                        .cpu().numpy())
    return plan.postprocess(np.concatenate(outs, axis=0)[:n])


def _predict_dense(X, backend, batch_size, plan):
    """The resident dense path: one kernel call a block, the last block
    padded by repeating the last row, padding sliced off."""
    n, d = X.shape
    if d != plan.n_features:
        raise ValueError(f"X has {d} features; the model was fitted on "
                         f"{plan.n_features}")
    device = backend.device

    def to_device(lo, block):
        return torch.as_tensor(_rows(X, lo, block)).to(device)

    return _run_blocks(plan, backend, n, batch_size, to_device)


def _predict_sparse(X, backend, batch_size, plan):
    """The sparse path: pack the rows (checking the memory budget before
    packing, which allocates about three times the pair), then run the
    plan's kernel on each packed row block, through K1 for a linear
    model; a kernel that takes dense blocks gets each block rebuilt on
    the device."""
    X = X.tocsr()
    n, d = X.shape
    if d != plan.n_features:
        raise ValueError(f"X has {d} features; the model was fitted on "
                         f"{plan.n_features}")
    m = max_nnz_per_row(X)
    budget, _ = densify_budget_bytes()
    if budget is not None and n * m * 8 > budget // 2:
        rows = max(1, int(budget // 8) // max(m * 8, 1))
        if rows < n:
            return np.concatenate([
                _predict_sparse(X[i:min(i + rows, n)], backend, batch_size,
                                plan)
                for i in range(0, n, rows)
            ], axis=0)
    idx, val = pack_csr_rows(X)
    device = backend.device

    def to_device(lo, block):
        packed = PackedX(_rows(idx, lo, block), _rows(val, lo, block),
                         d).to(device)
        if plan.packed:
            return packed
        return packed_to_dense(packed.idx, packed.val, d)

    return _run_blocks(plan, backend, n, batch_size, to_device)


def _batch_predict_chunked(model, dataset, method, backend, plan):
    """Stream a ChunkedDataset through the plan's kernel: the blocks
    (padded to one shape) come through the :class:`BlockFeeder` one ahead
    of their launch, each block runs the kernel the resident path runs on
    a block of that shape (K1 for a linear model over packed blocks, which
    computes each row alone), so the rows equal the resident path's at a
    ``batch_size`` of the dataset's ``block_rows``; a block's output is
    read back while the next block runs, and only the outputs gather on
    the host. A model without a plan takes a serial loop over the blocks
    through its own ``method``: bounded host memory, no device kernel.
    The feed's stats are ``backend.last_round_stats``."""
    if plan is None:
        fn = getattr(model, method)
        outs = []
        for i in range(dataset.n_blocks):
            b = dataset.read_block(i, pad=False)
            Xb = b.X
            if isinstance(Xb, PackedX):  # scipy CSR for a host model
                from scipy import sparse as sp

                Xb = sp.csr_matrix(packed_block_dense(Xb, b.n_real))
            outs.append(np.asarray(fn(Xb)))
        return np.concatenate(outs, axis=0)
    d = dataset.n_features
    if d != plan.n_features:
        raise ValueError(f"the dataset has {d} features; the model was "
                         f"fitted on {plan.n_features}")
    stats = backend.last_round_stats = {"mode": "streamed_predict",
                                        "tasks": dataset.n_blocks}
    feeder = BlockFeeder(lambda i: {"X": dataset.read_block(i, pad=True).X},
                         dataset.n_blocks, backend.device, stats=stats)
    params = backend.place(plan.params)
    outs, pending = [], None
    with exact_matmuls(), torch.no_grad():
        try:
            for i, block in feeder:
                X = block["X"]
                if isinstance(X, PackedX) and not plan.packed:
                    X = packed_to_dense(X.idx, X.val, d)
                start, stop = dataset.block_range(i)
                out = plan.kernel(params, X)[: stop - start]
                if pending is not None:
                    outs.append(pending.cpu().numpy())
                pending = out
        finally:
            feeder.close()
    outs.append(pending.cpu().numpy())
    return plan.postprocess(np.concatenate(outs, axis=0))


def _postprocess_predict(model, out, method):
    if method == "predict_log_proba":
        # the model's own log (models/linear.py _ProbaMixin)
        return np.log(np.clip(out, 1e-15, None))
    if method == "predict" and getattr(model, "_estimator_type",
                                       None) == "classifier":
        idx = (out > 0).astype(np.int64) if out.ndim == 1 else \
            np.argmax(out, axis=1)
        return model.classes_[idx]
    return out


def _sparse_row_groups(X, n):
    """Row groups ``[(start, stop), ...]`` of a 2-D sparse X whose dense
    whole would not fit the memory budget (each group about 1/8 of it);
    None when X is not sparse or fits."""
    if not is_sparse_2d(X):
        return None
    budget, _ = densify_budget_bytes()
    if budget is None:
        return None
    d = int(X.shape[1])
    if int(n) * d * 4 <= budget // 2:
        return None
    rows = max(1, int(budget // 8) // max(d * 4, 1))
    if rows >= n:
        return None
    return [(i, min(i + rows, n)) for i in range(0, n, rows)]


# ---------------------------------------------------------------------------
# the columnar prediction function
# ---------------------------------------------------------------------------

def _get_vals(cols, feature_type, names):
    """The feature matrix of the column arrays: 'numpy' and 'pandas'
    stack them as columns ('pandas' names each, in ``names`` order),
    'text' takes its one column of documents."""
    if feature_type == "numpy":
        return np.column_stack([np.asarray(c) for c in cols])
    if feature_type == "pandas":
        if names is None:
            raise ValueError("feature_type='pandas' requires names")
        if len(names) != len(cols):
            raise ValueError(f"{len(cols)} columns for {len(names)} names")
        return np.column_stack([np.asarray(c) for c in cols])
    if feature_type == "text":
        if len(cols) != 1:
            raise ValueError("feature_type='text' expects exactly one column")
        return np.asarray(cols[0])
    raise ValueError(f"Unknown feature_type: {feature_type!r}")


def get_prediction_udf(model, method="predict", feature_type="numpy",
                       names=None, backend=None, batch_size=None):
    """A columnar prediction function ``predict_func(*cols)``: the
    columns (arrays, or anything ``np.asarray`` takes) assembled by
    ``feature_type`` and predicted through :func:`batch_predict`.
    ``predict`` returns a 1-D array; ``predict_proba`` a 1-D object array
    whose rows are float32 arrays in ``classes_`` order (the JAX
    package's list-valued rows)."""
    if method not in ("predict", "predict_proba"):
        raise ValueError("method must be 'predict' or 'predict_proba'")
    if not hasattr(model, method):
        raise ValueError(f"model has no {method} method")
    return _PredictionUDF(model, method, feature_type, names, backend,
                          batch_size)


class _PredictionUDF:
    """The callable :func:`get_prediction_udf` returns. The resolved
    backend and the plan are built once a process and reused across
    calls, keyed on the identity of the model's fitted ``_params`` (a
    refit replaces it, so a refit model is never served through a stale
    plan). It pickles without them (``__getstate__``); the other process
    resolves them at its first call, so pass ``backend`` as None or a
    name, not a live backend, for a picklable function."""

    def __init__(self, model, method, feature_type, names, backend,
                 batch_size):
        self.model = model
        self.method = method
        self.feature_type = feature_type
        self.names = names
        self.backend = backend
        self.batch_size = batch_size
        self._runtime = None

    def _ensure_runtime(self):
        params = getattr(self.model, "_params", None)
        runtime = self._runtime
        if runtime is None or runtime[2] is not params:
            runtime = self._runtime = (
                _resolve_predict_backend(self.backend, self.model),
                device_predict_plan(self.model, self.method),
                params,
            )
        return runtime

    def __call__(self, *cols):
        backend, plan, _ = self._ensure_runtime()
        X = _get_vals(cols, self.feature_type, self.names)
        out = np.asarray(batch_predict(
            self.model, X, method=self.method, backend=backend,
            batch_size=self.batch_size, _plan=plan))
        if self.method == "predict_proba":
            rows = np.empty(len(out), dtype=object)
            for i, row in enumerate(out):
                rows[i] = row
            return rows
        return out

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_runtime"] = None
        return state
