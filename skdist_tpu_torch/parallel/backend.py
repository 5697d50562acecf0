"""
Fan-out backends of the port: :class:`TaskBackend` and
:class:`CUDABackend`, the counterpart of ``TPUBackend``.

``batched_map`` runs a batched kernel over a task axis in rounds. The
JAX package ``vmap``s the task axis and sizes rounds to free HBM
(``hbm_round_cap``); here the kernel takes the task axis as a leading
batch dimension, shared data is placed on the device once, and each
round holds as many tasks as free device memory fits
(``torch.cuda.mem_get_info``, :meth:`CUDABackend.round_cap`). A round
that runs out of memory is a bug in the per-task estimate, not a retry.

``batched_map_iterative`` is the convergence-compacted path for
iterative kernels (:class:`IterativeKernelSpec`): solves advance in
slices of iterations, finished lanes leave their slots at slice
boundaries, and an adaptive :class:`RungController` may retire lanes
early (ASHA). :meth:`CUDABackend.batched_map_iterative` says where it
departs from the JAX package's mechanics (not from its results).

``run_tasks`` is the host fan-out of per-task closures (the generic
search path, host-model prediction chunks): a thread pool, as in the
JAX package. :class:`LocalBackend` is the JAX package's host backend:
its fan-out is serial unless ``n_jobs`` says otherwise, and its batched
calls run on its ``device`` as :class:`CUDABackend`'s do.
``reuse_broadcast=True`` keeps the device copies of large shared host
arrays across fits (:func:`_cached_put`).
:func:`resolve_backend` normalises a user's ``backend=`` argument.
:class:`BlockFeeder` is the host-to-device leg of the streaming data
plane: blocks of a ``ChunkedDataset`` read and copied one ahead of their
consumer through pinned host buffers and a copy stream.

Not ported yet (ROADMAP): elastic mode, fault retries (a fault in a
streamed pass raises), the streamed plans of a device mesh, AOT and the
device mesh.
"""

import math
import os
import threading
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..sparse import PackedX, would_pack
from ..utils.device import exact_matmuls, resolve_device

__all__ = [
    "TaskBackend", "CUDABackend", "LocalBackend", "resolve_backend",
    "parse_partitions", "IterativeKernelSpec", "RungController",
    "MIN_ITER_TASKS", "compaction_enabled", "resolve_slice_iters",
    "iterative_fit_supported", "iterative_chunk_size", "prefers_host_engine",
    "BlockFeeder", "tree_nbytes",
]


def prefers_host_engine(backend, estimator, X=None):
    """Whether a batched dispatch yields to the host fan-out because
    ``estimator`` runs its f64 host engine on ``backend``: an explicit
    ``engine='host'`` pin always (even on a device backend, whose host
    threads then run it: ignoring the pin would select candidates with
    one engine and refit the winner with another), and ``engine='auto'``
    only off a device backend, where the estimator resolves to the host
    engine (``_resolve_host_engine``: its device is the CPU), and only
    for an ``X`` that would not pack (packed X has no host form; the
    decision reads shape and ``indptr`` alone). Every batched gate (the
    searches, one-vs-rest and one-vs-one) asks this, so one estimator
    never runs two engines depending on which meta-estimator wraps
    it."""
    resolve = getattr(estimator, "_resolve_host_engine", None)
    if resolve is None:
        return False
    if getattr(estimator, "engine", None) == "host":
        return True
    if getattr(backend, "is_device_backend", False) or not resolve():
        return False
    return X is None or not (
        getattr(type(estimator), "_supports_packed_X", False)
        and would_pack(X))


def parse_partitions(partitions, n_tasks):
    """Tasks per round for a partition policy: 'auto'/None is one round
    (further cut to what device memory fits), an int is that many
    rounds."""
    if partitions == "auto" or partitions is None:
        return n_tasks
    return max(1, -(-n_tasks // int(partitions)))


class TaskBackend:
    """Interface for fan-out execution."""

    #: whether batched_map dispatches onto accelerator devices
    is_device_backend = False

    #: stats of the most recent batched_map call (rounds, tasks per
    #: round, round walls)
    last_round_stats = None

    def run_tasks(self, fn, tasks, verbose=0):
        """``[fn(t) for t in tasks]``, fanned out over host threads."""
        raise NotImplementedError

    def batched_map(self, kernel, task_args, shared, bytes_per_task=None,
                    round_size=None, return_timings=False,
                    bytes_per_round=0):
        raise NotImplementedError

    #: whether batched_map_iterative runs the convergence-compacted
    #: slice loop on this backend (False runs the spec's fallback)
    supports_iterative = False

    def batched_map_iterative(self, spec, task_args, shared,
                              bytes_per_task=None, round_size=None,
                              return_timings=False, bytes_per_round=0,
                              rung=None):
        """Convergence-compacted execution of an iterative kernel (see
        :class:`IterativeKernelSpec`). A backend without the slice loop
        runs the spec's fallback kernel through :meth:`batched_map`. That
        run is exhaustive, so an adaptive ``rung`` controller is
        deactivated (no lane is killed, and the caller warns)."""
        if spec.fallback is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no iterative slice loop and "
                "the spec carries no fallback kernel"
            )
        if rung is not None:
            rung.deactivate()
        return self.batched_map(
            spec.fallback, task_args, shared, bytes_per_task=bytes_per_task,
            round_size=round_size, return_timings=return_timings,
            bytes_per_round=bytes_per_round,
        )

    # fitted estimators must never hold a live backend; give pickle a
    # loud failure instead of a corrupt artifact
    def __reduce__(self):
        raise TypeError(
            f"{type(self).__name__} holds live runtime state and cannot be "
            "pickled; fitted estimators strip it automatically."
        )


class IterativeKernelSpec:
    """An iterative batched kernel in parts, the convergence-compacted
    scheduler's contract. Every part runs on a chunk-shaped batch of
    lanes (``task``: a dict tree of ``(chunk, ...)`` tensors) and a
    carry (a dict of ``(chunk, ...)`` tensors):

    - ``init(shared, task) -> carry``: start every lane's solve. The
      ``done_key`` leaf (bool) means "no further step changes this
      lane", and the ``iter_key`` leaf counts its iterations.
    - ``restart(shared, task, carry, slots) -> carry``: start the lanes
      at ``slots`` (an int64 tensor) afresh, in place, from ``task``'s
      rows there; the other lanes are untouched.
    - ``step(shared, task, carry) -> carry``: advance one slice.
    - ``finalize(shared, task, carry) -> {name: (chunk, ...) tensor}``:
      the outputs, from the ``finalize_keys`` leaves only.
    - ``score(shared, task, carry) -> (chunk,)`` (optional): the
      adaptive rung's quality readout of live carries, greater is
      better; it reads a carry and never changes it.
    - ``converged(shared, task, carry) -> (chunk,) bool`` and
      ``max_iter`` (optional): tell a lane that converged from one that
      stalled or ran out of iterations, for the round stats.
    - ``iter_key``: the carry leaf that counts a lane's iterations
      (``"it"``; SGD's epoch clock runs on in frozen lanes, so it names
      ``"n_done"``), read for the round stats.
    - ``fallback``: the classic all-iterations kernel with the same
      outputs, run when the slice loop cannot be.
    """

    __slots__ = ("init", "restart", "step", "finalize", "finalize_keys",
                 "done_key", "fallback", "score", "converged", "max_iter",
                 "iter_key")

    def __init__(self, init, restart, step, finalize, finalize_keys,
                 done_key="done", fallback=None, score=None, converged=None,
                 max_iter=None, iter_key="it"):
        self.init = init
        self.restart = restart
        self.step = step
        self.finalize = finalize
        self.finalize_keys = tuple(finalize_keys)
        self.done_key = done_key
        self.fallback = fallback
        self.score = score
        self.converged = converged
        self.max_iter = max_iter
        self.iter_key = iter_key


class RungController:
    """Host-side ASHA rung policy for the compacted slice loop
    (asynchronous successive halving, Li et al., MLSys 2020); a copy of
    the JAX package's.

    Every ``every`` slices the scheduler scores all live carries and
    hands the ``(lane_id, score)`` pairs to :meth:`decide`, which kills
    the bottom ``1 - 1/eta`` *groups* (a group is typically one
    candidate's CV-fold lanes, so a candidate's folds live and die
    together; ``groups=None`` makes every lane its own group). Killed
    lanes retire like converged ones.

    Scores are greater-is-better. Non-finite scores rank below every
    finite score. ``eta=inf`` scores every rung but never kills. Ties
    break toward the smaller group id.

    A downgrade to exhaustive execution calls :meth:`deactivate`, so the
    caller warns instead of reporting a race that never ran.
    """

    def __init__(self, eta=3.0, every=1, groups=None):
        eta = float(eta)
        if not eta > 1.0:
            raise ValueError(f"rung eta must be > 1 (got {eta!r})")
        every = int(every)
        if every < 1:
            raise ValueError(f"rung cadence must be >= 1 (got {every!r})")
        self.eta = eta
        self.every = every
        self.groups = None if groups is None else np.asarray(groups)
        #: lane id -> rung index at which the lane was killed
        self.killed = {}
        #: per rung: {"rung", "slice", "n_live", "n_groups", "n_killed"}
        self.history = []
        #: False once a downgrade ran the exhaustive fallback
        self.active = True

    def reset(self):
        self.killed = {}
        self.history = []

    def deactivate(self):
        """A downgrade to exhaustive execution: clear every verdict and
        mark the controller inactive."""
        self.reset()
        self.active = False

    def due(self, slice_idx):
        """Whether a rung fires after slice ``slice_idx`` (1-based)."""
        return slice_idx % self.every == 0

    def decide(self, live_ids, scores, slice_idx):
        """One rung: given the live lanes' ids and rung scores, pick the
        lanes to kill. Returns the killed lane ids (possibly empty) and
        records them in :attr:`killed` / :attr:`history`."""
        live_ids = np.asarray(live_ids)
        scores = np.asarray(scores, dtype=np.float64)
        rung = len(self.history)
        gids = (
            self.groups[live_ids] if self.groups is not None else live_ids
        )
        uniq, inv = np.unique(gids, return_inverse=True)
        n_groups = len(uniq)
        entry = {
            "rung": rung, "slice": int(slice_idx),
            "n_live": int(live_ids.size), "n_groups": int(n_groups),
            "n_killed": 0,
        }
        self.history.append(entry)
        if live_ids.size == 0 or not math.isfinite(self.eta):
            return live_ids[:0]
        # group score = mean over the group's live lanes; non-finite
        # lanes drag their group to -inf (kill divergence first)
        s = np.where(np.isfinite(scores), scores, -np.inf)
        gsum = np.zeros(n_groups)
        gcnt = np.zeros(n_groups)
        np.add.at(gsum, inv, s)
        np.add.at(gcnt, inv, 1.0)
        with np.errstate(invalid="ignore"):
            gmean = gsum / gcnt
        gmean = np.where(np.isfinite(gmean), gmean, -np.inf)
        # ceil(n_groups / eta) in float: eta is any real > 1
        n_keep = max(1, int(math.ceil(n_groups / self.eta)))
        if n_keep >= n_groups:
            return live_ids[:0]
        # sort by (-score, group id) and kill everything past the keep set
        order = np.lexsort((uniq, -gmean))
        killed_groups = uniq[order[n_keep:]]
        kill_mask = np.isin(gids, killed_groups)
        killed_ids = live_ids[kill_mask]
        for lid in killed_ids:
            self.killed[int(lid)] = rung
        entry["n_killed"] = int(killed_ids.size)
        return killed_ids


#: smallest task set the convergence-compacted path engages for: below
#: it the workload fits in one or two rounds and there is nothing to
#: compact (the classic kernel also stays the small parity tests' path)
MIN_ITER_TASKS = 24


def compaction_enabled():
    """The convergence-compacted path is on by default for estimators
    with iteration-sliced fits; ``SKDIST_COMPACTION=0`` switches back to
    the classic all-iterations path."""
    return os.environ.get("SKDIST_COMPACTION", "").strip().lower() not in (
        "0", "false", "no",
    )


def resolve_slice_iters(max_iter):
    """Iterations per slice: ``SKDIST_SLICE_ITERS`` when set, else about
    1/8 of the iteration budget (at least 4)."""
    env = os.environ.get("SKDIST_SLICE_ITERS", "").strip()
    if env:
        try:
            n = int(env)
        except ValueError:
            n = 0
        if n > 0:
            return n
    return max(4, -(-int(max_iter) // 8))


def iterative_fit_supported(backend, est_cls, n_tasks, max_iter):
    """The gate a batched call site asks before taking the compacted
    path: the slice size to use, or None for the classic kernel. It
    engages when the family has iteration-sliced fit kernels, the
    backend runs the slice loop, the task set spans several rounds and
    the iteration budget is worth slicing."""
    if not compaction_enabled():
        return None
    if not getattr(backend, "supports_iterative", False):
        return None
    if not getattr(est_cls, "_supports_sliced_fit", False):
        return None
    if not hasattr(est_cls, "_build_fit_slice_kernels"):
        return None
    if n_tasks < max(MIN_ITER_TASKS,
                     2 * getattr(backend, "n_task_slots", 1)):
        return None
    if not max_iter:
        return None
    n_slice = resolve_slice_iters(max_iter)
    if n_slice >= int(max_iter):
        return None
    return n_slice


def iterative_chunk_size(n_tasks, n_slots, target_rounds=8):
    """Default round size of the compacted path: about
    ``target_rounds`` slot-aligned rounds, so that compaction has rounds
    to merge."""
    chunk = max(n_slots, -(-n_tasks // target_rounds))
    return int(math.ceil(chunk / n_slots) * n_slots)


def effective_jobs(n_jobs, n_tasks):
    """Worker threads for ``n_tasks`` tasks under joblib's ``n_jobs``
    convention: None or 0 is one, a negative number counts back from the
    CPU count (-1 is every CPU), and never more threads than tasks."""
    if n_jobs in (None, 0):
        return 1
    if n_jobs < 0:
        return max(1, min(n_tasks, (os.cpu_count() or 1) + 1 + n_jobs))
    return max(1, min(n_tasks, n_jobs))


def run_threads(fn, tasks, n_jobs):
    """``[fn(t) for t in tasks]`` in task order, on ``effective_jobs``
    threads (in the caller's thread when that is one). Threads, not
    processes: the work inside a task is device work or native code that
    releases the GIL, and threads share the training data instead of
    pickling it per task. A task's exception reaches the caller."""
    tasks = list(tasks)
    workers = effective_jobs(n_jobs, len(tasks))
    if workers == 1:
        return [fn(t) for t in tasks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, tasks))


def _place(tree, device, reuse=False):
    if isinstance(tree, dict):
        return {k: _place(v, device, reuse) for k, v in tree.items()}
    if isinstance(tree, PackedX):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return _cached_put(tree, device, reuse)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _host_rows(tree, rows, device):
    """Rows ``rows`` of every host array of a dict tree, on ``device``."""
    if isinstance(tree, dict):
        return {k: _host_rows(v, rows, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)[rows]).to(device)


def _leading_dim(tree):
    """The task count of a dict tree: the leading axis of its first
    array (an empty dict, such as the hypers of a family with none,
    holds none); None when there is no array."""
    if isinstance(tree, dict):
        for v in tree.values():
            n = _leading_dim(v)
            if n is not None:
                return n
        return None
    return int(np.shape(tree)[0])


# The device-broadcast reuse cache (opt-in: ``CUDABackend(reuse_broadcast=
# True)``): ``id`` of a shared host array and its device -> the device
# copy. An entry holds a weakref to its host array and serves only while
# that reference still is the very array, so a recycled ``id`` can never
# serve a stale copy; the weakref's callback evicts the entry (freeing
# the device memory) once the host array is collected. Eviction is LRU
# (a hit refreshes recency), bounded by _BCAST_MAX, which exceeds the
# large leaves one fit places (a search's X, y, sw and its two mask
# stacks), so a fit's own placement never evicts its X.
_BCAST_CACHE = {}
_BCAST_MAX = 16
#: smaller host arrays are copied every time: caching them gains nothing
_BCAST_MIN_BYTES = 1 << 20
#: cache hits so far (read by the tests)
_BCAST_HITS = 0
_BCAST_LOCK = threading.Lock()


def _cached_put(leaf, device, enabled):
    """``leaf`` as a tensor on ``device``, through the reuse cache when
    ``enabled`` and ``leaf`` is a host ndarray of at least
    ``_BCAST_MIN_BYTES``. Mutating a host array after handing it over is
    the caller's error, as with a Spark broadcast: the cached copy would
    go stale."""
    global _BCAST_HITS
    if not enabled or not isinstance(leaf, np.ndarray) \
            or leaf.nbytes < _BCAST_MIN_BYTES:
        return torch.as_tensor(leaf).to(device)
    key = (id(leaf), str(device))
    with _BCAST_LOCK:
        ent = _BCAST_CACHE.get(key)
        if ent is not None:
            ref, dev = ent
            if ref() is leaf:
                _BCAST_HITS += 1
                _BCAST_CACHE.pop(key, None)  # LRU refresh
                _BCAST_CACHE[key] = ent
                return dev
            _BCAST_CACHE.pop(key, None)  # a recycled id: never serve it
    # a copy even on the CPU: an entry that aliased its host array would
    # keep it alive, and the weakref could never evict it
    dev = torch.as_tensor(leaf).to(device, copy=True)
    with _BCAST_LOCK:
        _BCAST_CACHE[key] = (
            weakref.ref(leaf, lambda _r: _BCAST_CACHE.pop(key, None)), dev)
        while len(_BCAST_CACHE) > _BCAST_MAX:
            _BCAST_CACHE.pop(next(iter(_BCAST_CACHE)), None)
    return dev


class CUDABackend(TaskBackend):
    """Batched execution on one CUDA device (or, with ``device="cpu"``,
    on the CPU through the kernels' plain versions).

    ``round_size`` caps the tasks of one round; by default a round holds
    as many tasks as free device memory fits. ``n_jobs`` sizes the host
    fan-out of :meth:`run_tasks`: by default every CPU, as the JAX
    package's device backend does (``n_jobs or -1``).

    ``reuse_broadcast=True`` keeps the device copy of every shared host
    array of at least 1 MiB that :meth:`place` uploads, keyed by the
    array's identity, so a later fit on the same X skips the upload (the
    JAX package's ``TPUBackend(reuse_broadcast=True)``, the analogue of
    reusing one Spark broadcast); it also lets the forests keep their
    bin edges and binned X across fits on the same X
    (``models/forest.py``). Mutating a host array after a fit handed it
    over is the caller's error, as with a broadcast. Off by default.
    """

    is_device_backend = True

    def __init__(self, device=None, round_size=None, n_jobs=None,
                 reuse_broadcast=False):
        self.device = resolve_device(device)
        self.round_size = round_size
        self.n_jobs = n_jobs
        self.reuse_broadcast = reuse_broadcast

    def run_tasks(self, fn, tasks, verbose=0):
        return run_threads(fn, tasks, self.n_jobs or -1)

    def place(self, tree):
        """Host arrays (and PackedX) of a dict tree as device tensors,
        through the reuse cache under ``reuse_broadcast``."""
        return _place(tree, self.device, self.reuse_broadcast)

    def free_device_bytes(self):
        """Bytes the next round can allocate: free device memory plus
        what PyTorch's allocator holds cached but unused; None on CPU."""
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        cached = (torch.cuda.memory_reserved(self.device)
                  - torch.cuda.memory_allocated(self.device))
        return int(free + cached)

    def round_cap(self, bytes_per_task, headroom=0.85, bytes_per_round=0):
        """Largest task count whose ``bytes_per_task`` footprint, beside
        the ``bytes_per_round`` a round holds once, fits ``headroom`` of
        free device memory; None on CPU."""
        free = self.free_device_bytes()
        if free is None or bytes_per_task is None or bytes_per_task <= 0:
            return None
        room = int(free * headroom) - int(bytes_per_round or 0)
        return max(1, room // int(bytes_per_task))

    def plan_round_size(self, n_tasks, bytes_per_task=None, round_size=None,
                        bytes_per_round=0):
        """Tasks per round: at most ``round_size`` (or the backend's),
        at most what free device memory fits, and spread evenly so the
        last round is no smaller than it must be."""
        chunk = round_size or self.round_size or n_tasks
        cap = self.round_cap(bytes_per_task, bytes_per_round=bytes_per_round)
        if cap is not None:
            chunk = min(chunk, cap)
        chunk = max(1, min(chunk, n_tasks))
        return math.ceil(n_tasks / math.ceil(n_tasks / chunk))

    def batched_map(self, kernel, task_args, shared, bytes_per_task=None,
                    round_size=None, return_timings=False,
                    bytes_per_round=0):
        """Run ``kernel(shared, task_batch) -> {name: (T, ...) tensor}``
        over the tasks of ``task_args`` (a dict tree of host arrays with a
        leading task axis) in rounds. ``shared`` is already placed
        (:meth:`place`). Returns ``{name: (n_tasks, ...) ndarray}`` (the
        rounds' outputs concatenated on the task axis; trailing axes, such
        as a tree's ``(N,)`` nodes, are kept) and, with ``return_timings``,
        a list of ``(round wall seconds, tasks)``. ``bytes_per_round`` is
        what a round holds once beside its tasks' ``bytes_per_task``. The
        round stats (rounds, tasks per round, round walls, the byte
        estimates) are left in :attr:`last_round_stats`.

        A last round smaller than the others is filled up to their size
        with copies of its first task, whose outputs are dropped: every
        round then has the one shape the compacted path's rounds have,
        and a lane's bits on the card depend on its round's shape
        (PyTorch's and cuBLAS's reductions choose their summation order
        by it), so the two paths agree bit for bit at equal round size
        whether or not the tasks fill whole rounds."""
        n_tasks = _leading_dim(task_args)
        chunk = self.plan_round_size(n_tasks, bytes_per_task, round_size,
                                     bytes_per_round)
        outs, timings = [], []
        for lo in range(0, n_tasks, chunk):
            hi = min(n_tasks, lo + chunk)
            t0 = time.perf_counter()
            rows = np.arange(lo, hi)
            if hi - lo < chunk:
                rows = np.concatenate([rows, np.full(chunk - (hi - lo), lo)])
            task = _host_rows(task_args, rows, self.device)
            with exact_matmuls(), torch.no_grad():
                res = kernel(shared, task)
            outs.append({k: v.detach()[:hi - lo].cpu().numpy()
                         for k, v in res.items()})
            timings.append((time.perf_counter() - t0, hi - lo))
        self.last_round_stats = {
            "device": str(self.device),
            "mode": "classic",
            "tasks": n_tasks,
            "rounds": len(timings),
            "tasks_per_round": chunk,
            "round_walls_s": [w for w, _ in timings],
            "bytes_per_task": bytes_per_task,
            "bytes_per_round": bytes_per_round,
        }
        result = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if return_timings:
            return result, timings
        return result

    supports_iterative = True

    def iterative_plan(self, n_tasks, bytes_per_task=None, round_size=None,
                       bytes_per_round=0):
        """``(chunk, resident rounds)`` of the compacted path. When every
        round of ``round_size`` (or :func:`iterative_chunk_size`) tasks
        fits in device memory at once, all are resident (the CPU always
        is). Otherwise the chunk is the classic path's
        (:meth:`plan_round_size`) and as many rounds as fit are kept as a
        pool of slots that the task queue refills."""
        chunk = (min(n_tasks, round_size) if round_size
                 else iterative_chunk_size(n_tasks, 1))
        n_rounds = -(-n_tasks // chunk)
        cap = self.round_cap(bytes_per_task, bytes_per_round=bytes_per_round)
        if cap is None or cap >= n_rounds * chunk:
            return chunk, n_rounds
        chunk = self.plan_round_size(n_tasks, bytes_per_task, round_size,
                                     bytes_per_round)
        return chunk, max(1, cap // chunk)

    def batched_map_iterative(self, spec, task_args, shared,
                              bytes_per_task=None, round_size=None,
                              return_timings=False, bytes_per_round=0,
                              rung=None):
        """Run an :class:`IterativeKernelSpec` over the tasks of
        ``task_args`` with convergence compaction; the same outputs as
        :meth:`batched_map` of ``spec.fallback``, bit for bit at equal
        round size.

        Every per-lane value is computed on a tensor of the round's fixed
        shape ``(chunk, ...)`` (init, every slice, rung scores and
        finalize), so a lane's result does not depend on its slot or on
        the lanes beside it. Rounds never shrink to their live lanes: a
        free slot holds a done lane that no step changes. Two regimes,
        chosen up front by :meth:`iterative_plan`:

        - *resident*: every round's carry fits at once. Each slice steps
          every live round, reads its ``(chunk,)`` done flags, and when
          the survivors fit in fewer rounds moves them, on the device,
          into the free slots of the fullest rounds (the JAX package
          moves them through the host).
        - *refill*: they do not fit (the JAX package would exhaust
          device memory and fall back to the classic path). A pool of
          rounds of the classic path's size is kept resident, and at
          every slice boundary the slots of finished lanes are restarted
          in place with the next tasks of the queue. The queue is the
          task axis from its end: callers sort it by ascending expected
          cost, so the longest tasks start first and the tail is short.
          An adaptive ``rung`` needs every live lane at the same slice,
          so here it is deactivated and every lane runs to the end, as
          the JAX package's out-of-memory fallback does.

        Finished lanes keep only their ``finalize_keys`` leaves, gathered
        on the device into a chunk-shaped batch that is finalized each
        time it fills. Each slice reads one host copy a round (its done
        flags, iteration counts and, where the spec has it, convergence
        test) and, at a rung, one ``(chunk,)`` score vector.

        A ``torch.cuda.OutOfMemoryError`` in the loop frees it, warns and
        runs ``spec.fallback`` through :meth:`batched_map` at the same
        round size. With ``return_timings`` the one pseudo-round
        ``[(wall seconds, n_tasks)]`` is returned beside the outputs.
        :attr:`last_round_stats` holds the scheduler's counts."""
        n_tasks = _leading_dim(task_args)
        chunk, pool = self.iterative_plan(n_tasks, bytes_per_task,
                                          round_size, bytes_per_round)
        resident = pool * chunk >= n_tasks
        if not resident and rung is not None:
            rung.deactivate()
            rung = None
        queue = np.arange(n_tasks) if resident else np.arange(n_tasks)[::-1]
        t0 = time.perf_counter()
        loop = None
        try:
            with exact_matmuls(), torch.no_grad():
                loop = _SliceLoop(spec, shared, _place(task_args, self.device),
                                  n_tasks, chunk, pool, queue, rung,
                                  self.device)
                result = loop.run()
        except torch.cuda.OutOfMemoryError:
            result = None
        if result is None:
            loop = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            warnings.warn(
                "compacted iterative dispatch exhausted device memory; "
                "falling back to the classic batched path at "
                f"round_size={chunk}"
            )
            if rung is not None:
                rung.deactivate()
            return self.batched_map(
                spec.fallback, task_args, shared,
                bytes_per_task=bytes_per_task, round_size=chunk,
                return_timings=return_timings,
                bytes_per_round=bytes_per_round,
            )
        wall = time.perf_counter() - t0
        self.last_round_stats = dict(
            loop.stats, device=str(self.device),
            regime="resident" if resident else "refill",
            wall_s=wall, bytes_per_task=bytes_per_task,
            bytes_per_round=bytes_per_round,
        )
        if return_timings:
            return result, [(wall, n_tasks)]
        return result


# ---------------------------------------------------------------------------
# the convergence-compacted slice loop
# ---------------------------------------------------------------------------

def _take(tree, index):
    """Rows ``index`` of every tensor of a dict tree."""
    if isinstance(tree, dict):
        return {k: _take(v, index) for k, v in tree.items()}
    return tree.index_select(0, index)


class _Round:
    """One chunk-shaped round: the task id in each slot (host int64, -1
    for a free slot), its task rows and carry on the device, and each
    slot's iteration count at the last read (host)."""

    __slots__ = ("ids", "task", "carry", "it")

    def __init__(self, ids, task, carry):
        self.ids = ids
        self.task = task
        self.carry = carry
        self.it = np.zeros(len(ids), dtype=np.int64)


#: a finished lane's reason, in ``lane_status`` of the round stats
_CONVERGED, _STALLED, _MAX_ITER, _KILLED = 0, 1, 2, 3


class _SliceLoop:
    """The state of one :meth:`CUDABackend.batched_map_iterative` call:
    the rounds in flight, the task queue, the batch of finished lanes
    awaiting finalize, the outputs and the counts."""

    def __init__(self, spec, shared, task_dev, n_tasks, chunk, pool, queue,
                 rung, device):
        self.spec = spec
        self.shared = shared
        self.task_dev = task_dev
        self.n_tasks = n_tasks
        self.chunk = chunk
        self.pool = pool
        self.queue = np.asarray(queue, dtype=np.int64)
        self.next = 0
        self.rung = rung
        self.device = device
        self.rounds = []
        self.fin_ids = []
        self.fin_carry = None
        self.out = {}
        self.n_iter = np.zeros(n_tasks, dtype=np.int64)
        self.status = np.zeros(n_tasks, dtype=np.int8)
        self.stats = {
            "tasks": n_tasks, "mode": "compacted", "chunk": chunk,
            "tasks_per_round": chunk, "pool_rounds": pool, "slices": 0,
            "compactions": 0, "refills": 0, "refilled_lanes": 0,
            "rounds_per_slice": [], "retired_per_slice": [],
            "retired_rung": 0, "retired_convergence": 0,
            "rung_history": [], "lane_iters_carried": 0,
        }

    def _index(self, slots):
        return torch.as_tensor(np.asarray(slots, dtype=np.int64),
                               device=self.device)

    def _task_rows(self, ids):
        """The task rows of a round's slots; a free slot mirrors the
        round's first lane (its own carry is done, its rows unread)."""
        real = ids[ids >= 0]
        rows = np.where(ids >= 0, ids, real[0] if real.size else 0)
        return _take(self.task_dev, self._index(rows))

    # ---- filling slots --------------------------------------------------

    def _fill(self):
        spec, shared = self.spec, self.shared
        for r in self.rounds:
            if self.next >= len(self.queue):
                break
            free = np.flatnonzero(r.ids < 0)
            if not free.size:
                continue
            take = self.queue[self.next:self.next + free.size]
            self.next += take.size
            slots = free[:take.size]
            r.ids[slots] = take
            r.it[slots] = 0
            r.task = self._task_rows(r.ids)
            r.carry = spec.restart(shared, r.task, r.carry,
                                   self._index(slots))
            self.stats["refills"] += 1
            self.stats["refilled_lanes"] += int(take.size)
        while self.next < len(self.queue) and len(self.rounds) < self.pool:
            take = self.queue[self.next:self.next + self.chunk]
            self.next += take.size
            ids = np.full(self.chunk, -1, dtype=np.int64)
            ids[:take.size] = take
            task = self._task_rows(ids)
            carry = spec.init(shared, task)
            if take.size < self.chunk:
                carry[spec.done_key].index_fill_(
                    0, self._index(np.arange(take.size, self.chunk)), True)
            self.rounds.append(_Round(ids, task, carry))

    # ---- one slice ------------------------------------------------------

    def _read(self, r):
        """The one host copy of a round a slice: done flags, iteration
        counts and (where the spec has it) the convergence test."""
        spec, c = self.spec, r.carry
        parts = [c[spec.done_key].to(torch.int64),
                 c[spec.iter_key].to(torch.int64)]
        if spec.converged is not None:
            parts.append(spec.converged(self.shared, r.task, c)
                         .to(torch.int64))
        host = torch.stack(parts).cpu().numpy()
        it = host[1]
        self.stats["lane_iters_carried"] += self.chunk * int(
            (it - r.it).max())
        r.it = it
        conv = host[2].astype(bool) if len(parts) > 2 else None
        return host[0].astype(bool), conv

    def _rung_kills(self, flags):
        """Score the live lanes at a due rung; the ids to kill."""
        rung = self.rung
        if (rung is None or self.spec.score is None
                or not rung.due(self.stats["slices"])):
            return np.empty(0, dtype=np.int64)
        ids, scores = [np.empty(0, dtype=np.int64)], [np.empty(0)]
        for r, (done, _conv) in zip(self.rounds, flags):
            alive = (r.ids >= 0) & ~done
            if not alive.any():
                continue
            s = self.spec.score(self.shared, r.task, r.carry)
            ids.append(r.ids[alive])
            scores.append(s.detach().cpu().numpy()[alive])
        return np.asarray(rung.decide(np.concatenate(ids),
                                      np.concatenate(scores),
                                      self.stats["slices"]))

    def _retire(self, r, done, conv, killed):
        """Move a round's finished (or killed) lanes to the finalize
        batch and free their slots; the count retired."""
        kill = (r.ids >= 0) & np.isin(r.ids, killed)
        leave = (r.ids >= 0) & (done | kill)
        if not leave.any():
            return 0
        slots = np.flatnonzero(leave)
        ids = r.ids[slots]
        self.n_iter[ids] = r.it[slots]
        status = np.full(slots.size, _CONVERGED, dtype=np.int8)
        if conv is not None:
            status[~conv[slots]] = _STALLED
        if self.spec.max_iter is not None:
            at_max = r.it[slots] >= self.spec.max_iter
            status[at_max & (status == _STALLED)] = _MAX_ITER
        status[kill[slots]] = _KILLED
        self.status[ids] = status
        self._to_finalize(r, slots)
        if kill.any():
            r.carry[self.spec.done_key].index_fill_(
                0, self._index(np.flatnonzero(kill)), True)
        r.ids[slots] = -1
        return int(slots.size)

    def _to_finalize(self, r, slots):
        if self.fin_carry is None:
            self.fin_carry = {
                key: r.carry[key].new_empty(
                    (self.chunk,) + tuple(r.carry[key].shape[1:]))
                for key in self.spec.finalize_keys}
        pos = 0
        while pos < slots.size:
            take = min(self.chunk - len(self.fin_ids), slots.size - pos)
            src = self._index(slots[pos:pos + take])
            n0 = len(self.fin_ids)
            for key, buf in self.fin_carry.items():
                torch.index_select(r.carry[key], 0, src,
                                   out=buf[n0:n0 + take])
            self.fin_ids.extend(r.ids[slots[pos:pos + take]].tolist())
            pos += take
            if len(self.fin_ids) == self.chunk:
                self._flush()

    def _flush(self):
        """Finalize the batch of finished lanes (padded by mirroring its
        first lane) and scatter the outputs to their task ids."""
        n = len(self.fin_ids)
        if not n:
            return
        buf = self.fin_carry
        for leaf in buf.values():
            leaf[n:] = leaf[:1]
        ids = np.full(self.chunk, -1, dtype=np.int64)
        ids[:n] = self.fin_ids
        outs = self.spec.finalize(self.shared, self._task_rows(ids), buf)
        for name, v in outs.items():
            v = v.detach().cpu().numpy()
            if name not in self.out:
                self.out[name] = np.zeros((self.n_tasks,) + v.shape[1:],
                                          dtype=v.dtype)
            self.out[name][ids[:n]] = v[:n]
        self.fin_ids = []

    def _compact(self):
        """Once the queue is empty: drop rounds with no lane and, when
        the survivors fit in fewer rounds, move them into the free slots
        of the fullest rounds."""
        if self.next < len(self.queue):
            return
        live = [int((r.ids >= 0).sum()) for r in self.rounds]
        needed = -(-sum(live) // self.chunk)
        if needed >= sum(1 for n in live if n):
            self.rounds = [r for r, n in zip(self.rounds, live) if n]
            return
        order = sorted(range(len(self.rounds)), key=lambda i: -live[i])
        keep = sorted(order[:needed])
        dests = [(self.rounds[i], list(np.flatnonzero(self.rounds[i].ids < 0)))
                 for i in keep]
        changed = set()
        for i in order[needed:]:
            donor = self.rounds[i]
            src = np.flatnonzero(donor.ids >= 0)
            for dst, free in dests:
                if not src.size:
                    break
                take = min(len(free), src.size)
                if not take:
                    continue
                s, d = src[:take], np.asarray(free[:take])
                del free[:take]
                src = src[take:]
                s_t, d_t = self._index(s), self._index(d)
                for key, leaf in dst.carry.items():
                    leaf.index_copy_(0, d_t,
                                     donor.carry[key].index_select(0, s_t))
                dst.ids[d] = donor.ids[s]
                dst.it[d] = donor.it[s]
                changed.add(id(dst))
        self.rounds = [self.rounds[i] for i in keep]
        for r in self.rounds:
            if id(r) in changed:
                r.task = self._task_rows(r.ids)
        self.stats["compactions"] += 1

    def run(self):
        spec, shared, st = self.spec, self.shared, self.stats
        while True:
            self._fill()
            if not self.rounds:
                break
            st["slices"] += 1
            st["rounds_per_slice"].append(len(self.rounds))
            for r in self.rounds:
                r.carry = spec.step(shared, r.task, r.carry)
            flags = [self._read(r) for r in self.rounds]
            killed = self._rung_kills(flags)
            st["retired_per_slice"].append(sum(
                self._retire(r, done, conv, killed)
                for r, (done, conv) in zip(self.rounds, flags)))
            self._compact()
        self._flush()
        st["rounds"] = int(sum(st["rounds_per_slice"]))
        if self.rung is not None:
            st["retired_rung"] = len(self.rung.killed)
            st["rung_history"] = [dict(h) for h in self.rung.history]
        st["retired_convergence"] = self.n_tasks - st["retired_rung"]
        st["lane_n_iter"] = self.n_iter
        st["lane_status"] = self.status
        st["lane_iters_used"] = int(self.n_iter.sum())
        st["lanes_converged"] = int((self.status == _CONVERGED).sum())
        st["lanes_stalled"] = int((self.status == _STALLED).sum())
        st["lanes_max_iter"] = int((self.status == _MAX_ITER).sum())
        return self.out


class LocalBackend(CUDABackend):
    """The host backend (the JAX package's ``LocalBackend``): per-task
    closures run serially (``n_jobs=None`` or 1) or on ``n_jobs``
    threads, never processes. Its batched calls (``batched_map``,
    ``round_cap`` and the compacted path) place and run on ``device``,
    the card unless ``device="cpu"``, as :class:`CUDABackend`'s do."""

    is_device_backend = False

    def __init__(self, n_jobs=None, device=None, round_size=None,
                 reuse_broadcast=False):
        super().__init__(device=device, round_size=round_size, n_jobs=n_jobs,
                         reuse_broadcast=reuse_broadcast)

    def run_tasks(self, fn, tasks, verbose=0):
        return run_threads(fn, tasks, self.n_jobs)


# ---------------------------------------------------------------------------
# the streaming data plane's host-to-device leg
# ---------------------------------------------------------------------------

#: bytes every leaf of a block starts on in its pinned buffer (and so in
#: its device copy)
_LEAF_ALIGN = 16

#: the feeder's pinned buffers: the block in use and the one in flight
_FEED_DEPTH = 2


def _block_leaves(tree, prefix=""):
    """``[(path, ndarray)]`` of a host block tree: a dict of arrays and
    :class:`PackedX` pairs (their ``idx`` and ``val``), in key order."""
    if isinstance(tree, dict):
        out = []
        for key in tree:
            out += _block_leaves(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, PackedX):
        return [(prefix + "idx", np.asarray(tree.idx)),
                (prefix + "val", np.asarray(tree.val))]
    return [(prefix[:-1], np.asarray(tree))]


def _block_tree(template, leaves, prefix=""):
    """The host tree ``template``'s shape over ``leaves`` (a dict path ->
    tensor); a PackedX's copy is not checked again."""
    if isinstance(template, dict):
        return {k: _block_tree(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, PackedX):
        return PackedX.checked_copy(leaves[prefix + "idx"],
                                    leaves[prefix + "val"], template.n_cols)
    return leaves[prefix[:-1]]


def tree_nbytes(tree):
    """Bytes of every array of a host block tree (a PackedX counts its
    two leaves): what one block moves from the host to the device."""
    return int(sum(a.nbytes for _, a in _block_leaves(tree)))


def _pinned_buffer(nbytes):
    """A page-locked host buffer of ``nbytes`` bytes (uint8)."""
    return torch.empty(int(nbytes), dtype=torch.uint8, pin_memory=True)


class _Slot:
    """One pinned host buffer of the feeder's ring, and the event of the
    last copy that read it (the buffer is refilled only after it)."""

    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf = None
        self.event = None


class BlockFeeder:
    """The host-to-device leg of the streaming data plane (the JAX
    package's ``BlockFeeder``, rebuilt for the card).

    ``read(i) -> host tree`` gives block ``i`` as a dict of numpy arrays
    and numpy :class:`PackedX` pairs; :meth:`next` hands out ``(i,
    device tree)`` in order. A worker thread reads and places one block
    ahead of the consumer (:data:`_FEED_DEPTH` = 2 buffers), so block
    ``i + 1``'s read and copy hide behind block ``i``'s compute.
    ``cycle=True`` hands the blocks out in an endless cycle ``0 .. n - 1,
    0 ..`` for a consumer that makes repeated passes (the streamed fit
    takes ``n_blocks`` blocks a pass): block 0 of the next pass is read
    and placed while the last block of this one is in use, and one ring,
    one copy stream and one worker serve every pass. Without it,
    :meth:`next` returns None past the last block. ``sync=True`` is the
    serial mode:
    read and placement happen inline in :meth:`next`, on the consumer's
    clock (the baseline the overlap is measured against). The order of
    blocks, and so of any reduction over them, is the same in both modes.

    On a CUDA ``device`` the worker copies the block's leaves into one of
    a ring of :data:`_FEED_DEPTH` pinned host buffers (allocated at first use,
    sized to the block, then reused; a buffer is refilled only after the
    event of its previous copy has completed), issues one
    ``non_blocking`` copy of it on a copy stream and records an event.
    :meth:`next` makes the consumer's stream (the current stream when the
    feeder was made) wait on that event and marks the device block as in
    use by that stream (``record_stream``), so the caching allocator
    never hands its memory to a later copy while a kernel still reads it.
    The device block's leaves are views of one device buffer; a PackedX
    leaf is not range-checked again (its host pair was, when the reader
    built it). Nothing falls back: a buffer that cannot be pinned, a
    failed copy or a read error raises (at :meth:`next`). On the CPU the
    worker places plain tensor copies of the leaves.

    :meth:`seek` moves the cursor (in-flight prefetches are discarded and
    the reader is invoked again at that offset); :meth:`close` ends the
    worker. ``stats`` (a dict) accumulates ``streamed_bytes`` (host bytes
    of the blocks handed out; a prefetch that :meth:`seek` or
    :meth:`close` discards is not counted), ``peak_block_bytes``, ``blocks_fed``, ``feed_wait_s`` (the
    consumer's time blocked on the feed: the part of it not hidden),
    ``read_place_s`` (the time spent reading and placing) and
    ``stream_mode`` (``"serial"`` or ``"pipelined"``).
    """

    def __init__(self, read, n_blocks, device, sync=False, stats=None,
                 cycle=False):
        self.read = read
        self.n_blocks = int(n_blocks)
        self.device = torch.device(device)
        self.sync = bool(sync)
        self.cycle = bool(cycle)
        self.stats = stats if stats is not None else {}
        for key, v0 in (
            ("streamed_bytes", 0), ("peak_block_bytes", 0),
            ("blocks_fed", 0), ("feed_wait_s", 0.0),
            ("read_place_s", 0.0),
        ):
            self.stats.setdefault(key, v0)
        self.stats["stream_mode"] = "serial" if self.sync else "pipelined"
        self._cursor = 0
        self._pending = []  # [(block index, Future)]
        self._pool = None
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._consumer = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._ring = [_Slot() for _ in range(_FEED_DEPTH)]
            self._next_slot = 0

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="skdist-blockfeed")
        return self._pool

    def _place_cpu(self, host):
        leaves = {path: torch.from_numpy(np.array(a, order="C", copy=True))
                  for path, a in _block_leaves(host)}
        return _block_tree(host, leaves)

    def _place_cuda(self, host):
        """Copy ``host`` into the next pinned buffer of the ring and issue
        its copy to the device on the copy stream. Returns ``(device
        buffer, layout, event)``."""
        layout, total = [], 0
        for path, a in _block_leaves(host):
            layout.append((path, a, total))
            total += -(-a.nbytes // _LEAF_ALIGN) * _LEAF_ALIGN
        slot = self._ring[self._next_slot]
        self._next_slot = (self._next_slot + 1) % _FEED_DEPTH
        if slot.event is not None:
            slot.event.synchronize()  # its previous copy has read it
        if slot.buf is None or slot.buf.numel() < total:
            slot.buf = None
            buf = _pinned_buffer(max(total, 1))
            if not buf.is_pinned():
                raise RuntimeError(
                    f"BlockFeeder: a {total}-byte host buffer could not be "
                    "pinned; the feeder does not fall back to pageable "
                    "memory")
            slot.buf = buf
        view = slot.buf.numpy()
        for path, a, off in layout:
            np.copyto(view[off:off + a.nbytes].view(a.dtype).reshape(a.shape),
                      a, casting="no")
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            dev = torch.empty(max(total, 1), dtype=torch.uint8,
                              device=self.device)
            dev.copy_(slot.buf[:max(total, 1)], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        slot.event = event
        return dev, [(path, a.dtype, a.shape, off) for path, a, off in layout], \
            event

    def _produce(self, i):
        t0 = time.perf_counter()
        host = self.read(i)
        nbytes = tree_nbytes(host)
        if self._cuda:
            placed = (host, self._place_cuda(host))
        else:
            placed = (host, self._place_cpu(host))
        return placed, nbytes, time.perf_counter() - t0

    def _hand_out(self, placed):
        """The consumer's side of a placed block: on the card its stream
        waits on the copy's event and owns the device buffer."""
        host, dev = placed
        if not self._cuda:
            return dev
        buf, layout, event = dev
        self._consumer.wait_event(event)
        buf.record_stream(self._consumer)
        leaves = {}
        for path, dtype, shape, off in layout:
            nb = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            leaves[path] = buf[off:off + nb].view(tdtype).view(shape)
        return _block_tree(host, leaves)

    def _account(self, nbytes, dt):
        self.stats["streamed_bytes"] += int(nbytes)
        self.stats["peak_block_bytes"] = max(
            self.stats["peak_block_bytes"], int(nbytes))
        self.stats["blocks_fed"] += 1
        self.stats["read_place_s"] += dt

    def _live(self, j):
        """Whether position ``j`` of the cursor holds a block."""
        return self.cycle or j < self.n_blocks

    def seek(self, i):
        """Move the cursor to block ``i``; in-flight prefetches are
        discarded, so the next :meth:`next` reads block ``i`` afresh."""
        for _idx, fut in self._pending:
            try:
                fut.cancel() or fut.exception()
            except Exception:  # a failed prefetch is why one seeks
                pass
        self._pending = []
        self._cursor = int(i)

    def _submit(self):
        pool = self._ensure_pool()
        while (len(self._pending) < _FEED_DEPTH - 1
               and self._live(self._cursor + len(self._pending))):
            j = self._cursor + len(self._pending)
            self._pending.append(
                (j, pool.submit(self._produce, j % self.n_blocks)))

    def next(self):
        """``(block index, device tree)`` of the next block, or None past
        the end. A read or placement error raises here."""
        if self.sync:
            if not self._live(self._cursor):
                return None
            j = self._cursor
            t0 = time.perf_counter()
            placed, nbytes, dt = self._produce(j % self.n_blocks)
            dev = self._hand_out(placed)
            self.stats["feed_wait_s"] += time.perf_counter() - t0
            self._account(nbytes, dt)
            self._cursor = j + 1
            return j % self.n_blocks, dev
        self._submit()
        if not self._pending:
            return None
        j, fut = self._pending.pop(0)
        t0 = time.perf_counter()
        placed, nbytes, dt = fut.result()
        dev = self._hand_out(placed)
        self.stats["feed_wait_s"] += time.perf_counter() - t0
        self._account(nbytes, dt)
        self._cursor = j + 1
        self._submit()  # the next block's read starts before this one's use
        return j % self.n_blocks, dev

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def close(self):
        """Discard what is in flight and stop the worker thread."""
        self.cycle = False
        self.seek(self.n_blocks)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def resolve_backend(backend, n_jobs=None):
    """The user-facing ``backend=`` argument as a :class:`TaskBackend`:
    None or ``"local"`` is a :class:`LocalBackend` over ``n_jobs``
    threads, a ``TaskBackend`` passes through, ``"cuda"`` or
    ``"devices"`` is a :class:`CUDABackend`. Anything else raises,
    ``"tpu"`` and a device mesh among them: the port runs on one card
    (a mesh waits for ROADMAP Queue 1 item 10)."""
    if backend is None or (isinstance(backend, str) and backend == "local"):
        return LocalBackend(n_jobs=n_jobs)
    if isinstance(backend, TaskBackend):
        return backend
    if isinstance(backend, str) and backend in ("cuda", "devices"):
        return CUDABackend(n_jobs=n_jobs)
    raise ValueError(
        f"Unrecognised backend {backend!r}: pass None, 'local', 'cuda' "
        "(or 'devices') or a TaskBackend instance"
    )
