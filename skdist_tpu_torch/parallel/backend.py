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

Not ported yet (ROADMAP): compaction, ASHA, elastic mode, streaming,
AOT and the host fan-out.
"""

import math
import time

import numpy as np
import torch

from ..sparse import PackedX
from ..utils.device import exact_matmuls, resolve_device

__all__ = ["TaskBackend", "CUDABackend", "parse_partitions"]


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

    def batched_map(self, kernel, task_args, shared, bytes_per_task=None,
                    round_size=None, return_timings=False,
                    bytes_per_round=0):
        raise NotImplementedError

    # fitted estimators must never hold a live backend; give pickle a
    # loud failure instead of a corrupt artifact
    def __reduce__(self):
        raise TypeError(
            f"{type(self).__name__} holds live runtime state and cannot be "
            "pickled; fitted estimators strip it automatically."
        )


def _place(tree, device):
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, PackedX):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(tree).to(device)
    return tree


def _slice(tree, lo, hi, device):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)[lo:hi]).to(device)


def _leading_dim(tree):
    if isinstance(tree, dict):
        return _leading_dim(next(iter(tree.values())))
    return int(np.shape(tree)[0])


class CUDABackend(TaskBackend):
    """Batched execution on one CUDA device (or, with ``device="cpu"``,
    on the CPU through the kernels' plain versions).

    ``round_size`` caps the tasks of one round; by default a round holds
    as many tasks as free device memory fits.
    """

    is_device_backend = True

    def __init__(self, device=None, round_size=None):
        self.device = resolve_device(device)
        self.round_size = round_size

    def place(self, tree):
        """Host arrays (and PackedX) of a dict tree as device tensors."""
        return _place(tree, self.device)

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
        estimates) are left in :attr:`last_round_stats`."""
        n_tasks = _leading_dim(task_args)
        chunk = self.plan_round_size(n_tasks, bytes_per_task, round_size,
                                     bytes_per_round)
        outs, timings = [], []
        for lo in range(0, n_tasks, chunk):
            hi = min(n_tasks, lo + chunk)
            t0 = time.perf_counter()
            task = _slice(task_args, lo, hi, self.device)
            with exact_matmuls(), torch.no_grad():
                res = kernel(shared, task)
            outs.append({k: v.detach().cpu().numpy() for k, v in res.items()})
            timings.append((time.perf_counter() - t0, hi - lo))
        self.last_round_stats = {
            "device": str(self.device),
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
