"""Fan-out backends of the port."""

from .backend import (
    MIN_ITER_TASKS,
    CUDABackend,
    IterativeKernelSpec,
    RungController,
    TaskBackend,
    compaction_enabled,
    iterative_chunk_size,
    iterative_fit_supported,
    parse_partitions,
    resolve_slice_iters,
)

__all__ = [
    "CUDABackend", "IterativeKernelSpec", "MIN_ITER_TASKS", "RungController",
    "TaskBackend", "compaction_enabled", "iterative_chunk_size",
    "iterative_fit_supported", "parse_partitions", "resolve_slice_iters",
]
