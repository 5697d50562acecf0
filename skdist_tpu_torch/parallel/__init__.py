"""Fan-out backends of the port."""

from .backend import CUDABackend, TaskBackend, parse_partitions

__all__ = ["CUDABackend", "TaskBackend", "parse_partitions"]
