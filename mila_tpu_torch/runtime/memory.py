"""Memory observability (port of ``mila_tpu/runtime/memory.py``): a host
tracker of the trees the framework materializes (count, bytes, peak), the
bytes of a tree, and the CUDA caching allocator's live statistics.

Trees are the port's nested dicts, lists and tuples of tensors; a
``QTensor`` counts its q and scale tensors (an int4 one its packed bytes:
the port stores int4 two to a byte only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mila_tpu_torch.device import DeviceLike


@dataclasses.dataclass
class MemoryStats:
    allocation_count: int = 0
    deallocation_count: int = 0
    bytes_allocated: int = 0
    bytes_deallocated: int = 0
    peak_bytes: int = 0

    @property
    def live_bytes(self) -> int:
        return self.bytes_allocated - self.bytes_deallocated


def _arrays(tree: Any) -> list:
    """The tensors (and numpy arrays) of a tree, in order."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _arrays(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _arrays(v)]
    return [tree] if hasattr(tree, "dtype") and hasattr(tree, "shape") else []


class MemoryTracker:
    """Host-side tracker for framework-managed trees."""

    def __init__(self):
        self.stats = MemoryStats()

    def record_alloc(self, tree: Any) -> int:
        nbytes = tree_nbytes(tree)
        self.stats.allocation_count += len(_arrays(tree))
        self.stats.bytes_allocated += nbytes
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.stats.live_bytes)
        return nbytes

    def record_free(self, tree: Any) -> int:
        nbytes = tree_nbytes(tree)
        self.stats.deallocation_count += len(_arrays(tree))
        self.stats.bytes_deallocated += nbytes
        return nbytes

    def reset(self) -> None:
        self.stats = MemoryStats()


def array_nbytes(x: Any) -> int:
    """Bytes of one tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return 0


def tree_nbytes(tree: Any) -> int:
    """Total bytes across a tree of tensors."""
    return sum(array_nbytes(a) for a in _arrays(tree))


def device_memory_stats(device: DeviceLike = None) -> Optional[dict]:
    """The CUDA caching allocator's statistics for a CUDA device (the GPU's
    first without one): ``torch.cuda.memory_stats`` plus ``bytes_in_use``,
    ``peak_bytes_in_use`` and ``bytes_limit`` under the names JAX's device
    statistics use. None for the CPU, or where there is no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = torch.cuda.memory_allocated(dev)
    stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev)
    stats["bytes_limit"] = torch.cuda.get_device_properties(dev).total_memory
    return stats


def format_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"
