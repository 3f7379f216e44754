"""Device, precision and memory runtime (port of ``mila_tpu/runtime``)."""

from mila_tpu_torch.runtime.device import (
    DeviceKind,
    DeviceProps,
    ExecutionContext,
    available_platforms,
    default_context,
    get_device,
    list_devices,
    set_default_context,
)
from mila_tpu_torch.runtime.memory import (
    MemoryStats,
    MemoryTracker,
    device_memory_stats,
    format_bytes,
    tree_nbytes,
)
from mila_tpu_torch.runtime.precision import PrecisionPolicy, ResolvedPrecision, resolve

__all__ = [
    "DeviceKind",
    "DeviceProps",
    "ExecutionContext",
    "available_platforms",
    "default_context",
    "get_device",
    "list_devices",
    "set_default_context",
    "MemoryStats",
    "MemoryTracker",
    "device_memory_stats",
    "format_bytes",
    "tree_nbytes",
    "PrecisionPolicy",
    "ResolvedPrecision",
    "resolve",
]
