"""Free-function tensor ops (port of ``mila_tpu/tensor/tensor_ops.py``):
elementwise math, fill, copy with conversion and placement, the host copy,
a printable digest, and the decomposition of a shape around an axis.

``to_host`` gives numpy; numpy has no bfloat16 or fp8 without a package
this port does not import, so those come back as float32 (JAX's come back
in their own dtypes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

_NUMPY_LACKS = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


# --- math ---

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.add(a, b)


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.subtract(a, b)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.multiply(a, b)


def divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.divide(a, b)


def scale(a: torch.Tensor, s: float) -> torch.Tensor:
    return a * s


# --- fill ---

def fill(shape, value: float, dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """A tensor of ``value`` on ``device`` (the GPU unless named)."""
    return torch.full(tuple(shape), value, dtype=dtype, device=resolve_device(device))


def fill_like(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, value)


# --- transfer ---

def copy(src, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """A new tensor of ``src`` (a tensor, array or nested list), converted
    to ``dtype`` and placed on ``device``: where none is named, a tensor
    stays on its own device and host data goes to the GPU, as ``fill``'s
    does."""
    if isinstance(src, torch.Tensor):
        x = src.clone() if device is None else src.to(resolve_device(device), copy=True)
    else:
        x = torch.as_tensor(np.array(src), device=resolve_device(device))
    return x if dtype is None or x.dtype == dtype else x.to(dtype)


def to_host(x) -> np.ndarray:
    """The tensor's values in a numpy array (a device-to-host copy that
    waits for the device); bfloat16 and fp8 as float32."""
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype in _NUMPY_LACKS:
        t = t.float()
    return t.numpy()


# --- axis partitioning ---

@dataclasses.dataclass(frozen=True)
class AxisPartition:
    """``outer`` x ``axis_size`` x ``inner`` covers the shape; ``num_slices``
    = outer * inner fibers run along ``axis``."""

    outer: int
    axis_size: int
    inner: int
    axis: int

    @property
    def num_slices(self) -> int:
        return self.outer * self.inner


def normalize_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return axis % ndim


def describe(x, name: str = "tensor", edge: int = 3) -> str:
    """``name[shape] dtype mean= std= min= max= [first, ..., last]`` (the
    statistics for floating tensors)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    dtype = str(t.dtype).removeprefix("torch.")
    arr = to_host(t)
    flat = arr.reshape(-1)
    head = ", ".join(f"{v:.4g}" for v in flat[:edge])
    tail = ", ".join(f"{v:.4g}" for v in flat[-edge:]) if flat.size > edge else ""
    stats = ""
    if t.is_floating_point() and arr.size:
        stats = (f" mean={arr.mean():.4g} std={arr.std():.4g}"
                 f" min={arr.min():.4g} max={arr.max():.4g}")
    body = f"[{head}, …, {tail}]" if flat.size > 2 * edge else f"[{head}]"
    return f"{name}{list(arr.shape)} {dtype}{stats} {body}"


def compute_axis_partition(shape, axis: int) -> AxisPartition:
    ax = normalize_axis(axis, len(shape))
    outer = 1
    for s in shape[:ax]:
        outer *= int(s)
    inner = 1
    for s in shape[ax + 1:]:
        inner *= int(s)
    return AxisPartition(outer=outer, axis_size=int(shape[ax]), inner=inner, axis=ax)
