"""Device discovery and the execution context (port of
``mila_tpu/runtime/device.py``).

Names resolve through ``device.resolve_device``: ``"auto"`` (and ``""``)
is the first CUDA device, ``"gpu"``/``"cuda"`` and ``"cuda:N"`` a CUDA
device, ``"cpu"`` the CPU. Unlike JAX's ``get_device``, ``"auto"`` never
falls back to the CPU: without a GPU it raises, and the CPU runs only when
asked for by name. ``"tpu"`` raises, as JAX's does for a platform it lacks.
Platforms carry JAX's names, ``"gpu"`` and ``"cpu"``; devices are
``torch.device``s (type ``"cuda"`` or ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Union

import numpy as np
import torch

from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.runtime.precision import PrecisionPolicy
from mila_tpu_torch.utils.logging import Logger


class DeviceKind(enum.Enum):
    CPU = "cpu"
    TPU = "tpu"
    GPU = "gpu"

    @staticmethod
    def from_string(s: str) -> "DeviceKind":
        key = s.strip().lower()
        key = {"cuda": "gpu", "auto": "gpu"}.get(key, key)
        for k in DeviceKind:
            if k.value == key:
                return k
        raise ValueError(f"unknown device kind '{s}'")


def platform_of(device: torch.device) -> str:
    """JAX's platform name of a torch device: "gpu" for CUDA, else its type."""
    return "gpu" if device.type == "cuda" else device.type


def available_platforms() -> list[str]:
    return ["gpu", "cpu"] if torch.cuda.is_available() else ["cpu"]


def list_devices(kind: Optional[DeviceKind] = None) -> list[torch.device]:
    """The CUDA devices, then the CPU (one device); those of ``kind`` alone
    when given (none for TPU)."""
    gpus = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind is None:
        return gpus + [torch.device("cpu")]
    return {DeviceKind.GPU: gpus, DeviceKind.CPU: [torch.device("cpu")]}.get(kind, [])


def get_device(spec: str = "auto") -> torch.device:
    """Resolve "auto", "gpu", "cuda", "cuda:N", "gpu:N" or "cpu" (also
    "cpu:0"). A platform without devices, an index out of range or an
    unknown name raises ``ValueError``."""
    spec = spec.strip().lower()
    plat, _, idx_s = (spec or "auto").partition(":")
    kind = DeviceKind.from_string(plat)
    idx = int(idx_s) if idx_s else 0
    if kind == DeviceKind.TPU:
        raise ValueError("no 'tpu' devices available: this package runs on CUDA GPUs "
                         "and, when asked by name, on the CPU")
    n = 1 if kind == DeviceKind.CPU else torch.cuda.device_count()
    if n == 0:
        raise ValueError(f"no 'gpu' devices available for '{spec or 'auto'}'; "
                         "pass 'cpu' to run on the CPU")
    if not 0 <= idx < n:
        raise ValueError(f"device index {idx} out of range; {n} '{kind.value}' device(s)")
    return resolve_device("cpu" if kind == DeviceKind.CPU else f"cuda:{idx}")


@dataclasses.dataclass(frozen=True)
class DeviceProps:
    """Static properties of a device: for a CUDA device its name, SM count
    (``num_cores``), memory and compute capability from
    ``torch.cuda.get_device_properties``; for the CPU its core count."""

    platform: str
    id: int
    kind: str
    process_index: int
    num_cores: int
    memory_bytes: Optional[int]
    compute_capability: Optional[tuple[int, int]] = None

    @staticmethod
    def query(device: torch.device) -> "DeviceProps":
        device = torch.device(device)
        if device.type == "cuda":
            idx = device.index if device.index is not None else torch.cuda.current_device()
            p = torch.cuda.get_device_properties(idx)
            return DeviceProps(platform="gpu", id=idx, kind=p.name, process_index=0,
                               num_cores=p.multi_processor_count,
                               memory_bytes=int(p.total_memory),
                               compute_capability=(p.major, p.minor))
        return DeviceProps(platform=device.type, id=0, kind=device.type, process_index=0,
                           num_cores=os.cpu_count() or 1, memory_bytes=None)


class ExecutionContext:
    """A device and a precision policy, handed to the code that runs on
    them. ``mesh`` is None: the port has no device mesh until it ports
    ``parallel/``, and a context cannot be given one yet."""

    def __init__(self, device: Union[torch.device, str] = "auto", mesh: None = None,
                 precision: PrecisionPolicy = PrecisionPolicy.AUTO):
        if mesh is not None:
            raise NotImplementedError("ExecutionContext takes no mesh: parallel/ is not "
                                      "ported yet")
        self._device = get_device(device) if isinstance(device, str) else torch.device(device)
        self._precision = precision

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def mesh(self) -> None:
        return None

    @property
    def precision(self) -> PrecisionPolicy:
        return self._precision

    @property
    def is_accelerator(self) -> bool:
        return self._device.type != "cpu"

    def props(self) -> DeviceProps:
        return DeviceProps.query(self._device)

    def put(self, x) -> torch.Tensor:
        """``x`` (a tensor, array or nested list) as a tensor on this device."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(self._device)

    def synchronize(self, *arrays) -> None:
        """Wait for the device's outstanding work (``torch.cuda.synchronize``;
        nothing to wait for on the CPU). ``arrays`` are accepted as JAX's
        are: the wait covers them with the rest."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __repr__(self) -> str:
        return (f"ExecutionContext(device={self._device}, mesh=None, "
                f"precision={self._precision.name})")


_default_context: Optional[ExecutionContext] = None


def default_context() -> ExecutionContext:
    """The process's context: ``ExecutionContext("auto")`` (the GPU) unless
    :func:`set_default_context` set another."""
    global _default_context
    if _default_context is None:
        _default_context = ExecutionContext("auto")
        Logger.debug("default ExecutionContext on {}", _default_context.device)
    return _default_context


def set_default_context(ctx: Optional[ExecutionContext]) -> None:
    """Set the process's context (None: back to the lazy "auto" one)."""
    global _default_context
    _default_context = ctx
