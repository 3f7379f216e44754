"""Parameter initializers (port of the part of ``mila_tpu/tensor/init.py``
that ``Linear``, ``Encoder``, ``LayerNorm`` and ``Conv2D`` use): zeros,
ones, normal, Glorot/Xavier uniform and He normal with the [..., in, out]
weight layout's fans (an HWIO kernel's fan-in is KH * KW * Cin).

Random draws come from an explicit ``torch.Generator`` in f32 on the
generator's device, then move to ``device`` in ``dtype``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

Shape = Sequence[int]


def zeros(shape: Shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def uniform(gen: torch.Generator, shape: Shape, minval: float = -1.0, maxval: float = 1.0,
            dtype=torch.float32, device=None) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (maxval - minval) + minval).to(device=device, dtype=dtype)


def normal(gen: torch.Generator, shape: Shape, stddev: float = 0.02, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Gaussian init (GPT-2 style, stddev 0.02 by default)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * stddev).to(device=device, dtype=dtype)


def _fans(shape: Shape) -> tuple[int, int]:
    """(fan_in, fan_out) for the [..., in, out] weight layout."""
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    receptive = math.prod(int(s) for s in shape[:-2])
    return int(shape[-2]) * receptive, int(shape[-1]) * receptive


def xavier_uniform(gen: torch.Generator, shape: Shape, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -limit, limit, dtype, device)


def he_normal(gen: torch.Generator, shape: Shape, dtype=torch.float32,
              device=None) -> torch.Tensor:
    fan_in, _ = _fans(shape)
    return normal(gen, shape, math.sqrt(2.0 / fan_in), dtype, device)


INITIALIZERS = {
    "normal": normal,
    "uniform": uniform,
    "xavier_uniform": xavier_uniform,
    "xavier": xavier_uniform,
}
