"""SwiGLU forward (port of ``mila_tpu/ops/swiglu.py``)."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, the Llama FFN nonlinearity."""
    return silu(gate) * up
