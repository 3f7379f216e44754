"""Residual add (port of ``mila_tpu/ops/residual.py``)."""

from __future__ import annotations

import torch


def residual(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return x + skip
