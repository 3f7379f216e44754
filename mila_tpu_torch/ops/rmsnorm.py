"""RMSNorm forward (port of ``mila_tpu/ops/rmsnorm.py``): f32 statistics."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, in f32."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rstd * gamma.float()).to(x.dtype)
