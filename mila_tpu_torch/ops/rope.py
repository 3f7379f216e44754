"""Rotary position embeddings (port of ``mila_tpu/ops/rope.py``):
split-half (HF Llama) convention with optional Llama-3 frequency scaling,
and the interleaved (GPT-NeoX) one. Both differentiate through PyTorch's
autograd, as JAX's do through its own."""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     scaling: Optional[dict] = None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] in f32, with optional llama3 scaling."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / torch.pow(float(theta), exps)
    if scaling and scaling.get("rope_type") in ("llama3",):
        factor = scaling.get("factor", 8.0)
        low_factor = scaling.get("low_freq_factor", 1.0)
        high_factor = scaling.get("high_freq_factor", 4.0)
        old_len = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2.0 * math.pi / inv
        low_wl = old_len / low_factor
        high_wl = old_len / high_factor
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        scaled = torch.where(wavelen > low_wl, inv / factor, inv)
        smoothed = (1 - smooth) * inv / factor + smooth * inv
        is_medium = (wavelen <= low_wl) & (wavelen >= high_wl)
        inv = torch.where(is_medium, smoothed, scaled)
    return inv


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 scaling: Optional[dict] = None,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions: each [..., T, head_dim/2]."""
    inv = rope_frequencies(head_dim, theta, scaling, device=positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, n_heads, head_dim]; cos/sin [..., T, d/2].
    (x1, x2) -> (x1*cos - x2*sin, x2*cos + x1*sin), in f32."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-NeoX interleaved convention: the pairs (x[2i], x[2i+1]) rotated,
    in f32; shapes as :func:`apply_rope`."""
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
