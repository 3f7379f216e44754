"""Token sampling: greedy, temperature, top-k, top-p, CDF multinomial (port
of ``mila_tpu/inference/sampling.py``). Random numbers come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s, so tests
compare greedy tokens exactly and sampled ones by distribution."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1 = off
    greedy: bool = False


def sample_mult(probs: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """CDF multinomial: the first index whose cumulative probability
    exceeds a uniform draw. probs [..., V] -> [...] int32."""
    cdf = torch.cumsum(probs, dim=-1)
    u = torch.rand(probs.shape[:-1] + (1,), generator=generator, device=probs.device,
                   dtype=probs.dtype)
    return (cdf < u).sum(dim=-1).clamp_max(probs.shape[-1] - 1).to(torch.int32)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  config: Optional[SamplingConfig] = None) -> torch.Tensor:
    """Sample token ids from raw logits [..., V] -> [...] int32."""
    cfg = config or SamplingConfig()
    if cfg.greedy or cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / max(cfg.temperature, 1e-6)
    if 0 < cfg.top_k < x.shape[-1]:
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x)
    if cfg.top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs_sorted = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs_sorted, dim=-1)
        # Keep the smallest set with cumulative prob >= top_p (>= 1 token).
        keep_sorted = cum - probs_sorted < cfg.top_p
        kth_val = torch.where(keep_sorted, sorted_x, float("inf")).amin(dim=-1, keepdim=True)
        x = torch.where(x < kth_val, float("-inf"), x)
    return sample_mult(torch.softmax(x, dim=-1), generator)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick:
    logits [..., V] -> [...] int32."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample_categorical(logits: torch.Tensor, temps: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row from softmax(logits / temp) (the engine's on-device
    temperature sampling). logits [B, V] f32, temps [B] -> [B] int32."""
    return categorical(logits / torch.clamp_min(temps[:, None], 1e-6), generator)
