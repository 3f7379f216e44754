"""Learning-rate schedules (port of ``mila_tpu/optim/schedules.py``):
step -> lr as a 0-dim f32 tensor, computed in f32 as JAX computes it."""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: _f(lr)


def _progress(s, warmup_steps, total_steps):
    return torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_lr: float = 0.0) -> Schedule:
    def fn(step):
        s = _f(step)
        warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
        progress = _progress(s, warmup_steps, total_steps)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (1.0 + torch.cos(math.pi * progress))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_lr: float = 0.0) -> Schedule:
    def fn(step):
        s = _f(step)
        warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
        lin = peak_lr + (final_lr - peak_lr) * _progress(s, warmup_steps, total_steps)
        return torch.where(s < warmup_steps, warm, lin)

    return fn


def step_decay(lr: float, decay_rate: float, decay_every: int) -> Schedule:
    def fn(step):
        return _f(lr) * decay_rate ** torch.floor(_f(step) / decay_every)

    return fn
