"""Softmax cross-entropy from raw logits and integer targets (port of
``mila_tpu/ops/cross_entropy.py``): per-example loss [...] from logits
[..., V], rows whose target is ``ignore_index`` contributing loss 0 and
gradient 0.

Forward and backward are the fused kernel (kernel table row 18,
``kernels/softmax_ce.py``) on every device: its plain versions on the CPU,
the CUDA kernel on the card. JAX's op computes the same function (its VJP
uses exp(x - lse) where the kernel divides by the sum; equal to f32
rounding, as ``tests/kernels/test_fused_kernels.py`` holds them).
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          ignore_index: int = -100) -> torch.Tensor:
    from mila_tpu_torch.kernels.softmax_ce import fused_softmax_cross_entropy

    return fused_softmax_cross_entropy(logits, targets, ignore_index)


def cross_entropy_from_probs(probs: torch.Tensor, targets: torch.Tensor,
                             eps: float = 1e-10) -> torch.Tensor:
    """Plain CE over probabilities already softmaxed: -log(p[target] +
    eps) in f32 per example (no kernel: JAX's is a plain gather)."""
    picked = torch.gather(probs.float(), -1, targets.long()[..., None])[..., 0]
    return -torch.log(picked + eps)
