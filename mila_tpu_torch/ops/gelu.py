"""GELU: exact, tanh and sigmoid forms (port of ``mila_tpu/ops/gelu.py``),
each a ``torch.autograd.Function`` whose backward is JAX's closed-form
derivative times the cotangent.

Elementwise, in f32 with one rounding to the input's dtype at the end (XLA
keeps a fused elementwise chain in f32 the same way). The tanh and exact
forms run as one ATen call each way (``gelu`` / ``gelu_backward``, which
compute these formulas in f32); the sigmoid form is written out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
GELU_COEF = 0.044715
_ATEN = {"tanh": "tanh", "exact": "none"}


def _sigmoid_fwd(x32):
    return x32 * torch.sigmoid(1.702 * x32)


def _sigmoid_grad(x32):
    s = torch.sigmoid(1.702 * x32)
    return s + 1.702 * x32 * s * (1.0 - s)


class _GeluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, approximation):
        ctx.save_for_backward(x)
        ctx.approximation = approximation
        if approximation == "sigmoid":
            return _sigmoid_fwd(x.float()).to(x.dtype)
        return F.gelu(x, approximate=_ATEN[approximation])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = ctx.approximation
        if a == "sigmoid":
            return (g.float() * _sigmoid_grad(x.float())).to(x.dtype), None
        return torch.ops.aten.gelu_backward(g, x, approximate=_ATEN[a]), None


GELU_VARIANTS = ("tanh", "exact", "sigmoid")


def gelu(x: torch.Tensor, approximation: str = "tanh") -> torch.Tensor:
    if approximation not in GELU_VARIANTS:
        raise ValueError(f"unknown GELU approximation '{approximation}'; options: "
                         f"{sorted(GELU_VARIANTS)}")
    return _GeluFn.apply(x, approximation)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    return gelu(x, "tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """x Phi(x), Phi the standard normal CDF."""
    return gelu(x, "exact")


def gelu_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """x sigmoid(1.702 x)."""
    return gelu(x, "sigmoid")
