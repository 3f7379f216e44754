"""Softmax over one axis (port of ``mila_tpu/ops/softmax.py``): f32 inside,
the output in x's dtype, and JAX's manual VJP dx = y * (g - sum(g * y))
in f32; ``log_softmax`` in f32 without a manual VJP, as JAX's."""

from __future__ import annotations

import torch


class _SoftmaxFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = torch.softmax(x.float(), dim=axis).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.axis = axis
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        y32, g32 = y.float(), g.float()
        dot = (g32 * y32).sum(dim=ctx.axis, keepdim=True)
        return (y32 * (g32 - dot)).to(y.dtype), None


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _SoftmaxFn.apply(x, axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """x - max - log(sum(exp(x - max))) over ``axis`` in f32, the output in
    x's dtype (JAX differentiates its plain form; so does autograd here)."""
    x32 = x.float()
    z = x32 - x32.amax(dim=axis, keepdim=True)
    return (z - torch.log(torch.exp(z).sum(dim=axis, keepdim=True))).to(x.dtype)
