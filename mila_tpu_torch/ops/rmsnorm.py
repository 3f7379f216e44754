"""RMSNorm over the last axis (port of ``mila_tpu/ops/rmsnorm.py``): f32
statistics whatever the input's dtype, the output in x's dtype, and JAX's
manual VJP (``_rms_bwd``) as a ``torch.autograd.Function``. The forward
saves x and the f32 rstd; the backward is

    xhat = x * rstd,  dgamma = sum(g * xhat)   (f32, cast to gamma's dtype)
    dx = rstd * (dy - xhat * mean(dy * xhat)),  dy = g * gamma

all in f32, each gradient rounded once to its input's dtype.
"""

from __future__ import annotations

import torch


def _rstd(x32: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        x32 = x.float()
        rstd = _rstd(x32, eps)
        ctx.save_for_backward(x, gamma, rstd)
        return (x32 * rstd * gamma.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, gamma, rstd = ctx.saved_tensors
        C = x.shape[-1]
        g32 = g.float()
        xhat = x.float() * rstd
        dgamma = (g32 * xhat).reshape(-1, C).sum(dim=0).to(gamma.dtype)
        dy = g32 * gamma.float()
        m = (dy * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (dy - xhat * m)).to(x.dtype)
        return dx, dgamma, None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, in f32."""
    return _RMSNormFn.apply(x, gamma, eps)


def rms_norm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The oracle: the same forward, differentiated by PyTorch's autograd
    (gamma taken in its own dtype, as JAX's ``rms_norm_ref`` does)."""
    x32 = x.float()
    return (x32 * _rstd(x32, eps) * gamma).to(x.dtype)
