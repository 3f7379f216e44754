"""LayerNorm over the last axis (port of ``mila_tpu/ops/layernorm.py``):
f32 statistics whatever the input's dtype, the output in x's dtype, and
JAX's manual VJP (``_ln_bwd``) as a ``torch.autograd.Function``:

    dgamma = sum(g * xhat), dbeta = sum(g)       (f32, cast to gamma's dtype)
    dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)),  dy = g * gamma

from the cached mean and rstd. Both directions run as one ATen call on the
f32-widened input (``native_layer_norm`` / ``native_layer_norm_backward``
compute these formulas in f32; the variance there is Welford's where JAX
takes mean((x - mean)^2), equal to f32 rounding).
"""

from __future__ import annotations

import torch


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        C = x.shape[-1]
        x32 = x.float()
        y, mean, rstd = torch.native_layer_norm(x32, (C,), gamma.float(), beta.float(), eps)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        C = x.shape[-1]
        dx, dgamma, dbeta = torch.ops.aten.native_layer_norm_backward(
            g.float(), x.float(), (C,), mean, rstd, gamma.float(), beta.float(),
            [True, True, True])
        return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x [..., C]; gamma, beta [C] -> [..., C] in x's dtype."""
    return _LayerNormFn.apply(x, gamma, beta, eps)
