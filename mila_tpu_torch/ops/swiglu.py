"""SwiGLU (port of ``mila_tpu/ops/swiglu.py``): ``silu(gate) * up`` in the
inputs' dtype, with JAX's manual VJP (``_swiglu_bwd``) as a
``torch.autograd.Function``, in f32 inside:

    s = sigmoid(gate),  dsilu = s + gate * s * (1 - s)
    dgate = g * up * dsilu,  dup = g * gate * s

each rounded once to its input's dtype."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class _SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return silu(gate) * up

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        gf = gate.float()
        s = torch.sigmoid(gf)
        dsilu = s + gf * s * (1.0 - s)
        g32 = g.float()
        dgate = (g32 * up.float() * dsilu).to(gate.dtype)
        dup = (g32 * (gf * s)).to(up.dtype)
        return dgate, dup


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, the Llama FFN nonlinearity."""
    return _SwiGLUFn.apply(gate, up)
