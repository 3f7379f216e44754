"""Token + positional embedding (port of ``mila_tpu/ops/embedding.py``) with
JAX's manual VJP: no gradient for the integer tokens; dwte is the
segment sum of the f32 cotangent rows by token, dwpe the sum over the
batch of the first T rows, both cast to the cotangent's dtype.
``embedding_lookup`` is the plain table lookup (JAX differentiates its
``jnp.take``); its backward is the same segment sum, in f32, rounded once
to the table's dtype.

The segment sum must add a token's rows in a fixed order, or two backward
passes over one batch could differ in the last bit and a resumed run
would not be bit-equal to one trained straight through. On the card it is
``index_put_(accumulate=True)``, which sorts the indices first
(``index_add_`` adds repeated tokens there with atomics in a varying
order); on the CPU ``index_add_``, which adds them serially (``index_put_``
adds them from parallel threads there)."""

from __future__ import annotations

from typing import Optional

import torch


def _segment_sum(tokens: torch.Tensor, g: torch.Tensor, V: int) -> torch.Tensor:
    """f32 [V, C]: row v is the sum of g's rows whose token is v, added in
    a fixed order (see the module doc)."""
    C = g.shape[-1]
    g32 = g.float().reshape(-1, C)
    out = torch.zeros(V, C, device=g.device, dtype=torch.float32)
    idx = tokens.reshape(-1).long()
    if g.is_cuda:
        return out.index_put_((idx,), g32, accumulate=True)
    return out.index_add_(0, idx, g32)


class _EncoderFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, wte, wpe):
        x = wte[tokens]
        if wpe is not None:
            x = x + wpe[: tokens.shape[-1]][None]
        ctx.save_for_backward(tokens)
        ctx.shapes = (wte.shape, None if wpe is None else wpe.shape)
        return x

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        (V, C), wpe_shape = ctx.shapes
        dwte = _segment_sum(tokens, g, V).to(g.dtype)
        if wpe_shape is None:
            return None, dwte, None
        T = tokens.shape[-1]
        dwpe = torch.zeros(wpe_shape, device=g.device, dtype=torch.float32)
        dwpe[:T] = g.float().reshape(-1, T, C).sum(dim=0)
        return None, dwte, dwpe.to(g.dtype)


def encoder(tokens: torch.Tensor, wte: torch.Tensor,
            wpe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, T] int; wte [V, C]; wpe [maxT, C] or None -> [B, T, C]."""
    return _EncoderFn.apply(tokens, wte, wpe)


class _LookupFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, table):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens.long()]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        return None, _segment_sum(tokens, g, ctx.rows).to(g.dtype)


def embedding_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain table lookup (no positions): tokens [...] int, table [V, C] ->
    [..., C]."""
    return _LookupFn.apply(tokens, table)
