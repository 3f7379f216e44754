"""The MLP block at decode shapes as one weight stream: wo(+res) -> RMSNorm
-> gate|up -> SwiGLU -> down(+res) (port of ``mila_tpu/kernels/decode_mlp.py``).

Replaces the TPU kernels ``_mlp_mega_kernel`` (the grid version, what the
JAX package runs on the CPU in interpret mode) and ``_mlp_manual_kernel``
(the manual-DMA version it runs on the TPU), entry ``mlp_block_fused``.
``LlamaBlock._finish_attn`` reaches it when a block carries ``mlp_pack``
(``models/llama.py:pack_decode_mlp``).

The pack (``pack_mlp``) is ``pack_layer``'s stream without a next wqkv, at
bn = 2048 by default: uniform [bk = H, bn] int8 or fp8 tiles in the order
``[wo | g0 u0 g1 u1 ... | down k-major]`` with one f32 scale row per tile
(the fp8 fixup folded in), byte for byte the JAX pack.

What bounds it on the H100: the one-byte weights (54.5 MB at Llama-3.2-1B;
2 * M operations per byte at M <= 32). Its arithmetic and tile order are
the first six phases of the layer-tail kernel (x1 = (att @ wo) * s + x in
f32, xn = bf16(x1 * rstd * gamma), h = bf16(silu(g) * u), out = (h @ down)
* s + x1), so on CUDA tensors it is that kernel (``csrc/layer_tail_int8.cu``
through ``kernels/layer_fused.launch_tail``) launched with no next wqkv; it
keeps its own launch count.

The plain version (``mlp_block_plain``) repeats ``_mlp_mega_kernel``'s
rounding: x1 in f32, xn and h in bf16, f32 products of bf16 operands
scaled per tile, ``out = acc + x1`` cast to x's dtype. ``mlp_block_ref`` is
the JAX package's oracle of that kernel (``quant_linear_ref`` products,
x1 rounded to x's dtype).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mila_tpu_torch.inference.quantize import QTensor, quant_linear_ref
from mila_tpu_torch.kernels.layer_fused import _w_scale_fixup, launch_tail, pack_layer
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.swiglu import swiglu


class MLPPack(NamedTuple):
    """Tiled-and-stacked MLP weights (see module doc)."""

    w: torch.Tensor  # [T, bk, bn] int8 / fp8
    s: torch.Tensor  # [T, 1, bn] f32, fp8 fixup folded
    h_dim: int  # H (= bk)
    i_dim: int
    bn: int
    n_wo: int  # H // bn
    n_gu: int  # 2 * I // bn
    n_down: int  # (I // bk) * (H // bn)


def pack_mlp(wo: QTensor, wgu: QTensor, down: QTensor, *, bn: int = 2048) -> Optional[MLPPack]:
    """Stack wo/wgu/down into the stream layout (``pack_layer``'s without a
    next wqkv). None when the shapes do not fit, as JAX: wo [H, H], wgu
    [H, 2I], down [I, H] with bn | H, bn | I, H | I, one-byte weights of one
    dtype, every block_size a multiple of H; int4-packed tensors are
    refused."""
    if wo.q.element_size() != 1:
        return None
    lp = pack_layer(wo, wgu, down, None, bn=bn)
    return None if lp is None else MLPPack(*lp[:8])


# ---------------------------------------------------------------------------
# Plain version and oracle
# ---------------------------------------------------------------------------

def _tile(pack: MLPPack, t: int) -> torch.Tensor:
    """Tile t as the bf16 operand's f32 values (fp8: the fixup undone)."""
    return pack.w[t].float() / _w_scale_fixup(pack.w.dtype)


def mlp_block_plain(a2, x2, gamma, pack: MLPPack, *, eps: float) -> torch.Tensor:
    """``_mlp_mega_kernel``'s arithmetic, tile by tile. a2, x2 [M, H] ->
    [M, H] in x's dtype."""
    mlp_block_plain.calls += 1
    H, bn = pack.h_dim, pack.bn
    att = a2.to(torch.bfloat16).float()
    x1 = torch.cat([(att @ _tile(pack, t)) * pack.s[t, 0] + x2[:, t * bn:(t + 1) * bn].float()
                    for t in range(pack.n_wo)], dim=-1)
    rstd = torch.rsqrt(x1.square().mean(dim=-1, keepdim=True) + eps)
    xn = (x1 * rstd * gamma.float()).to(torch.bfloat16).float()
    t0 = pack.n_wo
    h = []
    for j in range(pack.n_gu // 2):
        g = (xn @ _tile(pack, t0 + 2 * j)) * pack.s[t0 + 2 * j, 0]
        u = (xn @ _tile(pack, t0 + 2 * j + 1)) * pack.s[t0 + 2 * j + 1, 0]
        h.append((g * torch.sigmoid(g) * u).to(torch.bfloat16).float())
    h = torch.cat(h, dim=-1)
    t0 += pack.n_gu
    n_cols = H // bn
    acc = torch.zeros_like(x1)
    for jd in range(pack.n_down):
        k, n = divmod(jd, n_cols)
        p = (h[:, k * H:(k + 1) * H] @ _tile(pack, t0 + jd)) * pack.s[t0 + jd, 0]
        acc[:, n * bn:(n + 1) * bn] += p
    return (acc + x1).to(x2.dtype)


mlp_block_plain.calls = 0


def mlp_block_ref(att: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, wo: QTensor,
                  wgu: QTensor, down: QTensor, *, eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's oracle of :func:`mlp_block_fused` (same math,
    unfused, on the unpacked weights)."""
    H = x.shape[-1]
    x1 = (quant_linear_ref(att.reshape(-1, H), wo).float() + x.reshape(-1, H).float()).to(x.dtype)
    g, u = quant_linear_ref(rms_norm(x1, gamma, eps), wgu).chunk(2, dim=-1)
    out = quant_linear_ref(swiglu(g, u), down).float() + x1.float()
    return out.to(x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def mlp_block_fused(att: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, pack: MLPPack, *,
                    eps: float = 1e-5, depth: int = 3) -> torch.Tensor:
    """x1 = att @ wo + x; h = swiglu(rmsnorm(x1, gamma) @ wgu); return
    h @ down + x1. att, x [..., H] with at most 32 rows. ``depth`` (the TPU
    kernel's weight-ring depth) is accepted for the JAX signature and not
    used.

    CUDA tensors launch ``layer_tail_int8`` with no next wqkv; CPU tensors
    take :func:`mlp_block_plain`."""
    del depth
    H = pack.h_dim
    a2, x2 = att.reshape(-1, H), x.reshape(-1, H)
    if x2.shape[0] > 32:
        raise ValueError(f"mlp_block_fused is decode-only (M={x2.shape[0]} > 32)")
    if not x.is_cuda:
        return mlp_block_plain(a2, x2, gamma, pack, eps=eps).reshape(x.shape)
    out, _ = launch_tail(a2, x2, gamma, None, pack.w, pack.s, base=0, h_dim=H,
                         i_dim=pack.i_dim, bn=pack.bn, n_qkv=0, eps=eps)
    mlp_block_fused.launches += 1
    return out.reshape(x.shape)


mlp_block_fused.launches = 0
