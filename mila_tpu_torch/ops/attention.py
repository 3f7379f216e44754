"""Grouped-query attention (port of ``mila_tpu/ops/attention.py``).

``attention`` is the backend dispatcher the model's prefill calls route
through: ``resolve_attention_impl`` sends a CUDA call of at least
``FLASH_MIN_SEQ`` keys to the flash kernel
(``kernels/flash_attention.py``) where ``flash_tiles_ok`` passes its shape,
and everything else, CPU tensors always, to ``dot_product_attention``, a
plain product outside any kernel (the
backend the JAX package names ``"xla"``; the port keeps the name so that
configs carry over). ``mha_qkv`` is the fused-QKV
convention of the GPT-2 block. ``decode_attention`` is the one-query attention over
the contiguous cache, the plain version of the dense decode kernel
(``kernels/dense_attention.py``). Scores, softmax and the
probability-value product run in f32; probabilities are rounded to v's
dtype before the second product, as JAX's ``probs.astype(v.dtype)`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative mask value, safe in bf16/f32

# The JAX package's crossover, kept as it is; the H100's own is measured by
# chip_smoke.py's crossover table (PERF.md).
FLASH_MIN_SEQ = 2048


def resolve_attention_impl(impl: str = "auto", seq_len: int = 0, device=None) -> str:
    """Resolve an attention backend name: ``"auto"`` is the flash kernel
    for a CUDA call over at least ``FLASH_MIN_SEQ`` keys (or an unknown
    length, 0) and the plain product otherwise; CPU tensors always take the
    plain product, as the JAX package does on its CPU backend."""
    if impl == "auto":
        if device is None or torch.device(device).type != "cuda":
            return "xla"
        return "flash" if (seq_len == 0 or seq_len >= FLASH_MIN_SEQ) else "xla"
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl '{impl}'")
    return impl


def flash_tiles_ok(t_q: int, t_kv: int, head_dim: int) -> bool:
    """The JAX flash wrapper's tiling gate: shapes it refuses (Tq % 16,
    Tkv % 128 or D % 64 not 0) take its plain reference instead."""
    return not (t_q % 16 or t_kv % 128 or head_dim % 64)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, impl: str = "auto",
              **kw) -> torch.Tensor:
    """Backend-dispatching attention (the model routes through this; the
    plain :func:`dot_product_attention` stays the oracle). A flash call at
    a shape the tiling gate refuses takes the plain product here, as the
    JAX package's flash wrapper sends it to its reference."""
    if (resolve_attention_impl(impl, seq_len=k.shape[1], device=q.device) == "flash"
            and flash_tiles_ok(q.shape[1], k.shape[1], q.shape[3])):
        from mila_tpu_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, **kw)
    return dot_product_attention(q, k, v, **kw)


def causal_mask(t_q: int, t_kv: int, offset: int = 0, device=None) -> torch.Tensor:
    """[t_q, t_kv] boolean mask; True = attend. Query i sees keys <= i+offset."""
    qi = torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_kv, device=device)[None, :]
    return kj <= qi + offset


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          kv_offset: int = 0) -> torch.Tensor:
    """q [B, Tq, NH, HS]; k, v [B, Tkv, NKV, HS], NH % NKV == 0 -> [B, Tq, NH, HS].
    ``mask`` broadcasts to [B, Tq, Tkv] (True = attend)."""
    B, Tq, NH, HS = q.shape
    _, Tkv, NKV, _ = k.shape
    if NH % NKV != 0:
        raise ValueError(f"num_heads {NH} not divisible by num_kv_heads {NKV}")
    group = NH // NKV
    scale = 1.0 / math.sqrt(HS) if scale is None else scale
    qg = q.float().reshape(B, Tq, NKV, group, HS)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        cm = causal_mask(Tq, Tkv, kv_offset, device=q.device)
        scores = torch.where(cm[None, None, None], scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(B, Tq, NH, HS).to(q.dtype)


def mha_qkv(qkv: torch.Tensor, num_heads: int, *, causal: bool = True,
            scale: Optional[float] = None) -> torch.Tensor:
    """Causal MHA from fused QKV [B, T, 3C] (Q|K|V, C = num_heads * head
    size) -> [B, T, C], through :func:`dot_product_attention` (the JAX
    package's ``mha_qkv``; differentiable by PyTorch's autograd, as JAX's is
    by its own)."""
    B, T, C3 = qkv.shape
    if C3 % 3 != 0:
        raise ValueError(f"fused QKV last dim {C3} not divisible by 3")
    C = C3 // 3
    if C % num_heads != 0:
        raise ValueError(f"embedding dim {C} not divisible by num_heads {num_heads}")
    HS = C // num_heads
    q, k, v = (t.reshape(B, T, num_heads, HS) for t in qkv.split(C, dim=-1))
    return dot_product_attention(q, k, v, causal=causal, scale=scale).reshape(B, T, C)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-query decode attention over a contiguous token-major cache.

    q [B, 1, NH, HS]; k_cache, v_cache [B, maxT, NKV, HS]; cache_len [B] =
    valid rows per sequence, the current token included. Rows >= cache_len
    are masked. Returns [B, 1, NH, HS]."""
    B, _, NH, HS = q.shape
    maxT, NKV = k_cache.shape[1], k_cache.shape[2]
    group = NH // NKV
    scale = 1.0 / math.sqrt(HS) if scale is None else scale
    qg = q.float().reshape(B, 1, NKV, group, HS)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    pos = torch.arange(maxT, device=q.device)[None, :]
    valid = pos < cache_len.to(q.device).long()[:, None]  # [B, maxT]
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v_cache.float())
    return out.reshape(B, 1, NH, HS).to(q.dtype)
