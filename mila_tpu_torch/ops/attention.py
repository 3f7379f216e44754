"""Grouped-query attention (port of ``mila_tpu/ops/attention.py``).

``dot_product_attention`` is the prefill attention of the paged engine: a
plain product outside any kernel (the JAX package hands it to XLA below
``FLASH_MIN_SEQ``). Scores, softmax and the probability-value product run
in f32; probabilities are rounded to v's dtype before the second product,
as JAX's ``probs.astype(v.dtype)`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative mask value, safe in bf16/f32


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
