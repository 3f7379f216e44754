"""Decode attention over the contiguous, token-major KV cache.

Replaces two TPU kernels of ``mila_tpu/kernels/dense_attention.py``:

- ``dense_decode_attention`` (``_dense_kernel``): one query per row, GQA,
  over ``[B, T, NKV, HD]`` caches with per-row lengths (the current token
  included). Reached from ``LlamaBlock.apply_with_cache`` and
  ``Llama.forward_with_cache_ragged`` when the params carry no layer pack.
- ``fused_decode_attention`` (``_fused_kernel``): the packed decode path's
  attention. It takes the raw fused qkv row (before RoPE) and tiled RoPE
  tables, ropes q and the new k itself, attends over the ``old_lens[b]``
  cached rows plus the current token, and writes the roped k and the raw v
  into row ``old_lens[b]`` of the caches it is given.

What bounds both on the H100: the K/V bytes of the live rows (one query
per row does 2 operations per byte read). The CUDA kernels
(``csrc/dense_decode_attn.cu``) run one block per (row, KV head): the
G = NH / NKV query heads of that KV head share the block, so each K/V
element is read once, and only rows below the row's length are read (the
TPU kernel skips blocks past ``max(lens)``; a block here stops at its own
row's length). A token's row of one KV head is HD contiguous values, read
as 16-byte words by HD*size/16 neighbouring threads.

The TPU kernel contracts lane-packed queries (``pack_queries``) against
whole ``[T, NKV*HD]`` slabs to keep the MXU busy; the CUDA kernels index
the KV head directly and need no packed queries, so
``fused_decode_attention`` accepts ``q_pk=None`` and ignores it otherwise.

The fused kernel writes the new rows in place, as the aliased Pallas call
does: the returned caches are the tensors passed in. Its plain version
(``fused_decode_attention_plain``, the port of
``_fused_decode_attention_ref``) writes them with an in-place index write.
Rows with ``old_lens[b] >= T`` are not written (JAX drops the out-of-range
scatter).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.ops.attention import decode_attention


def pack_queries(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """[..., NH, HD] -> [..., NH, NKV*HD]: head n's vector lands in its kv
    head's lane range (n // group), zeros elsewhere."""
    *lead, NH, HD = q.shape
    group = NH // nkv
    onehot = torch.nn.functional.one_hot(torch.arange(NH, device=q.device) // group,
                                         nkv).to(q.dtype)  # [NH, NKV]
    qj = torch.einsum("...nd,nj->...njd", q, onehot)
    return qj.reshape(*lead, NH, nkv * HD)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def dense_decode_attention_plain(q, k_cache, v_cache, lens, *,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`dense_decode_attention` (``ops.decode_attention``,
    which is what the JAX entry point runs on the CPU)."""
    dense_decode_attention_plain.calls += 1
    squeeze = q.ndim == 4
    q4 = q if squeeze else q[:, None]
    out = decode_attention(q4, k_cache, v_cache, lens, scale=scale)
    return out if squeeze else out[:, 0]


def _rope_flat(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor, hd: int) -> torch.Tensor:
    """x * c + swap_halves(x) * s per head of width hd, in f32, cast back."""
    xg = x.reshape(*x.shape[:-1], x.shape[-1] // hd, hd)
    y = torch.cat([xg[..., hd // 2:], xg[..., : hd // 2]], dim=-1).reshape(x.shape)
    return (x.float() * c.float() + y.float() * s.float()).to(x.dtype)


def fused_decode_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens, *,
                                 num_heads: int, scale: Optional[float] = None):
    """Plain version of :func:`fused_decode_attention` (port of
    ``_fused_decode_attention_ref``): rope via the tiled tables, write the
    new row in place, then decode attention over old rows + the current."""
    fused_decode_attention_plain.calls += 1
    B, T, NKV, HD = k_cache.shape
    KD, NQ = NKV * HD, num_heads * HD
    k_new = _rope_flat(qkv[:, NQ:NQ + KD], cos_t, sin_t, HD)
    v_new = qkv[:, NQ + KD:]
    q = _rope_flat(qkv[:, :NQ], cos_t[:, :HD].repeat(1, num_heads),
                   sin_t[:, :HD].repeat(1, num_heads), HD)
    lens = old_lens.to(device=k_cache.device, dtype=torch.long)
    live = lens < T
    rows = torch.arange(B, device=k_cache.device)[live]
    kc, vc = k_cache.view(B, T, KD), v_cache.view(B, T, KD)
    kc[rows, lens[live]] = k_new[live].to(kc.dtype)
    vc[rows, lens[live]] = v_new[live].to(vc.dtype)
    out = decode_attention(q.reshape(B, 1, num_heads, HD), k_cache, v_cache, lens + 1,
                           scale=scale)
    return out[:, 0], k_new, k_cache, v_cache


dense_decode_attention_plain.calls = 0
fused_decode_attention_plain.calls = 0

# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_HDS = (8, 16, 32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.library("dense_decode_attn")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_decode_attn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, vp]
        lib.dense_decode_attn.restype = ci
        lib.fused_decode_attn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                          cf, ci, vp]
        lib.fused_decode_attn.restype = ci
        lib._typed = True
    return lib


def _check_heads(NH: int, NKV: int, HD: int, dtype) -> None:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dense_decode_attn takes bf16/f32 tensors, got {dtype}")
    if NH % NKV or NH // NKV > 8 or HD not in _HDS or (dtype == torch.float32 and HD < 8):
        raise ValueError(f"dense_decode_attn needs NH/NKV <= 8 and HD in {_HDS} "
                         f"(NH={NH}, NKV={NKV}, HD={HD})")


def _check_cache(k_cache, v_cache, dtype) -> None:
    if v_cache.shape != k_cache.shape or k_cache.dtype != dtype or v_cache.dtype != dtype:
        raise TypeError("dense_decode_attn: k/v caches must share q's dtype and shape "
                        f"(q {dtype}, caches {k_cache.dtype}/{v_cache.dtype})")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("dense_decode_attn: caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("dense_decode_attn: caches must be 16-byte aligned (16-byte loads)")


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lens: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the dense cache. q [B, 1, NH, HD] or [B, NH, HD];
    caches [B, T, NKV, HD]; lens [B] int32 = valid rows including the current
    token. Returns q's shape.

    CUDA tensors launch ``dense_decode_attn``; CPU tensors take
    :func:`dense_decode_attention_plain`."""
    if not q.is_cuda:
        return dense_decode_attention_plain(q, k_cache, v_cache, lens, scale=scale)
    B, T, NKV, HD = k_cache.shape
    NH = q.shape[-2]
    if q.shape[-1] != HD or q.numel() != B * NH * HD:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _check_heads(NH, NKV, HD, q.dtype)
    _check_cache(k_cache, v_cache, q.dtype)
    qc = q.contiguous()
    ln = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    lib = _lib()
    rc = lib.dense_decode_attn(
        _build.ptr(qc), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(ln),
        _build.ptr(out), B, T, NH, NKV, HD, sm_scale, int(q.dtype == torch.float32),
        _build.stream_of(q))
    _build.check(lib, rc, "dense_decode_attn")
    dense_decode_attention.launches += 1
    return out


def fused_decode_attention(qkv: torch.Tensor, q_pk: Optional[torch.Tensor],
                           cos_t: torch.Tensor, sin_t: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, old_lens: torch.Tensor, *, num_heads: int,
                           scale: Optional[float] = None):
    """In-kernel RoPE + dense-cache decode attention + cache write-back.

    qkv [B, NQ + 2*NKV*HD] raw fused projection (before RoPE); ``q_pk`` is
    accepted for the JAX signature and not used; cos_t/sin_t [B, NKV*HD]
    tiled tables (cos duplicated over the halves, sin pre-signed
    ``[-sin | sin]``); caches [B, T, NKV, HD] (the kernel, like the TPU
    kernel, takes T % 8 == 0 only); old_lens [B] = live rows, the current
    token excluded.

    Returns (att [B, NH, HD], k_new [B, NKV*HD] roped in qkv's dtype,
    k_cache, v_cache) where the caches are the tensors given, row
    ``old_lens[b]`` now holding the roped k and the raw v."""
    del q_pk
    B, T, NKV, HD = k_cache.shape
    NH = num_heads
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    if not qkv.is_cuda:
        return fused_decode_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens,
                                            num_heads=NH, scale=sm_scale)
    if T % 8:
        raise ValueError(f"fused_decode_attention needs T % 8 == 0 (got T={T}): "
                         "init_kv_cache rounds the cache length up")
    KD, NQ = NKV * HD, NH * HD
    if qkv.shape != (B, NQ + 2 * KD) or cos_t.shape != (B, KD) or sin_t.shape != (B, KD):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} cos {tuple(cos_t.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    _check_heads(NH, NKV, HD, qkv.dtype)
    _check_cache(k_cache, v_cache, qkv.dtype)
    qc = qkv.contiguous()
    c32 = cos_t.to(torch.float32).contiguous()
    s32 = sin_t.to(torch.float32).contiguous()
    ln = old_lens.to(device=qkv.device, dtype=torch.int32).contiguous()
    att = torch.empty((B, NH, HD), dtype=qkv.dtype, device=qkv.device)
    k_new = torch.empty((B, KD), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    rc = lib.fused_decode_attn(
        _build.ptr(qc), _build.ptr(c32), _build.ptr(s32), _build.ptr(k_cache),
        _build.ptr(v_cache), _build.ptr(ln), _build.ptr(att), _build.ptr(k_new),
        B, T, NH, NKV, HD, sm_scale, int(qkv.dtype == torch.float32), _build.stream_of(qkv))
    _build.check(lib, rc, "fused_decode_attn")
    fused_decode_attention.launches += 1
    return att, k_new, k_cache, v_cache


dense_decode_attention.launches = 0
fused_decode_attention.launches = 0
