"""Paged decode attention: one query token per row, GQA, through a page table.

Replaces the TPU kernel ``mila_tpu/kernels/paged_attention.py:_paged_kernel``
(entry ``paged_decode_attention``), reached from the engine's decode step
through ``inference/kv_cache.paged_attention_read``.

Pages keep the JAX layout [P, NKV, HD, ps] (page-major, token-minor), so a
page's tile for one KV head is a contiguous [HD, ps] slab. As in the TPU
kernel, q and the pages need not share a dtype: a bf16 or f32 q over bf16
or f32 pages (``PAIRS``; GPT-2's f32 params serve over bf16 pages) is read
each in its own dtype, with no rounding of q to the pages' dtype, and the
output takes q's.

What bounds it on the H100: the K/V bytes of the live tokens (one query per
row does 2 operations per byte read). The CUDA kernel
(``csrc/paged_decode_attn.cu``) splits each row's pages across blocks
(flash-decoding): the grid is (B * NKV, S), where :func:`plan_splits`
chooses S on the host from B, NKV, the table width W, the page size and the
SM count (never from ``seq_lens``, a device tensor: reading it would stall
the stream and break CUDA-graph capture). Split s owns the pages
:func:`split_pages` gives, the G query heads of a KV head share its block
so each K/V element is read once, and the block rings its chunks through
``cp.async`` (two stages, three for int8 pages) with an online softmax in
f32. With S > 1 the splits
write f32 partials (o, m, l) into scratch this wrapper allocates, and a
second launch merges them with the log-sum-exp rescale; one wrapper call
is one count of ``paged_decode_attention.launches`` either way.

int8 pages (``k_scale``/``v_scale`` [P, NKV, ps] f32, one scale per page,
head and token) halve the K/V bytes. The kernel keeps the TPU kernel's
folding: k_scale multiplies each token's score after the q.k dot, v_scale
its probability before P.V, in f32; the pages themselves are never
dequantized.

The plain version is the gather reference
(``mila_tpu/inference/kv_cache.py:paged_decode_attention_ref``), which is
what the JAX entry point itself runs on the CPU; for int8 pages it
dequantizes the pages to q's dtype first, as JAX's CPU path does, so it
rounds K and V where the kernel folds the scales in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels.quant_matmul import _sm_count
from mila_tpu_torch.ops.attention import NEG_INF

SPLIT_MIN_TOKENS = 128  # a split holds at least one of the kernel's 128-token chunks
SPLIT_BLOCKS_PER_SM = 4  # splits until the grid has this many blocks per SM
# (q dtype, page dtype) pairs the kernel instantiates: the TPU kernel takes q
# in any dtype and stages the pages in theirs; int8 means pages with scales.
PAIRS = {(qd, pd) for qd in (torch.bfloat16, torch.float32)
         for pd in (torch.bfloat16, torch.float32, torch.int8)}


def plan_splits(B: int, NKV: int, W: int, ps: int, sms: int) -> int:
    """The number S of sequence splits per (row, KV head) for a table of
    width W and page size ps: enough for B * NKV * S to reach
    ``SPLIT_BLOCKS_PER_SM`` blocks per SM, each split at least
    ``SPLIT_MIN_TOKENS`` tokens of pages (fewer only if the whole row is
    shorter); 1 <= S <= W. Independent of the rows' lengths."""
    if W <= 1:
        return 1
    min_pages = min(W, -(-SPLIT_MIN_TOKENS // ps))
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(1, B * NKV))
    return max(1, min(W // min_pages, want))


def split_pages(W: int, S: int) -> list[tuple[int, int]]:
    """Split s's pages [s W / S, (s + 1) W / S) of a table row, as the kernel
    computes them: page-aligned, covering [0, W) once, sizes within one."""
    return [(s * W // S, (s + 1) * W // S) for s in range(S)]


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, seq_lens, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Gather-based oracle. q [B, 1, NH, HD]; pages [P, ps, NKV, HD] (one
    layer, token-major); page_table [B, W]; seq_lens [B] -> [B, 1, NH, HD]."""
    B, _, NH, HD = q.shape
    W = page_table.shape[1]
    ps, NKV = k_pages.shape[1], k_pages.shape[2]
    scale = 1.0 / math.sqrt(HD) if scale is None else scale
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, W * ps, NKV, HD)
    v = v_pages[tbl].reshape(B, W * ps, NKV, HD)
    group = NH // NKV
    qg = q.reshape(B, 1, NKV, group, HD)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(W * ps, device=q.device)[None, :]
    valid = pos < seq_lens.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    return out.reshape(B, 1, NH, HD).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                                 k_scale=None, v_scale=None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention` (pages [P, NKV, HD, ps];
    int8 pages with [P, NKV, ps] scales are dequantized first)."""
    paged_decode_attention_plain.calls += 1
    HD = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    kp = k_pages.permute(0, 3, 1, 2)  # [P, ps, NKV, HD]
    vp = v_pages.permute(0, 3, 1, 2)
    if k_scale is not None:
        ks = k_scale.permute(0, 2, 1)[..., None]  # [P, ps, NKV, 1]
        vs = v_scale.permute(0, 2, 1)[..., None]
        kp = (kp.float() * ks).to(q.dtype)
        vp = (vp.float() * vs).to(q.dtype)
    return paged_decode_attention_ref(q, kp, vp, page_table, seq_lens, scale=sm_scale)


paged_decode_attention_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_decode_attn")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_attn.argtypes = [vp] * 11 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        lib.paged_decode_attn.restype = ci
        lib._typed = True
    return lib


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, seq_lens: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Paged KV decode attention. q [B, 1, NH, HD]; pages [P, NKV, HD, ps];
    page_table [B, W] int32; seq_lens [B] int32. Returns [B, 1, NH, HD].

    CUDA tensors launch ``paged_decode_attn`` (a bf16 or f32 q over bf16
    or f32 pages in any pairing, each read in its own dtype, or over int8
    pages with their f32 scales; the output takes q's dtype); CPU tensors
    take :func:`paged_decode_attention_plain`."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                            k_scale=k_scale, v_scale=v_scale, scale=scale)
    B, one, NH, HD = q.shape
    P, NKV, HD2, ps = k_pages.shape
    W = page_table.shape[1]
    if one != 1 or HD2 != HD or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pages {tuple(k_pages.shape)}")
    quant = k_scale is not None or v_scale is not None
    pair = (q.dtype, torch.int8 if quant else k_pages.dtype)
    if pair not in PAIRS or k_pages.dtype != v_pages.dtype:
        raise TypeError(f"paged_decode_attn takes a bf16 or f32 q over bf16 or f32 pages, or "
                        f"int8 pages with scales (q {q.dtype}, pages {k_pages.dtype}/"
                        f"{v_pages.dtype})")
    if quant:
        for t in (k_scale, v_scale):
            if t is None or t.shape != (P, NKV, ps) or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.device != q.device:
                raise ValueError(f"paged_decode_attn: int8 pages need contiguous f32 "
                                 f"k_scale and v_scale of shape {(P, NKV, ps)} on q's device")
    if NH % NKV or NH // NKV > 8 or HD not in (8, 16, 32, 64, 128) or ps % 8:
        raise ValueError(f"paged_decode_attn needs NH/NKV <= 8, HD in (8, 16, 32, 64, 128) "
                         f"and ps % 8 == 0 (NH={NH}, NKV={NKV}, HD={HD}, ps={ps})")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_decode_attn: pages must be contiguous")
    tbl = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = seq_lens.to(device=q.device, dtype=torch.int32).contiguous()
    qc = q.contiguous()
    out = torch.empty_like(qc)
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    S = plan_splits(B, NKV, W, ps, _sm_count(q.device.index or 0))
    o_part = ml_part = None
    if S > 1:
        o_part = torch.empty((B, NH, S, HD), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((2, B, NH, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.paged_decode_attn(
        _build.ptr(qc), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(k_scale) if quant else None, _build.ptr(v_scale) if quant else None,
        _build.ptr(tbl), _build.ptr(lens), _build.ptr(out),
        None if o_part is None else _build.ptr(o_part),
        None if ml_part is None else _build.ptr(ml_part[0]),
        None if ml_part is None else _build.ptr(ml_part[1]),
        B, NH, NKV, HD, ps, W, S, sm_scale, int(q.dtype == torch.float32),
        int(k_pages.dtype == torch.float32), _build.stream_of(q))
    _build.check(lib, rc, "paged_decode_attn")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
