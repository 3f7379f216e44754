"""Flash attention: causal grouped-query attention without the [Tq, Tkv]
score matrix in device memory, forward and (through autograd) backward.

Replaces the TPU kernels ``mila_tpu/kernels/flash_attention.py:_fa_kernel``
and ``_fa_kernel_t`` (entry ``flash_attention`` ->
``_flash_attention_forward``): ``flash_attention`` is the primal launch,
which writes no row statistics; ``flash_attention_forward`` is the launch
under autograd (``save_stats=True``), which also writes each row's softmax
sum l and max m, f32 [B, NH, Tq] (the TPU pads them to 128 lanes; here they
are not padded). When grad is enabled and an input requires it,
``flash_attention`` runs ``_FlashFn``: that forward and, in its backward,
``kernels.flash_attention_bwd.flash_attention_bwd`` (JAX's ``_fa_fwd`` /
``_fa_bwd``). The model's prefill reaches it through
``ops.attention.attention`` from ``FLASH_MIN_SEQ`` keys up on the card, where the
plain product would materialise f32 scores [B, NKV, G, T, T] (2.1 GB per
layer at T 4096, 32 heads).

What bounds it on the H100: tensor-core operations (4 * Tq * Tkv * D per
head, about half of them skipped by the causal tiles) against Tq + 2 Tkv
rows of D bf16 or fp16 values, and at D 64 nearly as much the exponentials.
The CUDA kernel (``csrc/flash_fwd.cu``, bf16 and fp16 at D 64-320) runs
a block per (128 query rows, head, batch row): one thread streams the q
tile and the K/V tiles (128 keys at D 64, 32 at D 320, else 64) through shared
memory with TMA (3-D maps, 128-byte swizzle, a ring of mbarriers), and two
warpgroups of 64 query rows each run S = Q K^T and O += P V on ``wgmma``
(P from registers), taking turns so that one's online softmax in f32 (one
FFMA and one ``ex2`` per score) runs under the other's products; at D 192,
256 and 320 they run without the loading thread's warp, one of their own
threads issuing the loads, so that O may take D / 2 registers a thread.
The wrapper encodes the three TMA descriptors per call, so a CUDA graph
replays valid ones; a base that is not 16-byte aligned is copied first.

f32 launches the tf32 family (``csrc/flash_tf32_fwd.cu``): a prep launch
writes K rounded to tf32 and V rounded and transposed (tf32 ``wgmma`` takes
no transpose bit), then the same block shape on TMA and tf32 ``wgmma`` (one
warpgroup with 32-key tiles at D 192 and 256), Q's rows rounded once in
shared memory, p rounded to tf32 before P V (ROADMAP §C.2). Past D 256 (f32)
and D 320 (bf16, fp16) both families run a block of 64 query rows and one
column part of O, up to 512 columns (``plan_wide``): its two warpgroups each form the key tile's whole S
once and add P V into their own half of the part's columns (bf16 and fp16
on 32- or 64-key tiles, f32 on 16-key tiles), Q resident in shared memory
or, where it does not fit, streamed beside K. The backward takes the
``wgmma`` kernels for bf16 and fp16 at every D (past 256 on column parts,
``plan_bwd``), the tf32 ones for f32 at D 64 and 128, and
``csrc/flash_sync_bwd.cu`` for f32 from D 192: 8-warp blocks that form S
and dP once a tile on tf32 ``wgmma``, dP on split operands summed in f32.
``routes`` names the family of each pass.

Semantics kept from the TPU kernel: the causal tile skip with
``kv_offset``, masked scores at -0.7 * f32max, p rounded to V's dtype
before P @ V while the row sum l adds the f32 p, l == 0 guarded at the
store, and query head h reading KV head h // G. Its tiling gate stays too
(``ops.flash_tiles_ok``): ``ops.attention`` sends Tq % 16, Tkv % 128 or D %
64 not 0 to the plain product (``ops.dot_product_attention``), as JAX's
wrapper sends them to its jnp reference; on the card this wrapper raises
for them. GPT-2's ``Attention`` reaches it through ``nn.layers.Attention``
with ``impl="flash"``, under grad in training.

``flash_attention_plain`` is the kernel's arithmetic in one pass over all
keys (the running max of the tiles is the row max here; the results agree
to f32 and bf16 rounding); with ``save_stats`` it returns l and m too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.ops.attention import causal_mask, dot_product_attention, flash_tiles_ok

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_KV_TILE = 128  # Tkv's multiple: csrc/flash_fwd.cu's key tiles are 128 or 64 keys
# The forward runs on TMA + wgmma at every D % 64 == 0: bf16 and fp16 on
# csrc/flash_fwd.cu, f32 on tf32 wgmma (csrc/flash_tf32_fwd.cu). So does the
# backward of bf16 and fp16 (csrc/flash_bwd.cu, past D 256 on plan_bwd's
# column parts) and of f32 up to D 128 (csrc/flash_tf32_bwd.cu), where its
# resident f32 tiles (Q, dO hi and lo, or K, V hi and lo, 64 rows each) still
# fit in shared memory; csrc/flash_sync_bwd.cu takes f32 from D 192.
TF32_BWD_DIMS = (64, 128)


def routes(dtype: torch.dtype, D: int) -> tuple[str, str]:
    """The kernel families of a call's forward and backward on the card:
    "wgmma" (bf16, fp16: csrc/flash_fwd.cu, csrc/flash_bwd.cu), "tf32"
    (f32: csrc/flash_tf32_fwd.cu, flash_tf32_bwd.cu) or, for f32's backward
    from D 192, "sync" (csrc/flash_sync_bwd.cu). The backward reads the
    forward's l and m, whichever family wrote them. Raises for a type none
    takes or a D the tiling gate refuses."""
    if dtype not in _build.DTYPE_CODES or D <= 0 or D % 64:
        raise NotImplementedError(f"flash attention on the card takes bf16, fp16 or f32 with "
                                  f"D % 64 == 0; got {dtype}, D {D}")
    if dtype == torch.float32:
        return "tf32", "tf32" if D in TF32_BWD_DIMS else "sync"
    return "wgmma", "wgmma"


# csrc/flash_part.cuh's constants: the forward past D 256.
_WIDE_BQ, _WIDE_LIMIT, _WIDE_STAGES = 64, 232448, 3
_WIDE_DC_SMALL, _WIDE_DC_LARGE = 320, 512


def plan_wide(D: int, elem_bytes: int) -> dict:
    """The block plan of the forward past D 256, as ``csrc/flash_part.cuh:
    plan`` computes it for elements of ``elem_bytes`` (2: bf16, fp16; 4:
    f32; bf16 and fp16 at D 320 itself run K10's wide kernel, their plan's
    320-column parts serve D 576 and 640): ``parts`` (first column, columns) of each column part of O, the
    columns of each part that warpgroups 0 and 1 own (``cols``: [(start,
    count), (start, count)] per part; 16-bit in whole 64-column panels,
    warpgroup 0 the larger half), keys a tile ``bk``, ``q_res`` (Q resident
    or streamed in ``chunk``-column chunks), the rings' stages ``nk``/``nv``,
    the dynamic shared memory ``smem`` and ``o_regs``, O's f32 registers a
    thread at the widest part the kernel is built for (``dcmax``)."""
    if D <= 256 or D % 64 or elem_bytes not in (2, 4):
        raise ValueError(f"plan_wide: D % 64 == 0 past 256 and 2- or 4-byte elements; got D "
                         f"{D}, {elem_bytes}")
    fewer = -(-D // _WIDE_DC_LARGE) < -(-D // _WIDE_DC_SMALL)
    dcmax = _WIDE_DC_LARGE if fewer else _WIDE_DC_SMALL  # dcmax_of
    dc = D if D <= _WIDE_DC_LARGE else dcmax  # dc_of
    bk = 16 if elem_bytes == 4 else 64 if dcmax == _WIDE_DC_SMALL else 32
    v_slot = bk * (dcmax if elem_bytes == 4 else 128 * -(-dcmax // 128)) * elem_bytes

    def nbytes(q, k, nk, nv):
        return q + nk * k + nv * v_slot + 1024 + (2 * nk + 2 * nv + 1) * 8

    q, k = _WIDE_BQ * D * elem_bytes, bk * D * elem_bytes
    fits = [(nk, nv) for nk in range(_WIDE_STAGES, 0, -1) for nv in (nk, nk - 1)
            if nv >= 1 and nbytes(q, k, nk, nv) <= _WIDE_LIMIT]
    if fits:
        (nk, nv), q_res, chunk, k_slot = fits[0], True, D, k
    else:
        nk, nv, q_res, chunk, q = 4, 2, False, 128 // elem_bytes, 0
        k_slot = (_WIDE_BQ + bk) * 128
    parts, cols = [], []
    for c0 in range(0, D, dc):
        nc = min(dc, D - c0)
        parts.append((c0, nc))
        half = 64 * ((nc // 64 + 1) // 2) if elem_bytes == 2 else nc // 2
        cols.append([(c0, half), (c0 + half, nc - half)])
    o_regs = (64 * ((dcmax // 64 + 1) // 2) if elem_bytes == 2 else dcmax // 2) * 64 // 128
    return {"dc": dc, "dcmax": dcmax, "parts": parts, "cols": cols, "bk": bk, "q_res": q_res,
            "chunk": chunk, "nk": nk, "nv": nv, "smem": nbytes(q, k_slot, nk, nv),
            "o_regs": o_regs}


# csrc/flash_part.cuh's constants: the 16-bit backward past D 256.
_BWD_SLOT, _BWD_STATS, _BWD_XCHG = 2 * 64 * 128, 2 * 64 * 4, 32 * 128 * 4 + 16 * 128 * 4
_BWD_KV_DC, _BWD_MIN_RING, _BWD_MAX_RING = 256, 4, 8


def plan_bwd(D: int) -> dict:
    """The block plan of the bf16 and fp16 backward past D 256, as
    ``csrc/flash_part.cuh: plan_bwd`` computes it: the column parts of dQ
    (``dq_parts``: (first column, columns) each, the forward's parts) and
    the columns each warpgroup owns (``dq_cols``, warpgroup 0 the larger
    half in whole 64-column panels), the panels each warpgroup's dQ
    products span (``dq_op``) and their f32 registers a thread
    (``dq_regs``); the same for dK/dV (``kv_parts`` of 256 columns,
    ``kv_cols``: 128 each, warpgroup 0 first; ``kv_regs``: dK's and dV's
    registers a thread); ``res`` (the block's own operands resident in
    shared memory, ``res_bytes``), the ring's jobs ``ring`` and the dynamic
    shared memory ``smem`` of both kernels."""
    if D <= 256 or D % 64:
        raise ValueError(f"plan_bwd: D % 64 == 0 past 256; got D {D}")
    fewer = -(-D // _WIDE_DC_LARGE) < -(-D // _WIDE_DC_SMALL)
    dcmax = _WIDE_DC_LARGE if fewer else _WIDE_DC_SMALL  # dcmax_of
    dq_dc = D if D <= _WIDE_DC_LARGE else dcmax  # dc_of
    op = (dcmax // 64 + 1) // 2  # bwd_op
    dq_parts, dq_cols, kv_parts, kv_cols = [], [], [], []
    for c0 in range(0, D, dq_dc):
        nc = min(dq_dc, D - c0)
        half = 64 * ((nc // 64 + 1) // 2)
        dq_parts.append((c0, nc))
        dq_cols.append([(c0, half), (c0 + half, nc - half)])
    for c0 in range(0, D, _BWD_KV_DC):
        nc = min(_BWD_KV_DC, D - c0)
        kv_parts.append((c0, nc))
        half = min(nc, 128)
        kv_cols.append([(c0, half), (c0 + half, nc - half)])
    stage = _BWD_SLOT + _BWD_STATS + 16
    fixed = _BWD_XCHG + 8 + 1024
    res_bytes = 2 * 64 * D * 2
    ring = (_WIDE_LIMIT - fixed - res_bytes) // stage
    res = ring >= _BWD_MIN_RING
    if not res:
        res_bytes, ring = 0, (_WIDE_LIMIT - fixed) // stage
    ring = min(ring, _BWD_MAX_RING)
    return {"dq_parts": dq_parts, "dq_cols": dq_cols, "dq_op": op, "dq_regs": 32 * op,
            "kv_parts": kv_parts, "kv_cols": kv_cols, "kv_regs": 2 * 128 * 64 // 128,
            "res": res, "res_bytes": res_bytes, "ring": ring,
            "smem": res_bytes + ring * stage + fixed}


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                          kv_offset: int = 0, save_stats: bool = False):
    """Plain version of :func:`flash_attention` (q [B, Tq, NH, D], k/v [B,
    Tkv, NKV, D]): f32 scores, the -0.7 * f32max mask, p = exp(s - max),
    l = sum of the f32 p, out = (bf16(p) @ v) / l. With ``save_stats`` it
    returns (out, l, m), l and m f32 [B, NH, Tq], as
    :func:`flash_attention_forward` does."""
    flash_attention_plain.calls += 1
    B, Tq, NH, D = q.shape
    _, Tkv, NKV, _ = k.shape
    G = NH // NKV
    sm_scale = 1.0 / math.sqrt(D) if scale is None else scale
    qg = q.float().reshape(B, Tq, NKV, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale
    if causal:
        cm = causal_mask(Tq, Tkv, kv_offset, device=q.device)
        s = torch.where(cm[None, None, None], s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc * torch.where(l == 0, 1.0, 1.0 / l)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, NH, D).to(q.dtype)
    if not save_stats:
        return out
    return out, l.reshape(B, NH, Tq), m.reshape(B, NH, Tq)


flash_attention_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_fwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [vp] * 6 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        lib.flash_fwd.restype = ci
        lib._typed = True
    return lib


def _tf32_lib() -> ctypes.CDLL:
    lib = _build.library("flash_tf32_fwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_tf32_fwd.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, ci, ci, vp]
        lib.flash_tf32_fwd.restype = ci
        lib.flash_tf32_fwd_scratch.argtypes = [ci] * 4
        lib.flash_tf32_fwd_scratch.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _launch(q, k, v, causal: bool, sm_scale: float, kv_offset: int, stats: bool = False):
    """One call of the forward family ``routes`` names; (out, l, m) with
    ``stats``, else out."""
    B, Tq, NH, D = q.shape
    _, Tkv, NKV, _ = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"flash attention takes q, k, v of one type; got {q.dtype}, "
                                  f"{k.dtype}, {v.dtype}")
    fam = routes(q.dtype, D)[0]
    if Tkv % _KV_TILE or v.shape != k.shape or k.shape[0] != B:
        raise ValueError(f"flash attention needs Tkv % {_KV_TILE} == 0 (q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)})")
    if causal and kv_offset < 0:
        raise ValueError("flash_fwd: a negative kv_offset leaves rows with no key")
    # TMA reads from 16-byte-aligned bases only: an offset view is copied.
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    qc, kc, vc = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (qc, kc, vc))
    if not (kc.device == qc.device and vc.device == qc.device):
        raise ValueError("flash_fwd: q, k and v must be on one device")
    out = torch.empty_like(qc)
    l = m = None
    if stats:
        l = torch.empty(B, NH, Tq, device=q.device, dtype=torch.float32)
        m = torch.empty_like(l)
    lm = (None if l is None else _build.ptr(l), None if m is None else _build.ptr(m))
    if fam == "tf32":
        lib = _tf32_lib()
        # K rounded to tf32 and V rounded and transposed, by the prep launch.
        scratch = torch.empty(lib.flash_tf32_fwd_scratch(B, Tkv, NKV, D), device=q.device,
                              dtype=torch.float32)
        rc = lib.flash_tf32_fwd(_build.ptr(qc), _build.ptr(kc), _build.ptr(vc), _build.ptr(out),
                                *lm, _build.ptr(scratch), B, Tq, Tkv, NH, NKV, D, sm_scale,
                                kv_offset, int(causal), _build.stream_of(q))
    else:
        lib = _lib()
        rc = lib.flash_fwd(_build.ptr(qc), _build.ptr(kc), _build.ptr(vc), _build.ptr(out), *lm,
                           B, Tq, Tkv, NH, NKV, D, _build.DTYPE_CODES[q.dtype], sm_scale,
                           kv_offset, int(causal), _build.stream_of(q))
    _build.check(lib, rc, "flash_tf32_fwd" if fam == "tf32" else "flash_fwd")
    if stats:
        flash_attention_forward.launches += 1
        return out, l, m
    flash_attention.launches += 1
    return out


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, sm_scale: float, kv_offset: int = 0):
    """The forward under autograd (JAX's ``_flash_attention_forward(...,
    save_stats=True)``, in the model's layout): (out [B, Tq, NH, D], l, m
    f32 [B, NH, Tq]). CUDA tensors launch ``flash_fwd`` with its statistics
    outputs; CPU tensors take :func:`flash_attention_plain`."""
    if q.is_cuda:
        return _launch(q, k, v, causal, sm_scale, kv_offset, stats=True)
    return flash_attention_plain(q, k, v, causal=causal, scale=sm_scale, kv_offset=kv_offset,
                                 save_stats=True)


flash_attention_forward.launches = 0


class _FlashFn(torch.autograd.Function):
    """JAX's ``_flash_attention`` custom VJP: the forward saves q, k, v, out,
    l and m; the backward is ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, l, m = flash_attention_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                                            kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.cfg = (causal, sm_scale, kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        from mila_tpu_torch.kernels.flash_attention_bwd import flash_attention_bwd

        q, k, v, out, l, m = ctx.saved_tensors
        causal, sm_scale, kv_offset = ctx.cfg
        def hm(t):  # the JAX entry's head-major layout, as a view
            return t.transpose(1, 2)

        dq, dk, dv = flash_attention_bwd(hm(q), hm(k), hm(v), hm(out), l, m, hm(do),
                                         causal=causal, sm_scale=sm_scale, kv_offset=kv_offset)
        return hm(dq), hm(dk), hm(dv), None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None, kv_offset: int = 0) -> torch.Tensor:
    """Drop-in for :func:`mila_tpu_torch.ops.dot_product_attention`: q [B,
    Tq, NH, D]; k, v [B, Tkv, NKV, D] -> [B, Tq, NH, D].

    CUDA tensors launch ``flash_fwd`` and raise at a shape the tiling gate
    (``ops.flash_tiles_ok``) refuses: ``ops.attention`` routes those to the
    plain product before this call. CPU tensors take
    :func:`flash_attention_plain`, or at a refused shape the plain product,
    as JAX's wrapper does. Under grad the call goes through ``_FlashFn``
    (the launch with statistics, then the backward kernel)."""
    B, Tq, NH, D = q.shape
    _, Tkv, NKV, _ = k.shape
    if NH % NKV != 0:
        raise ValueError(f"num_heads {NH} not divisible by num_kv_heads {NKV}")
    sm_scale = 1.0 / math.sqrt(D) if scale is None else scale
    tiles_ok = flash_tiles_ok(Tq, Tkv, D)
    if q.is_cuda:
        if not tiles_ok:
            raise ValueError(f"flash_fwd: the tiling gate refuses Tq {Tq}, Tkv {Tkv}, D {D} "
                             "(Tq % 16, Tkv % 128 and D % 64 must be 0)")
    elif not tiles_ok:
        return dot_product_attention(q, k, v, causal=causal, scale=sm_scale,
                                     kv_offset=kv_offset)
    if _needs_grad(q, k, v):
        return _FlashFn.apply(q, k, v, causal, sm_scale, kv_offset)
    if q.is_cuda:
        return _launch(q, k, v, causal, sm_scale, kv_offset)
    return flash_attention_plain(q, k, v, causal=causal, scale=sm_scale, kv_offset=kv_offset)


flash_attention.launches = 0


def flash_mha_qkv(qkv: torch.Tensor, num_heads: int, *, causal: bool = True) -> torch.Tensor:
    """Fused-QKV convenience wrapper: qkv [B, T, 3C] -> [B, T, C]."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    q, k, v = qkv.split(C, dim=-1)
    out = flash_attention(q.reshape(B, T, num_heads, HS), k.reshape(B, T, num_heads, HS),
                          v.reshape(B, T, num_heads, HS), causal=causal)
    return out.reshape(B, T, C)
