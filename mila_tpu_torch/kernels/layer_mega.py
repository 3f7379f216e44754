"""One decoder layer as one kernel: GQA attention over the dense KV cache
with RoPE and the cache write, then wo(+res) -> RMSNorm -> SwiGLU ->
down(+res) -> the next layer's RMSNorm + wqkv (port of
``mila_tpu/kernels/layer_mega.py``).

Replaces the TPU kernel ``_mega_kernel`` (entry ``layer_megakernel``). The
TPU kernel turns the [NH, HD] attention output into the wo operand and the
qkv row into lane-packed queries on the MXU; its fold puts query slot n's
vector at lanes (n mod NKV) * HD, so it uses the SLOT head order: slot n
holds head (n mod NKV) * G + n // NKV and attends KV head n mod NKV. wq's
columns and wo's rows are permuted into slot order at pack time
(``permute_q_columns``, ``permute_wo_rows``; the k/v projections and the
caches keep their order). The giga pack (``kernels/decode_giga.py``) is
built in the same order.

What bounds it on the H100: the one-byte tiles of the layer (int8, or fp8
e4m3fn / e5m2 from ``pack_decode_megalayers`` over fp8 params; 60.8 MB at
Llama-3.2-1B) plus the K/V rows read. The CUDA kernel
(``csrc/decode_step_int8.cu``, one-layer launch) is the whole-step kernel
of the giga decode with one layer: an attention phase of (row, KV head)
units, then the layer tail of ``csrc/tail_phases.cuh``, all in one
cooperative launch. Its arithmetic is the TPU kernel's (x1 and x_out f32
into the next RMSNorm; x_out and the next qkv stored in x's dtype); the
plain version is the JAX package's CPU reference ``_mega_ref``, which
rounds x1 to x's dtype and each product to the activation dtype.

Both write the new K/V row at ``old_lens[b]`` of the caches they are given,
in place (the aliased Pallas call does the same), and return them. At
``old_lens[b] == T`` nothing is written; the kernel attends the current
token all the same, the plain version (like JAX's) does not.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mila_tpu_torch.inference.quantize import QTensor
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels.dense_attention import _rope_flat
from mila_tpu_torch.kernels.layer_fused import (
    _BLOCKS_PER_SM,
    _MAX_GRID,
    LayerPack,
    aligned,
    layer_tail_plain,
    pack_layer,
    plan_tail,
    qkv_tail_plain,
    scratch,
)
from mila_tpu_torch.kernels.quant_matmul import WFMT
from mila_tpu_torch.ops.attention import decode_attention


def slot_order(nh: int, nkv: int) -> np.ndarray:
    """slot n -> original head (n % NKV) * G + n // NKV (kv(slot) = n % NKV)."""
    g = nh // nkv
    return np.array([(n % nkv) * g + n // nkv for n in range(nh)], np.int64)


def _slot_rows(nh: int, nkv: int, hd: int) -> np.ndarray:
    return np.concatenate([np.arange(h * hd, (h + 1) * hd) for h in slot_order(nh, nkv)])


def permute_q_columns(wqkv: QTensor, nh: int, nkv: int, hd: int) -> QTensor:
    """The first NH * HD output columns of a fused wqkv in slot order (k/v
    columns untouched)."""
    full = np.concatenate([_slot_rows(nh, nkv, hd), np.arange(nh * hd, wqkv.q.shape[1])])
    idx = torch.from_numpy(full).to(wqkv.q.device)
    return QTensor(wqkv.q[:, idx], wqkv.scale[:, idx.to(wqkv.scale.device)], wqkv.block_size,
                   wqkv.packed_rows)


def permute_wo_rows(wo: QTensor, nh: int, nkv: int, hd: int) -> Optional[QTensor]:
    """wo's input rows in slot order; None unless one scale block covers the
    whole axis (a row permutation would mix scale blocks)."""
    if wo.block_size != wo.q.shape[0]:
        return None
    idx = torch.from_numpy(_slot_rows(nh, nkv, hd)).to(wo.q.device)
    return QTensor(wo.q[idx, :], wo.scale, wo.block_size, wo.packed_rows)


class MegaPack(NamedTuple):
    """One decode layer's tile stream (``pack_layer``'s layout) built from
    the slot-permuted wo and the NEXT layer's slot-permuted wqkv."""

    w: torch.Tensor  # [T, bk, bn]
    s: torch.Tensor  # [T, 1, bn] f32
    h_dim: int
    i_dim: int
    bn: int
    n_wo: int
    n_gu: int
    n_down: int
    n_qkv: int


def pack_mega_layer(wo: QTensor, wgu: QTensor, down: QTensor, wqkv_next: Optional[QTensor], *,
                    nh: int, nkv: int, hd: int, bn: int = 512) -> Optional[MegaPack]:
    wo_p = permute_wo_rows(wo, nh, nkv, hd)
    if wo_p is None:
        return None
    wqkv_p = permute_q_columns(wqkv_next, nh, nkv, hd) if wqkv_next is not None else None
    lp = pack_layer(wo_p, wgu, down, wqkv_p, bn=bn)
    if lp is None:
        return None
    return MegaPack(*lp)


# ---------------------------------------------------------------------------
# Plain version (the JAX package's CPU reference)
# ---------------------------------------------------------------------------

def slot_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens, *, num_heads: int,
                         scale: float) -> torch.Tensor:
    """The attention half of ``_mega_ref`` and of each ``_giga_ref`` layer:
    RoPE of q (slot order) and k from the raw qkv row [B, NQ + 2KD] in its
    dtype, the new K/V row written in place at ``old_lens[b]`` (dropped at
    T, as JAX's scatter), attention over old rows + the current one.
    Returns the output in slot order, [B, NQ] in qkv's dtype."""
    B, T, NKV, HD = k_cache.shape
    NH, KD = num_heads, NKV * HD
    NQ = NH * HD
    q = _rope_flat(qkv[:, :NQ], cos_t[:, :HD].repeat(1, NH), sin_t[:, :HD].repeat(1, NH), HD)
    k_new = _rope_flat(qkv[:, NQ:NQ + KD], cos_t, sin_t, HD)
    v_new = qkv[:, NQ + KD:]
    lens = old_lens.to(device=k_cache.device, dtype=torch.long)
    live = lens < T
    rows = torch.arange(B, device=k_cache.device)[live]
    kc, vc = k_cache.view(B, T, KD), v_cache.view(B, T, KD)
    kc[rows, lens[live]] = k_new[live].to(kc.dtype)
    vc[rows, lens[live]] = v_new[live].to(vc.dtype)
    slots = torch.from_numpy(slot_order(NH, NKV)).to(q.device)
    q_h = q.reshape(B, NH, HD)[:, torch.argsort(slots)]  # head order: head h attends kv h // G
    att = decode_attention(q_h[:, None], k_cache, v_cache, lens + 1, scale=scale)[:, 0]
    return att[:, slots].reshape(B, NQ)


def layer_megakernel_plain(qkv, x2, gamma_mlp, pack: MegaPack, k_cache, v_cache, old_lens,
                           cos_t, sin_t, gamma_next, *, num_heads: int, eps: float,
                           scale: float):
    """Port of ``_mega_ref``: slot-ordered attention + the permuted-pack
    tail. Returns (x_out [B, H], qkv_next or None, k_cache, v_cache)."""
    layer_megakernel_plain.calls += 1
    att_flat = slot_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens,
                                    num_heads=num_heads, scale=scale)
    lp = LayerPack(*pack)
    x_out = layer_tail_plain(att_flat.to(torch.bfloat16), x2, gamma_mlp, lp, eps=eps)
    qkv_next = qkv_tail_plain(x_out, gamma_next, lp, eps=eps) if pack.n_qkv else None
    return x_out, qkv_next, k_cache, v_cache


layer_megakernel_plain.calls = 0

# ---------------------------------------------------------------------------
# CUDA launch (shared with kernels/decode_giga.py)
# ---------------------------------------------------------------------------

# Argument order of csrc/decode_step_int8.cu:decode_step_int8 (StepParams).
_PTRS = ("lens", "tok_in", "x_in", "cos_in", "sin_in", "qkv_in", "ga", "gm", "gf", "w", "s",
         "kp", "vp", "x_out", "qkv_out", "tok_out", "logits", "cos_t", "sin_t", "att", "p_wo",
         "x1", "ssq1", "p_gu", "hbuf", "p_down", "xo", "ssq2", "p_q", "p_head", "best_v",
         "best_i")
_INTS = ("giga", "tokens_mode", "x_is_f32", "M", "H", "I", "bn", "NH", "NKV", "HD", "Tlen", "L",
         "n_qkv", "n_head", "vocab", "ks_wo", "ks_gu", "ks_down", "ks_q", "ks_head", "cols_wo",
         "cols_gu", "cols_down", "cols_q", "cols_head", "wfmt")
_PHASES = {"wo": "wo", "gu": "gu", "down": "down", "qkv": "q", "head": "head"}
# The tile formats of csrc/decode_step_int8.cu (its wfmt): the one-byte ones
# of quant_matmul.WFMT and bf16 (the giga launch's unquantized stream).
STREAM_WFMT = {**WFMT, torch.bfloat16: 3}
_HDS = (8, 16, 32, 64, 128)


def type_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/decode_step_int8.cu`` on ``lib``
    (also a variant build of it, ``tools/tail_phases.py``)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_step_int8.argtypes = [vp, ci, vp, ci, vp, ci, ci, ci, ci, vp]
    lib.decode_step_int8.restype = ci
    lib.decode_step_int8_blocks_per_sm.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.decode_step_int8_blocks_per_sm.restype = ci
    lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_step_int8")
    return lib if getattr(lib, "_typed", False) else type_lib(lib)


@functools.lru_cache(maxsize=None)
def _grid(index: int, m_tile: int, is_f32: int, wfmt: int = 0) -> int:
    """Blocks of the cooperative launch: all must be resident at once. Each
    tile format is its own instantiation, with its own registers, so the
    format is part of the occupancy query and of the cache key."""
    lib = _lib()
    nb = ctypes.c_int(0)
    _build.check(lib, lib.decode_step_int8_blocks_per_sm(m_tile, is_f32, wfmt, ctypes.byref(nb)),
                 "decode_step_int8 occupancy")
    if nb.value < 1:
        raise RuntimeError("decode_step_int8: no block fits on an SM")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(min(nb.value, _BLOCKS_PER_SM) * sms, _MAX_GRID)


def check_step(*, w, s, k_pool, v_pool, M, H, I, bn, NH, NKV, HD, T, formats, refusal) -> None:
    """What the decode_step_int8 kernel takes from one caller, whose tile
    formats are ``formats`` (``refusal`` says so); raises on anything else."""
    if w.dtype not in formats:
        raise NotImplementedError(f"{refusal}; got {w.dtype}")
    if not 0 < M <= 32:
        raise ValueError(f"decode_step_int8 is a decode kernel: 1 <= B <= 32, got {M}")
    if bn % 128 or H % bn or I % H or w.shape[1:] != (H, bn) or s.shape[1:] != (1, bn):
        raise ValueError(f"decode_step_int8: bad pack (H={H}, I={I}, bn={bn}, "
                         f"w {tuple(w.shape)}, s {tuple(s.shape)})")
    if NH * HD != H:
        raise ValueError(f"decode_step_int8: wo must be [H, H] (NH*HD={NH * HD}, H={H})")
    if NH % NKV or NH // NKV > 8 or HD not in _HDS:
        raise ValueError(f"decode_step_int8 needs NH/NKV <= 8 and HD in {_HDS} "
                         f"(NH={NH}, NKV={NKV}, HD={HD})")
    if T % 8:
        raise ValueError(f"decode_step_int8 needs T % 8 == 0 (got T={T}): the cache "
                         "length rule of the TPU kernel (init_kv_cache rounds up)")
    for t in (k_pool, v_pool):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise TypeError("decode_step_int8: K/V caches must be contiguous, 16-byte "
                            f"aligned bf16 (got {t.dtype})")
    for t in (w, s, k_pool, v_pool):
        if not t.is_cuda or t.device != w.device:
            raise ValueError("decode_step_int8: every operand must be on one CUDA device")
    if s.dtype != torch.float32 or not (w.is_contiguous() and s.is_contiguous()) \
            or w.data_ptr() % 16 or s.data_ptr() % 16:
        raise TypeError("decode_step_int8: the pack must be contiguous, 16-byte aligned, "
                        "with f32 scales")


def step_launch_plan(M: int, H: int, I: int, bn: int, n_qkv: int, n_head: int, index: int,
                     is_f32: int, wfmt: int = 0) -> Tuple[int, int, dict]:
    """(grid, m_tile, plan) of a :func:`launch_step` call on device
    ``index`` over tiles in format ``wfmt`` (``WFMT``): its tiles a phase (a
    qkv or head phase of one tile where the launch has none, planned and
    not run) and its grid."""
    grid = _grid(index, 8 if M <= 8 else 32, is_f32, wfmt)
    mt, plan = plan_tail(M, H, bn, {"wo": H // bn, "gu": 2 * I // bn,
                                    "down": (I // H) * (H // bn), "qkv": max(n_qkv, 1),
                                    "head": max(n_head, 1)}, grid)
    return grid, mt, plan


def launch_step(ptrs: dict, ints: dict, *, eps: float, scale: float, is_f32: int,
                device: torch.device) -> None:
    """One cooperative ``decode_step_int8`` launch. ``ptrs`` names the
    tensors of StepParams (missing: null), ``ints`` its ints (missing: 0);
    the K slices and the scratch are planned here, and the tiles' format
    is read from ``ptrs["w"]``."""
    ints = {k: 0 for k in _INTS} | ints | {"wfmt": STREAM_WFMT[ptrs["w"].dtype]}
    M, H, I, bn = ints["M"], ints["H"], ints["I"], ints["bn"]
    NQ, KD = ints["NH"] * ints["HD"], ints["NKV"] * ints["HD"]
    n_qkv, n_head = ints["n_qkv"], ints["n_head"]
    grid, mt, plan = step_launch_plan(M, H, I, bn, n_qkv, n_head, device.index or 0, is_f32,
                                      ints["wfmt"])
    for name, suffix in _PHASES.items():
        ints["cols_" + suffix], ints["ks_" + suffix] = plan[name]
    ks = {name: k for name, (_, k) in plan.items()}
    Nq, Nh = max(n_qkv * bn, 1), max(n_head * bn, 1)
    sizes = {"att": (M * NQ + 1) // 2, "p_wo": ks["wo"] * M * H, "x1": M * H, "ssq1": grid * M,
             "p_gu": ks["gu"] * M * 2 * I, "hbuf": M * I,
             "p_down": (I // H) * ks["down"] * M * H, "xo": M * H, "ssq2": grid * M,
             "p_q": ks["qkv"] * M * Nq, "p_head": ks["head"] * M * Nh if ints["giga"] else 1,
             "best_v": grid * M, "best_i": grid * M}
    allp = {**dict(zip(sizes, scratch(list(sizes.values()), device))),
            **{k: aligned(v) if k in ("ga", "gm", "gf") and v is not None else v
               for k, v in ptrs.items()}}
    arr_p = (ctypes.c_void_p * len(_PTRS))(
        *[allp[n].data_ptr() if allp.get(n) is not None else None for n in _PTRS])
    arr_i = (ctypes.c_int * len(_INTS))(*[int(ints[n]) for n in _INTS])
    arr_f = (ctypes.c_float * 2)(eps, scale)
    lib = _lib()
    rc = lib.decode_step_int8(arr_p, len(_PTRS), arr_i, len(_INTS), arr_f, 2, grid, mt, is_f32,
                              ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(lib, rc, "decode_step_int8")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def layer_megakernel(qkv: torch.Tensor, x: torch.Tensor, gamma_mlp: torch.Tensor,
                     pack: MegaPack, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     old_lens: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor,
                     gamma_next: Optional[torch.Tensor] = None, *, num_heads: int,
                     eps: float = 1e-5, scale: Optional[float] = None, depth: int = 3):
    """One decode layer in one kernel. qkv [B, NQ + 2*NKV*HD] raw fused
    projection (q in slot order, before RoPE); x [..., H]; caches [B, T,
    NKV, HD]; old_lens [B] live rows (the current token excluded);
    cos_t/sin_t [B, NKV*HD] tiled tables. ``depth`` (the TPU kernel's
    weight-ring depth) is accepted for the JAX signature and not used.

    Returns (x_out like x, qkv_next [B, n_qkv*bn] or None, k_cache,
    v_cache), the caches being the tensors given with row ``old_lens[b]``
    written. CUDA tensors launch ``decode_step_int8``; CPU tensors take
    :func:`layer_megakernel_plain`."""
    del depth
    B, T, NKV, HD = k_cache.shape
    NH = num_heads
    H, bn = pack.h_dim, pack.bn
    lead = x.shape[:-1]
    x2 = x.reshape(-1, H)
    Nq = pack.n_qkv * bn
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    gm_nxt = gamma_next if gamma_next is not None else torch.ones(H, dtype=torch.float32,
                                                                   device=x.device)
    if not x.is_cuda:
        x_out, qkv_next, k_cache, v_cache = layer_megakernel_plain(
            qkv, x2, gamma_mlp, pack, k_cache, v_cache, old_lens, cos_t, sin_t, gm_nxt,
            num_heads=NH, eps=eps, scale=sm_scale)
        return x_out.reshape(*lead, H), qkv_next, k_cache, v_cache
    KD = NKV * HD
    check_step(w=pack.w, s=pack.s, k_pool=k_cache, v_pool=v_cache, M=B, H=H, I=pack.i_dim,
               bn=bn, NH=NH, NKV=NKV, HD=HD, T=T, formats=WFMT,
               refusal="layer_megakernel takes int8 or fp8 packs (the JAX package packs "
                       "quantized params only)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_megakernel takes bf16/f32 activations, got {x.dtype}")
    if x2.shape[0] != B or qkv.shape != (B, NH * HD + 2 * KD) or cos_t.shape != (B, KD) \
            or sin_t.shape != (B, KD):
        raise ValueError(f"layer_megakernel: bad shapes qkv {tuple(qkv.shape)} x "
                         f"{tuple(x.shape)} cos {tuple(cos_t.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    dev = x.device
    x_out = torch.empty((B, H), dtype=x.dtype, device=dev)
    qkv_next = torch.empty((B, Nq), dtype=x.dtype, device=dev) if pack.n_qkv else None
    f32 = functools.partial(torch.Tensor.to, device=dev, dtype=torch.float32)
    launch_step(
        {"lens": old_lens.to(device=dev, dtype=torch.int32).contiguous(),
         "x_in": x2.contiguous(), "cos_in": f32(cos_t).contiguous(),
         "sin_in": f32(sin_t).contiguous(), "qkv_in": qkv.to(x.dtype).contiguous(),
         "ga": f32(gm_nxt).contiguous(), "gm": f32(gamma_mlp).contiguous(), "w": pack.w,
         "s": pack.s, "kp": k_cache, "vp": v_cache, "x_out": x_out, "qkv_out": qkv_next},
        {"M": B, "H": H, "I": pack.i_dim, "bn": bn, "NH": NH, "NKV": NKV, "HD": HD, "Tlen": T,
         "L": 1, "n_qkv": pack.n_qkv},
        eps=eps, scale=sm_scale, is_f32=int(x.dtype == torch.float32), device=dev)
    layer_megakernel.launches += 1
    return x_out.reshape(*lead, H), qkv_next, k_cache, v_cache


layer_megakernel.launches = 0
