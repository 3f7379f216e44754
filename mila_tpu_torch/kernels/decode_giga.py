"""The whole decode step as one kernel: every decoder layer (attention with
the cache write, the layer tail) and the head's argmax over one weight
stream (port of ``mila_tpu/kernels/decode_giga.py``).

Replaces the TPU kernel ``_giga_kernel`` (entry ``giga_decode_step``), the
JAX package's headline decode path (``bench.py``'s ``pack_decode_giga`` +
``giga_step``, and the engine's contiguous layout when the params carry a
``giga_pack``).

Stream layout (``pack_giga``), uniform [bk = H, bn] int8 tiles with one f32
scale row each, byte for byte the JAX pack:

  [ wqkv_0 | layer 0: wo gu down wqkv_1 | ... | layer L-2: ... wqkv_{L-1}
  | layer L-1: wo gu down | lm_head (+ zero tiles to a multiple of 8) ]

wq's columns and wo's rows are in the slot head order of
``kernels/layer_mega.py``. The K/V pools are stacked [L, B, T, NKV*HD]
(4-D, as JAX keeps them) and written in place at row ``old_lens[b]`` of
every layer. In the ``tokens`` mode ``x`` is the whole embedding table:
the kernel gathers the rows and builds the RoPE tables from
``old_lens x pack.freq`` and ``pack.sign`` itself.

What bounds it on the H100: the stream's bytes (1.24 GB at Llama-3.2-1B)
plus the K/V rows read. The CUDA kernel (``csrc/decode_step_int8.cu``) is
one persistent cooperative launch whose phases (prologue, then per layer
attention and the eight layer-tail phases, then the head) meet at grid
barriers.

Arithmetic. The kernel follows the TPU kernel: the residual stays f32
across every layer, x1 is f32, the normalised inputs and h are bf16, the
qkv row is f32. The plain version (``giga_decode_plain``) is the JAX
package's CPU reference ``_giga_ref``, which rounds the residual to bf16
at every layer, so the two differ by design and the difference grows with
depth; ``chip_smoke.py`` holds the kernel to the JAX package's own gate
for this kernel (greedy tokens agree on at least 7/8 of the rows, logits
within 5e-2 * max(1, L/4) + 5e-2 relative).

bf16 streams (``pack_decode_giga(..., bf16_stream=True)``: unit scales,
the padded tied wte^T as the head) run on the card too, through the
kernel's bf16 instantiation (ring stages of 32 two-byte rows); fp8 and
int4 never reach it (the pack requantizes them to int8, as JAX's does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mila_tpu_torch.inference.quantize import QTensor
from mila_tpu_torch.kernels.layer_fused import (
    LayerPack,
    _w_scale_fixup,
    layer_tail_plain,
    pack_layer,
    qkv_tail_plain,
)
from mila_tpu_torch.kernels.layer_mega import (
    check_step,
    launch_step,
    permute_q_columns,
    permute_wo_rows,
    slot_attention_plain,
)


class GigaPack(NamedTuple):
    """Whole-model decode weight stream (see module doc)."""

    w: torch.Tensor  # [NTOT, bk, bn] int8 (bf16 in a bf16 stream)
    s: torch.Tensor  # [NTOT, 1, bn] f32
    ga: torch.Tensor  # [L, H] f32 ln_attn gammas
    gm: torch.Tensor  # [L, H] f32 ln_mlp gammas
    gf: torch.Tensor  # [1, H] f32 final-norm gamma
    freq: Optional[torch.Tensor]  # [1, KD] f32 tiled RoPE frequencies (tokens mode)
    sign: Optional[torch.Tensor]  # [1, KD] f32 pre-signed sin pattern
    h_dim: int
    i_dim: int
    bn: int
    n_wo: int
    n_gu: int
    n_down: int
    n_qkv: int
    n_layers: int
    n_head: int
    vocab: int
    nh: int
    nkv: int
    hd: int
    eps: float


def _tile_qt(qt: QTensor, bn: int, fix: float):
    """Column-tile a [K, N] QTensor into [K, bn] tiles and their scale rows."""
    N = qt.q.shape[1]
    tiles = [qt.q[:, n * bn:(n + 1) * bn] for n in range(N // bn)]
    scales = [qt.scale[0, n * bn:(n + 1) * bn] * fix for n in range(N // bn)]
    return tiles, scales


def pack_giga(layer_weights, head: QTensor, ga, gm, gf, *, nh: int, nkv: int, hd: int,
              vocab: int, eps: float = 1e-5, bn: int = 512,
              rope_inv_freq=None) -> Optional[GigaPack]:
    """The whole-model stream from per-layer (wo, wgu, down, wqkv) QTensors
    in token order and the [H, VPAD] head (vocab padded to bn). None when
    the shapes do not fit, as JAX (KD != bn, a head whose scale block is not
    the whole H axis, a layer that does not pack)."""
    L = len(layer_weights)
    if L == 0:
        return None
    H = layer_weights[0][0].q.shape[1]
    kd = nkv * hd
    if kd != bn or head.q.shape[0] != H or head.q.shape[1] % bn:
        return None
    if head.packed_rows or head.block_size != H:
        return None
    perm = []
    for wo, wgu, down, wqkv in layer_weights:
        wo_p = permute_wo_rows(wo, nh, nkv, hd)
        if wo_p is None:
            return None
        perm.append((wo_p, wgu, down, permute_q_columns(wqkv, nh, nkv, hd)))
    packs = []
    for i, (wo_p, wgu, down, _) in enumerate(perm):
        nxt = perm[i + 1][3] if i + 1 < L else None
        lp = pack_layer(wo_p, wgu, down, nxt, bn=bn)
        if lp is None or lp.bn != bn:
            return None
        packs.append(lp)
    first = packs[0]
    qkv0_tiles, qkv0_scales = _tile_qt(perm[0][3], bn, _w_scale_fixup(layer_weights[0][3].q.dtype))
    head_tiles, head_scales = _tile_qt(head, bn, _w_scale_fixup(head.q.dtype))
    # Zero tiles pad the stream to a multiple of 8 tiles, as JAX does (its
    # kernel groups tiles per grid step); their logits are 0 and columns
    # >= vocab never win the argmax.
    tpl = first.n_wo + first.n_gu + first.n_down + first.n_qkv
    ntot = L * tpl + len(head_tiles)
    for _ in range((-ntot) % 8):
        head_tiles.append(torch.zeros_like(head_tiles[0]))
        head_scales.append(torch.zeros_like(head_scales[0]))
    w = torch.cat([torch.stack(qkv0_tiles)] + [p.w for p in packs] + [torch.stack(head_tiles)])
    s = torch.cat([torch.stack(qkv0_scales).float()[:, None, :]] + [p.s for p in packs]
                  + [torch.stack(head_scales).float()[:, None, :]])
    freq = sign = None
    if rope_inv_freq is not None:
        # Full-width tiled rows for the in-kernel tables: lane k carries
        # inv_freq[(k % hd) % (hd / 2)]; the sign row is [-1 | +1] per head.
        d2 = hd // 2
        inv = np.asarray(torch.as_tensor(rope_inv_freq).float().cpu(), np.float32).reshape(d2)
        kidx = np.arange(kd)
        freq = torch.from_numpy(inv[(kidx % hd) % d2][None, :].copy()).to(w.device)
        sign = torch.from_numpy(
            np.where((kidx % hd) < d2, -1.0, 1.0)[None, :].astype(np.float32)).to(w.device)

    def gammas(g, shape):
        return torch.as_tensor(g).to(device=w.device, dtype=torch.float32).reshape(shape)

    return GigaPack(w=w, s=s, ga=gammas(ga, (L, H)), gm=gammas(gm, (L, H)),
                    gf=gammas(gf, (1, H)), freq=freq, sign=sign, h_dim=H, i_dim=first.i_dim,
                    bn=bn, n_wo=first.n_wo, n_gu=first.n_gu, n_down=first.n_down,
                    n_qkv=first.n_qkv, n_layers=L, n_head=len(head_tiles), vocab=vocab, nh=nh,
                    nkv=nkv, hd=hd, eps=float(eps))


def _head_base(pack: GigaPack) -> int:
    tpl = pack.n_wo + pack.n_gu + pack.n_down + pack.n_qkv
    return pack.n_qkv + pack.n_layers * tpl - pack.n_qkv  # the last layer has no qkv tiles


# ---------------------------------------------------------------------------
# Plain version (the JAX package's CPU reference)
# ---------------------------------------------------------------------------

def giga_decode_plain(x, cos_t, sin_t, old_lens, pack: GigaPack, k_pool, v_pool, *,
                      sm_scale: float):
    """Port of ``_giga_ref``: per-layer megakernel semantics over views of
    the stacked stream, then the argmax head. x [B, H] embedded rows;
    cos_t/sin_t [B, KD] tiled tables. Writes the pools in place; returns
    (token [B, 1] int32, logits [B, n_head*bn] bf16, k_pool, v_pool)."""
    giga_decode_plain.calls += 1
    L, B, T, KD = k_pool.shape
    NH, NKV, HD = pack.nh, pack.nkv, pack.hd
    H, bn, eps = pack.h_dim, pack.bn, pack.eps
    tpl = pack.n_wo + pack.n_gu + pack.n_down + pack.n_qkv
    fix = _w_scale_fixup(pack.w.dtype)

    def rms(xf, gamma):
        xf = xf.float()
        rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        return (xf * rstd * gamma[None, :]).to(torch.bfloat16)

    def mm(xb, t0, t1):
        xf = xb.float()
        return torch.cat([(xf @ (pack.w[t].float() / fix)) * pack.s[t, 0][None, :]
                          for t in range(t0, t1)], dim=1)

    c32, s32 = cos_t.float(), sin_t.float()
    xres = x.float()
    qkv = mm(rms(xres, pack.ga[0]), 0, pack.n_qkv)
    for l in range(L):
        base = pack.n_qkv + l * tpl
        n_qkv_l = pack.n_qkv if l + 1 < L else 0
        att_slot = slot_attention_plain(qkv, c32, s32, k_pool[l].view(B, T, NKV, HD),
                                        v_pool[l].view(B, T, NKV, HD), old_lens,
                                        num_heads=NH, scale=sm_scale)
        n_tiles = tpl - (pack.n_qkv - n_qkv_l)
        lp = LayerPack(w=pack.w[base:base + n_tiles], s=pack.s[base:base + n_tiles], h_dim=H,
                       i_dim=pack.i_dim, bn=bn, n_wo=pack.n_wo, n_gu=pack.n_gu,
                       n_down=pack.n_down, n_qkv=n_qkv_l)
        xres = layer_tail_plain(att_slot.to(torch.bfloat16), xres.to(torch.bfloat16),
                                pack.gm[l], lp, eps=eps).float()
        if n_qkv_l:
            qkv = qkv_tail_plain(xres, pack.ga[l + 1], lp, eps=eps)
    hb = _head_base(pack)
    logits = mm(rms(xres, pack.gf[0]), hb, pack.w.shape[0])
    col = torch.arange(logits.shape[1], device=logits.device)[None, :]
    masked = torch.where(col < pack.vocab, logits, torch.full_like(logits, -torch.inf))
    tok = torch.argmax(masked, dim=1).to(torch.int32)[:, None]
    return tok, logits.to(torch.bfloat16), k_pool, v_pool


giga_decode_plain.calls = 0


def _embed_rope(wte, tokens, old_lens, pack: GigaPack):
    """The tokens mode's inputs as the plain version takes them: the bf16
    embedding rows and the RoPE tables from lens x freq and the sign row."""
    xe = wte[tokens.reshape(-1).long()].to(torch.bfloat16)
    ang = old_lens[:, None].float() * pack.freq
    return xe, torch.cos(ang), pack.sign * torch.sin(ang)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def giga_decode_step(x: torch.Tensor, cos_t: Optional[torch.Tensor],
                     sin_t: Optional[torch.Tensor], old_lens: torch.Tensor, pack: GigaPack,
                     k_pool: torch.Tensor, v_pool: torch.Tensor, *,
                     scale: Optional[float] = None, block_t: int = 128,
                     tokens: Optional[torch.Tensor] = None):
    """One full decode step. x [B, H] embedded rows with cos_t/sin_t [B, KD]
    tiled tables, or, with ``tokens`` [B] int32, the whole embedding table
    [V, H] (the tables are then built from old_lens and the pack, and
    cos_t/sin_t are ignored). old_lens [B] = live cache rows per sequence;
    pools [L, B, T, NKV*HD]. ``block_t`` (the TPU kernel's K/V block) is
    accepted for the JAX signature and not used.

    Returns (token [B, 1] int32 greedy argmax, logits [B, n_head*bn] bf16,
    k_pool, v_pool), the pools being the tensors given with row
    ``old_lens[b]`` of every layer written. CUDA tensors launch
    ``decode_step_int8``; CPU tensors take :func:`giga_decode_plain`."""
    del block_t
    L, B, T, KD = k_pool.shape
    NKV, HD, NH = pack.nkv, pack.hd, pack.nh
    H, bn = pack.h_dim, pack.bn
    if KD != NKV * HD:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not hold NKV*HD = {NKV * HD} columns")
    if pack.n_layers != L:
        raise ValueError(f"pack has {pack.n_layers} layers, pools {L}")
    if T % 8:
        raise ValueError(f"giga_decode_step needs T % 8 == 0 (got {T})")
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    embed = tokens is not None
    if embed:
        if pack.freq is None:
            raise ValueError("the tokens mode needs a pack built with rope_inv_freq")
        if x.shape[0] % 8:
            raise ValueError("the embedding table's rows must be a multiple of 8 (JAX's rule)")
    if not k_pool.is_cuda:
        if embed:
            x, cos_t, sin_t = _embed_rope(x, tokens, old_lens, pack)
        return giga_decode_plain(x, cos_t, sin_t, old_lens, pack, k_pool, v_pool,
                                 sm_scale=sm_scale)
    check_step(w=pack.w, s=pack.s, k_pool=k_pool, v_pool=v_pool, M=B, H=H, I=pack.i_dim,
               bn=bn, NH=NH, NKV=NKV, HD=HD, T=T, formats=(torch.int8, torch.bfloat16),
               refusal="giga_decode_step takes int8 or bf16 tile streams (pack_decode_giga "
                       "requantizes fp8 and int4 to int8)")
    NTOT = _head_base(pack) + pack.n_head
    if pack.w.shape[0] != NTOT or x.dtype not in (torch.bfloat16, torch.float32) \
            or x.shape[-1] != H or (not embed and x.shape[0] != B):
        raise ValueError(f"giga_decode_step: bad pack or x (w {tuple(pack.w.shape)}, "
                         f"{NTOT} tiles expected; x {tuple(x.shape)} {x.dtype})")
    dev = k_pool.device
    f32 = torch.float32
    if embed:
        tables = {"tok_in": tokens.reshape(-1).to(device=dev, dtype=torch.int32).contiguous(),
                  "cos_in": pack.freq.to(f32).contiguous(), "sin_in": pack.sign.to(f32).contiguous(),
                  "cos_t": torch.empty((B, KD), dtype=f32, device=dev),
                  "sin_t": torch.empty((B, KD), dtype=f32, device=dev)}
    else:
        if cos_t.shape != (B, KD) or sin_t.shape != (B, KD):
            raise ValueError(f"giga_decode_step: tables must be [B, KD], got "
                             f"{tuple(cos_t.shape)}")
        tables = {"cos_in": cos_t.to(f32).contiguous(), "sin_in": sin_t.to(f32).contiguous()}
    tok = torch.empty((B, 1), dtype=torch.int32, device=dev)
    logits = torch.empty((B, pack.n_head * bn), dtype=torch.bfloat16, device=dev)
    launch_step(
        {"lens": old_lens.to(device=dev, dtype=torch.int32).contiguous(),
         "x_in": x.contiguous(), **tables, "ga": pack.ga, "gm": pack.gm, "gf": pack.gf,
         "w": pack.w, "s": pack.s, "kp": k_pool, "vp": v_pool,
         "x_out": torch.empty((B, H), dtype=f32, device=dev),
         "qkv_out": torch.empty((B, pack.n_qkv * bn), dtype=f32, device=dev),
         "tok_out": tok, "logits": logits},
        {"giga": 1, "tokens_mode": int(embed), "x_is_f32": int(x.dtype == f32), "M": B, "H": H,
         "I": pack.i_dim, "bn": bn, "NH": NH, "NKV": NKV, "HD": HD, "Tlen": T, "L": L,
         "n_qkv": pack.n_qkv, "n_head": pack.n_head, "vocab": pack.vocab},
        eps=pack.eps, scale=sm_scale, is_f32=1, device=dev)
    giga_decode_step.launches += 1
    return tok, logits, k_pool, v_pool


giga_decode_step.launches = 0
