"""Layer-tail decode stream: wo(+res) -> RMSNorm -> SwiGLU -> down(+res) ->
the NEXT layer's RMSNorm + wqkv, over one layer's packed weights.

Replaces the TPU kernel ``mila_tpu/kernels/layer_fused.py:_tail_kernel``
(entry ``mlp_qkv_fused``). The weight layout is ``pack_layer``'s, byte for
byte: uniform [bk = H, bn] tiles stacked in stream order
``[wo | g0 u0 g1 u1 ... | down k-major | wqkv_next]`` with a matching
[T, 1, bn] f32 scale stack (the fp8 decode fixup folded in, as JAX does),
so a pack built by the JAX package and bridged, and one built here, are
interchangeable. ``kernels/layer_stream.py`` stacks the packs of all layers
and runs the same CUDA kernel.

What bounds it on the H100: the int8 weight bytes of the layer tail (60.8
MB for Llama-3.2-1B: wo, gate|up, down and the next wqkv; 2*M operations
per byte at M <= 32). Each phase needs the whole previous vector (RMSNorm
needs all of x1, down all of h, the next RMSNorm all of x_out), which the
TPU kernel gets by running its tiles in order on one core. The CUDA kernel
(``csrc/layer_tail_int8.cu``) is one persistent cooperative launch whose
blocks all stay resident and meet at grid-wide barriers between the
phases; inside a phase the blocks stride over (tile, 128-column group,
K slice) units, stream 4-byte weight words as the decode GEMV does, and
write f32 partial sums that the next phase reduces. No atomics: the sums
are deterministic.

Arithmetic. The kernel follows the TPU kernel (``_stream_kernel``): x1 =
(att @ wo) * s + x in f32, xn = bf16(x1 * rstd * gamma), g and u in f32,
h = bf16(silu(g) * u), x_out = (h @ down) * s + x1 in f32 (stored in x's
dtype), xq = bf16(x_out * rstd' * gamma_next), qkv = (xq @ wqkv) * s. The
plain versions are the JAX package's CPU references
(``_layer_tail_ref`` / ``_qkv_tail_ref``): they dequantize each tile to
bf16 before the product (``quant_linear_ref``), round x1 to x's dtype, and
round every product (each down chunk included) to the activation dtype.
The two differ by those roundings, a few bf16 steps; ``chip_smoke.py``
measures the difference on the card against 2e-2 x max |reference|.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from mila_tpu_torch.inference.quantize import QTensor, quant_linear_ref
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.swiglu import swiglu

# Folded into the scale rows for fp8 tiles (the TPU kernel bit-decodes fp8
# to a value scaled by 2^-(127 - bias); ``mila_tpu/kernels/quant_matmul.py``).
_FP8_SCALE_FIXUP = {torch.float8_e4m3fn: 2.0 ** 120, torch.float8_e5m2: 2.0 ** 112}


def _w_scale_fixup(dtype) -> float:
    return _FP8_SCALE_FIXUP.get(dtype, 1.0)


class LayerPack(NamedTuple):
    """Tiled-and-stacked layer-tail weights (see module doc)."""

    w: torch.Tensor  # [T, bk, bn] int8 / fp8 / bf16
    s: torch.Tensor  # [T, 1, bn] f32 (fp8 fixup folded)
    h_dim: int
    i_dim: int
    bn: int
    n_wo: int
    n_gu: int
    n_down: int
    n_qkv: int  # 0 on the last layer


def pack_layer(wo: QTensor, wgu: QTensor, down: QTensor, wqkv_next: Optional[QTensor], *,
               bn: int = 512) -> Optional[LayerPack]:
    """Stack wo/wgu/down (+ the next layer's wqkv) into the stream layout.

    Returns None when shapes do not fit, as JAX does: wo [H, H], wgu [H, 2I],
    down [I, H], wqkv_next [H, Nq] with bn | H, bn | I, H | I, bn | Nq, every
    block_size a multiple of H; int4-packed tensors are refused."""
    qts = [wo, wgu, down] + ([wqkv_next] if wqkv_next is not None else [])
    if any(q.packed_rows for q in qts):
        return None
    H, H2 = wo.q.shape
    Hg, I2 = wgu.q.shape
    I, Hd = down.q.shape
    if H != H2 or H != Hg or Hd != H or I2 != 2 * I:
        return None
    bn = min(bn, H)
    if H % bn or I % bn or I % H:
        return None
    dt = wo.q.dtype
    ok_dt = wo.q.element_size() == 1 or dt == torch.bfloat16
    if any(q.q.dtype != dt for q in qts) or not ok_dt:
        return None
    bk = H
    if any(q.block_size % bk for q in qts):
        return None
    n_qkv = 0
    if wqkv_next is not None:
        Hq, Nq = wqkv_next.q.shape
        if Hq != H or Nq % bn:
            return None
        n_qkv = Nq // bn
    fix = _w_scale_fixup(dt)

    def srow(qt: QTensor, k0: int, n0: int) -> torch.Tensor:
        return qt.scale[k0 // qt.block_size, n0:n0 + bn] * fix

    tiles, scales = [], []
    for n in range(H // bn):  # wo [H, H]
        tiles.append(wo.q[:, n * bn:(n + 1) * bn])
        scales.append(srow(wo, 0, n * bn))
    for j in range(I // bn):  # wgu: gate and up interleaved
        tiles.append(wgu.q[:, j * bn:(j + 1) * bn])
        scales.append(srow(wgu, 0, j * bn))
        tiles.append(wgu.q[:, I + j * bn:I + (j + 1) * bn])
        scales.append(srow(wgu, 0, I + j * bn))
    for k in range(I // bk):  # down [I, H], k-major
        for n in range(H // bn):
            tiles.append(down.q[k * bk:(k + 1) * bk, n * bn:(n + 1) * bn])
            scales.append(srow(down, k * bk, n * bn))
    for n in range(n_qkv):  # the next layer's wqkv [H, Nq]
        tiles.append(wqkv_next.q[:, n * bn:(n + 1) * bn])
        scales.append(srow(wqkv_next, 0, n * bn))
    w = torch.stack(tiles)
    s = torch.stack([x.float() for x in scales])[:, None, :]
    return LayerPack(w=w, s=s, h_dim=H, i_dim=I, bn=bn, n_wo=H // bn, n_gu=2 * I // bn,
                     n_down=(I // bk) * (H // bn), n_qkv=n_qkv)


# ---------------------------------------------------------------------------
# Plain versions (the JAX package's CPU references)
# ---------------------------------------------------------------------------

def _pack_qt(pack: LayerPack, i: int) -> QTensor:
    return QTensor(pack.w[i], pack.s[i] / _w_scale_fixup(pack.w.dtype), pack.h_dim, 0)


def layer_tail_plain(att, x, gamma_mlp, pack: LayerPack, *, eps: float) -> torch.Tensor:
    """wo -> rms -> SwiGLU -> down chain over the pack tiles (port of
    ``_layer_tail_ref``). att, x [M, H] -> x_out [M, H] in x's dtype."""
    layer_tail_plain.calls += 1
    H, bn = pack.h_dim, pack.bn
    t0 = 0
    wo_out = torch.cat([quant_linear_ref(att.to(torch.bfloat16), _pack_qt(pack, t0 + i))
                        for i in range(pack.n_wo)], dim=-1)
    t0 += pack.n_wo
    x1 = (wo_out.float() + x.float()).to(x.dtype)
    xn = rms_norm(x1, gamma_mlp, eps)
    h_chunks = []
    for _ in range(pack.n_gu // 2):
        g = quant_linear_ref(xn, _pack_qt(pack, t0))
        u = quant_linear_ref(xn, _pack_qt(pack, t0 + 1))
        t0 += 2
        h_chunks.append(swiglu(g, u))
    h = torch.cat(h_chunks, dim=-1)
    n_cols = H // bn
    acc = None
    for k in range(pack.n_down // n_cols):
        hk = h[:, k * H:(k + 1) * H]
        row = torch.cat([quant_linear_ref(hk, _pack_qt(pack, t0 + k * n_cols + n))
                         for n in range(n_cols)], dim=-1).float()
        acc = row if acc is None else acc + row
    return (acc + x1.float()).to(x.dtype)


def qkv_tail_plain(x_out, gamma_next, pack: LayerPack, *, eps: float) -> torch.Tensor:
    """The next layer's rms + wqkv over the pack's last tiles (port of
    ``_qkv_tail_ref``)."""
    qkv_tail_plain.calls += 1
    t0 = pack.n_wo + pack.n_gu + pack.n_down
    xq = rms_norm(x_out, gamma_next, eps)
    return torch.cat([quant_linear_ref(xq, _pack_qt(pack, t0 + i))
                      for i in range(pack.n_qkv)], dim=-1)


layer_tail_plain.calls = 0
qkv_tail_plain.calls = 0


def tail_plain(a2, x2, gamma_mlp, pack: LayerPack, gamma_next, *, eps: float):
    """Both references: (x_out [M, H], qkv [M, Nq] or None)."""
    x_out = layer_tail_plain(a2, x2, gamma_mlp, pack, eps=eps)
    qkv = qkv_tail_plain(x_out, gamma_next, pack, eps=eps) if pack.n_qkv else None
    return x_out, qkv


# ---------------------------------------------------------------------------
# CUDA launch (shared with kernels/layer_stream.py)
# ---------------------------------------------------------------------------

_COLS = 128  # output columns per work unit (csrc/layer_tail_int8.cu)
_XS_BYTES = 32 * 1024  # staged activations per block
_MIN_KC = 64
_BLOCKS_PER_SM = 2  # co-resident blocks per SM at most: fewer meet faster at a barrier


def _lib() -> ctypes.CDLL:
    lib = _build.library("layer_tail_int8")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.layer_tail_int8.argtypes = ([vp] * 17 + [ci] * 10
                                        + [ctypes.c_float, ci, ci, ci, vp])
        lib.layer_tail_int8.restype = ci
        lib.layer_tail_int8_blocks_per_sm.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.layer_tail_int8_blocks_per_sm.restype = ci
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _grid(index: int, m_tile: int, is_f32: int) -> int:
    """Blocks of the cooperative launch: all must be resident at once."""
    lib = _lib()
    nb = ctypes.c_int(0)
    _build.check(lib, lib.layer_tail_int8_blocks_per_sm(m_tile, is_f32, ctypes.byref(nb)),
                 "layer_tail_int8 occupancy")
    if nb.value < 1:
        raise RuntimeError("layer_tail_int8: no block fits on an SM")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(nb.value, _BLOCKS_PER_SM) * sms


def plan_tail(M: int, H: int, bn: int, tiles: dict, grid: int) -> Tuple[int, dict]:
    """(m_tile, {phase: K slices}): each phase's K (= H rows of a tile) is
    cut into the most power-of-two slices that still leave at most one unit
    per block (a second round of units costs a unit's whole latency chain
    again), and at least as many as the staged slice needs to fit
    ``_XS_BYTES``."""
    mt = 8 if M <= 8 else 32
    groups = bn // _COLS
    ks = {}
    for name, n in tiles.items():
        k = 1
        while (H % (2 * k) == 0 and H // (2 * k) >= _MIN_KC
               and ((H // k) * mt * 4 > _XS_BYTES or n * groups * 2 * k <= grid)):
            k *= 2
        kc = H // k
        if H % k or kc % 8 or kc * mt * 4 > _XS_BYTES:
            raise ValueError(f"layer_tail_int8 cannot slice H={H} for M={M}")
        ks[name] = k
    return mt, ks


def launch_tail(att: torch.Tensor, x: torch.Tensor, gamma_mlp: torch.Tensor,
                gamma_next: Optional[torch.Tensor], w: torch.Tensor, s: torch.Tensor, *,
                base: int, h_dim: int, i_dim: int, bn: int, n_qkv: int, eps: float):
    """One cooperative ``layer_tail_int8`` launch over tiles [base, base +
    n_tiles) of the stacked ``w``/``s``. att, x [M, H]; returns (x_out [M, H]
    in x's dtype, qkv [M, n_qkv * bn] or None)."""
    H, I = h_dim, i_dim
    M = x.shape[0]
    n_wo, n_gu, n_down = H // bn, 2 * I // bn, (I // H) * (H // bn)
    n_tiles = n_wo + n_gu + n_down + n_qkv
    if w.dtype != torch.int8:
        raise NotImplementedError(f"layer_tail_int8 takes int8 packs; got {w.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_tail_int8 takes bf16/f32 activations, got {x.dtype}")
    if not 0 < M <= 32:
        raise ValueError(f"layer_tail_int8 is a decode kernel: 1 <= M <= 32, got M={M}")
    if bn % _COLS or H % bn or I % H or w.shape[1:] != (H, bn) or s.shape[1:] != (1, bn):
        raise ValueError(f"layer_tail_int8: bad pack (H={H}, I={I}, bn={bn}, "
                         f"w {tuple(w.shape)}, s {tuple(s.shape)})")
    if base < 0 or base + n_tiles > w.shape[0] or s.shape[0] != w.shape[0]:
        raise ValueError(f"layer_tail_int8: tiles [{base}, {base + n_tiles}) outside the "
                         f"pack's {w.shape[0]}")
    for t in (w, s):
        if not (t.is_cuda and t.is_contiguous() and t.device == x.device):
            raise ValueError("layer_tail_int8: the pack must be contiguous on x's device")
    if s.dtype != torch.float32:
        raise TypeError("layer_tail_int8: scales must be f32")
    dev = x.device
    is_f32 = int(x.dtype == torch.float32)
    a2 = att.to(torch.bfloat16).contiguous()
    x2 = x.contiguous()
    g1 = gamma_mlp.to(device=dev, dtype=torch.float32).contiguous()
    g2 = (gamma_next.to(device=dev, dtype=torch.float32).contiguous()
          if gamma_next is not None else torch.ones(H, dtype=torch.float32, device=dev))
    mt0 = 8 if M <= 8 else 32
    grid = _grid(dev.index or 0, mt0, is_f32)
    mt, ks = plan_tail(M, H, bn, {"wo": n_wo, "gu": n_gu, "down": n_down,
                                  "qkv": max(n_qkv, 1)}, grid)
    Nq = n_qkv * bn
    # p_wo, x1, ssq1, p_gu, hbuf, p_down, xo, ssq2, p_q (csrc/layer_tail_int8.cu)
    sizes = [ks["wo"] * M * H, M * H, grid * M, ks["gu"] * M * 2 * I, M * I,
             (I // H) * ks["down"] * M * H, M * H, grid * M, ks["qkv"] * M * max(Nq, 1)]
    ws = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    bufs = list(torch.split(ws, sizes))
    out = torch.empty((M, H), dtype=x.dtype, device=dev)
    qkv = torch.empty((M, Nq), dtype=x.dtype, device=dev) if n_qkv else None
    lib = _lib()
    rc = lib.layer_tail_int8(
        _build.ptr(a2), _build.ptr(x2), _build.ptr(g1), _build.ptr(g2), _build.ptr(w),
        _build.ptr(s), _build.ptr(out), None if qkv is None else _build.ptr(qkv),
        *[_build.ptr(b) for b in bufs],
        M, H, I, bn, base, n_qkv, ks["wo"], ks["gu"], ks["down"], ks["qkv"],
        eps, grid, mt, is_f32, _build.stream_of(x2))
    _build.check(lib, rc, "layer_tail_int8")
    return out, qkv


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def mlp_qkv_fused(att: torch.Tensor, x: torch.Tensor, gamma_mlp: torch.Tensor,
                  pack: LayerPack, gamma_next: Optional[torch.Tensor] = None, *,
                  eps: float = 1e-5):
    """x1 = att @ wo + x; h = swiglu(rmsnorm(x1) @ wgu); x_out = h @ down +
    x1; qkv = rmsnorm(x_out, gamma_next) @ wqkv_next. Returns (x_out like
    ``x``, qkv [..., Nq] or None when pack.n_qkv == 0).

    CUDA tensors launch ``layer_tail_int8``; CPU tensors take the plain
    references."""
    H, bn = pack.h_dim, pack.bn
    lead = x.shape[:-1]
    a2, x2 = att.reshape(-1, H), x.reshape(-1, H)
    if x2.shape[0] > 32:
        raise ValueError(f"mlp_qkv_fused is decode-only (M={x2.shape[0]} > 32)")
    Nq = pack.n_qkv * bn
    gm_nxt = gamma_next if gamma_next is not None else torch.ones(H, dtype=torch.float32,
                                                                   device=x.device)
    if not x.is_cuda:
        x_out, qkv = tail_plain(a2, x2, gamma_mlp, pack, gm_nxt, eps=eps)
    else:
        x_out, qkv = launch_tail(a2, x2, gamma_mlp, gm_nxt, pack.w, pack.s, base=0,
                                 h_dim=H, i_dim=pack.i_dim, bn=bn, n_qkv=pack.n_qkv, eps=eps)
        mlp_qkv_fused.launches += 1
    return x_out.reshape(*lead, H), None if qkv is None else qkv.reshape(*lead, Nq)


mlp_qkv_fused.launches = 0
