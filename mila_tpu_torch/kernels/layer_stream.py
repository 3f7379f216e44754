"""The layer tails of all decoder layers as one stacked weight stream.

Replaces the TPU kernel ``mila_tpu/kernels/layer_stream.py:_stream_kernel``
(entry ``layer_tail_stream``): wo(+res) -> RMSNorm -> SwiGLU -> down(+res)
-> the next layer's RMSNorm + wqkv, reading layer ``layer``'s tiles out of
one stacked array. ``LayerStream`` keeps the JAX layout: ``w``/``s`` hold
layers 0..L-2 (each with the next layer's wqkv appended), ``w_last``/
``s_last`` the last layer's tail with no qkv segment.

The CUDA kernel is the one of ``kernels/layer_fused.py``
(``csrc/layer_tail_int8.cu``), launched at the layer's first tile. The
TPU kernel bakes that tile base into a compiled specialization per layer,
so ``layer`` must be a Python int; here the base is a launch argument, and
the int check is kept for the same calling contract. Arithmetic and the
difference between the kernel and its plain version are as described in
``kernels/layer_fused.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mila_tpu_torch.kernels.layer_fused import LayerPack, launch_tail, tail_plain


class LayerStream(NamedTuple):
    """All decoder layers' tail weights stacked (see module doc)."""

    w: torch.Tensor  # [(L-1)*T_full, bk, bn]
    s: torch.Tensor  # [(L-1)*T_full, 1, bn] f32
    w_last: torch.Tensor  # [T_tail, bk, bn]
    s_last: torch.Tensor  # [T_tail, 1, bn] f32
    h_dim: int
    i_dim: int
    bn: int
    n_wo: int
    n_gu: int
    n_down: int
    n_qkv: int
    n_layers: int


def pack_layer_stream(packs) -> Optional[LayerStream]:
    """Stack per-layer ``pack_layer`` outputs (layers 0..L-1, each but the
    last carrying the next layer's wqkv) into one stream; None when they do
    not chain."""
    if not packs or any(p is None for p in packs):
        return None
    first, last = packs[0], packs[-1]
    if len(packs) > 1:
        if any(p.n_qkv != first.n_qkv for p in packs[:-1]) or last.n_qkv != 0:
            return None
        body = packs[:-1]
        w = torch.cat([p.w for p in body])
        s = torch.cat([p.s for p in body])
    else:
        w, s = first.w[:0], first.s[:0]
    return LayerStream(w=w, s=s, w_last=last.w, s_last=last.s, h_dim=first.h_dim,
                       i_dim=first.i_dim, bn=first.bn, n_wo=first.n_wo, n_gu=first.n_gu,
                       n_down=first.n_down, n_qkv=first.n_qkv, n_layers=len(packs))


def _pack_view(stream: LayerStream, layer: int, is_last: bool) -> LayerPack:
    """Per-layer LayerPack view of the stacked stream."""
    if is_last:
        return LayerPack(w=stream.w_last, s=stream.s_last, h_dim=stream.h_dim,
                         i_dim=stream.i_dim, bn=stream.bn, n_wo=stream.n_wo,
                         n_gu=stream.n_gu, n_down=stream.n_down, n_qkv=0)
    T = stream.n_wo + stream.n_gu + stream.n_down + stream.n_qkv
    return LayerPack(w=stream.w[layer * T:(layer + 1) * T],
                     s=stream.s[layer * T:(layer + 1) * T], h_dim=stream.h_dim,
                     i_dim=stream.i_dim, bn=stream.bn, n_wo=stream.n_wo, n_gu=stream.n_gu,
                     n_down=stream.n_down, n_qkv=stream.n_qkv)


def layer_tail_stream(att: torch.Tensor, x: torch.Tensor, gamma_mlp: torch.Tensor,
                      stream: LayerStream, layer: int,
                      gamma_next: Optional[torch.Tensor] = None, *, eps: float = 1e-5):
    """x1 = att @ wo + x; h = swiglu(rms(x1) @ wgu); x_out = h @ down + x1;
    qkv = rms(x_out, gamma_next) @ wqkv_next, for layer ``layer`` (a Python
    int) of the stream. Returns (x_out like ``x``, qkv [..., Nq] or None for
    the last layer).

    CUDA tensors launch ``layer_tail_int8``; CPU tensors take the plain
    references."""
    if not isinstance(layer, int):
        raise TypeError(f"layer_tail_stream needs a static int layer id, got "
                        f"{type(layer).__name__}")
    H, bn = stream.h_dim, stream.bn
    lead = x.shape[:-1]
    a2, x2 = att.reshape(-1, H), x.reshape(-1, H)
    if x2.shape[0] > 32:
        raise ValueError(f"layer_tail_stream is decode-only (M={x2.shape[0]} > 32)")
    is_last = layer == stream.n_layers - 1
    n_qkv = 0 if is_last else stream.n_qkv
    Nq = n_qkv * bn
    gm_nxt = gamma_next if gamma_next is not None else torch.ones(H, dtype=torch.float32,
                                                                   device=x.device)
    if not x.is_cuda:
        x_out, qkv = tail_plain(a2, x2, gamma_mlp, _pack_view(stream, layer, is_last),
                                gm_nxt, eps=eps)
    else:
        n_tiles = stream.n_wo + stream.n_gu + stream.n_down + n_qkv
        w, s = (stream.w_last, stream.s_last) if is_last else (stream.w, stream.s)
        x_out, qkv = launch_tail(a2, x2, gamma_mlp, gm_nxt, w, s,
                                 base=0 if is_last else layer * n_tiles, h_dim=H,
                                 i_dim=stream.i_dim, bn=bn, n_qkv=n_qkv, eps=eps)
        layer_tail_stream.launches += 1
    return x_out.reshape(*lead, H), None if qkv is None else qkv.reshape(*lead, Nq)


layer_tail_stream.launches = 0
