"""Fused AdamW: one update of one parameter leaf (param, both moments and the
f32 master) in a single pass over device memory.

Replaces the TPU kernel ``mila_tpu/kernels/fused_adamw.py:_adamw_kernel``
(entry ``fused_adamw_update``). ``optim.AdamW.step`` calls it once per
parameter leaf on every device: for CUDA tensors it launches
``csrc/fused_adamw.cu``, for CPU tensors it runs
:func:`fused_adamw_update_plain`, which is JAX's per-leaf update
(``optim/adamw.py``) in the same operation order.

What bounds it on the H100: bytes. Per element it reads p and g (2 bytes
each in bf16), m, v and the master (4 each) and the noise (4), and writes
p, m, v and the master: ~34 bytes against ~12 f32 operations. The kernel is
one grid-stride pass, 4 elements per thread with 16-byte loads of the f32
streams, and no padding to the TPU's 128 lanes.

Differences from the JAX entry, none of which changes a result:
- the stochastic-rounding noise is an argument (uint32 or int32 bits
  shaped like p, or flat), not a ``seed``: the caller draws it from a
  ``torch.Generator``, and a test can feed JAX's own bits;
- ``grad_scale`` multiplies the f32 gradient first, so the global-norm
  clip of ``AdamW.step`` (JAX: ``g * clip``, which promotes a bf16 gradient
  to f32) costs no pass of its own; 1.0 leaves g as it is;
- ``block`` and ``interpret`` (the TPU's tiling and interpreter) are gone.

Stochastic rounding applies, as in JAX's kernel, to a bf16 param with a
master; an f32 param with a master gets p' = master'. An fp16 param is
rounded to nearest, with or without a master, as JAX's kernel rounds it.
JAX's ``AdamW`` gives the same fp16 values: its fp16 "stochastic" branch
steps to the neighbouring f32 value (``nextafter`` in f32) and casts that
back to fp16, which lands on the nearest fp16 value again (a defect of the
reference, ROADMAP §C.3); so on fp16 the kernel and both JAX routes agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from mila_tpu_torch.kernels import _build


def _f32(x: float) -> float:
    """x rounded to f32, as a Python float (JAX's weakly typed scalars)."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=16)
def bias_corrections(step: int, beta1: float, beta2: float) -> tuple[float, float]:
    """(1 - beta1^t, 1 - beta2^t) computed in f32, as JAX computes them
    (once per step: every leaf of the step asks for the same pair)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    b1 = torch.tensor(_f32(beta1), dtype=torch.float32)
    b2 = torch.tensor(_f32(beta2), dtype=torch.float32)
    return float(1.0 - b1 ** t), float(1.0 - b2 ** t)


def stochastic_round_bf16(w: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """bf16 of (bits(w) + (noise & 0xffff)) & 0xffff0000: unbiased rounding
    of an f32 tensor from the given random bits (JAX's construction)."""
    bits = w.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + (noise.reshape(w.shape).to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def fused_adamw_update_plain(p, g, m, v, master, *, step: int, lr: float, beta1: float = 0.9,
                             beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                             noise: Optional[torch.Tensor] = None, grad_scale: float = 1.0):
    """Plain version of :func:`fused_adamw_update`: the same f32 operations in
    the same order as the kernel (and JAX's ``AdamW.step``), one PyTorch op
    each."""
    fused_adamw_update_plain.calls += 1
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    dev = m.device
    # 0-dim tensors on the device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the kernel does not.
    bc1_t = torch.tensor(bc1, dtype=torch.float32, device=dev)
    bc2_t = torch.tensor(bc2, dtype=torch.float32, device=dev)
    g32 = g.float() * _f32(grad_scale)
    w = (master if master is not None else p).float()
    m_new = _f32(beta1) * m + _f32(1.0 - beta1) * g32
    v_new = _f32(beta2) * v + _f32(1.0 - beta2) * g32 * g32
    upd = (m_new / bc1_t) / (torch.sqrt(v_new / bc2_t) + _f32(eps)) + _f32(weight_decay) * w
    w_new = w - _f32(lr) * upd
    if master is not None and p.dtype == torch.bfloat16:
        if noise is None:
            raise ValueError("stochastic rounding of a bf16 param needs noise")
        p_new = stochastic_round_bf16(w_new, noise)
    else:
        p_new = w_new.to(p.dtype)
    return p_new, m_new, v_new, (w_new if master is not None else None)


fused_adamw_update_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("fused_adamw")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_adamw.argtypes = [vp] * 10 + [ctypes.c_longlong, ci, ci] + [cf] * 10 + [vp]
        lib.fused_adamw.restype = ci
        lib._typed = True
    return lib


def _launch(p, g, m, v, master, *, step, lr, beta1, beta2, eps, weight_decay, noise,
            grad_scale):
    if p.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"fused_adamw takes f32, bf16 or fp16 params, got {p.dtype}")
    if (g.dtype not in (p.dtype, torch.float32) or m.dtype != torch.float32
            or v.dtype != torch.float32):
        raise ValueError(f"fused_adamw: g must be p's dtype or f32 and m, v f32 (p {p.dtype}, "
                         f"g {g.dtype}, m {m.dtype}, v {v.dtype})")
    stochastic = master is not None and p.dtype == torch.bfloat16
    if stochastic and noise is None:
        raise ValueError("stochastic rounding of a bf16 param needs noise")
    ts = [p, g, m, v] + ([master] if master is not None else [])
    if any(t.numel() != p.numel() or t.device != p.device for t in ts):
        raise ValueError("fused_adamw: p, g, m, v and master must match in size and device")
    pc, gc, mc, vc = (t.contiguous() for t in (p, g, m, v))
    wc = master.float().contiguous() if master is not None else None
    nz = None
    if stochastic:
        if noise.numel() != p.numel() or noise.dtype not in (torch.int32, torch.uint32):
            raise ValueError("fused_adamw: noise must be int32/uint32 bits, one per element")
        nz = noise.to(p.device).contiguous()
    p_out, m_out, v_out = torch.empty_like(pc), torch.empty_like(mc), torch.empty_like(vc)
    w_out = torch.empty_like(wc) if wc is not None else None
    bc1, bc2 = bias_corrections(step, beta1, beta2)

    def ptr(t):
        return None if t is None else _build.ptr(t)

    lib = _lib()
    rc = lib.fused_adamw(ptr(pc), ptr(gc), ptr(mc), ptr(vc), ptr(wc), ptr(nz), ptr(p_out),
                         ptr(m_out), ptr(v_out), ptr(w_out), p.numel(),
                         _build.DTYPE_CODES[p.dtype], int(g.dtype != torch.float32),
                         _f32(lr), _f32(beta1), _f32(1.0 - beta1), _f32(beta2),
                         _f32(1.0 - beta2), _f32(eps), _f32(weight_decay), bc1, bc2,
                         _f32(grad_scale), _build.stream_of(p))
    _build.check(lib, rc, "fused_adamw")
    fused_adamw_update.launches += 1
    return p_out, m_out, v_out, w_out


def fused_adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       master: Optional[torch.Tensor], *, step: int, lr: float,
                       beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 0.01, noise: Optional[torch.Tensor] = None,
                       grad_scale: float = 1.0):
    """One fused AdamW update of one parameter leaf; returns (p', m', v',
    master') with master' None when master is. ``step`` is the 1-based step
    count; ``lr`` a float (a schedule's value). CUDA tensors launch
    ``fused_adamw``; CPU tensors take :func:`fused_adamw_update_plain`."""
    kw = dict(step=int(step), lr=float(lr), beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, noise=noise, grad_scale=float(grad_scale))
    if p.is_cuda:
        return _launch(p, g, m, v, master, **kw)
    return fused_adamw_update_plain(p, g, m, v, master, **kw)


fused_adamw_update.launches = 0
