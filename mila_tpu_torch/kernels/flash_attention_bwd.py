"""Flash attention backward: dq, dk, dv from q, k, v, o, the forward's row
statistics l, m and the output cotangent do.

Replaces the TPU kernels ``mila_tpu/kernels/flash_attention_bwd.py:
_dkv_kernel`` and ``_dq_kernel`` (entry ``flash_attention_bwd``), which
``kernels/flash_attention.py``'s autograd Function calls in its backward
(JAX's ``_fa_bwd``). The math, per (query i, key j) pair and head:

    p_ij  = exp(s_ij * scale - m_i) / l_i      (l == 0 taken as 1)
    dv_j  = sum_i bf16(p_ij) do_i
    ds_ij = p_ij * (do_i . v_j - D_i) * scale,  D_i = sum_d do_id o_id (f32)
    dq_i  = sum_j bf16(ds_ij) k_j,  dk_j = sum_i bf16(ds_ij) q_i

with the causal mask under ``kv_offset`` (query i sees keys j <= i +
kv_offset) and GQA (query head h reads KV head h // G). dk and dv sum over
the G query heads of a KV head: the JAX kernel writes f32 per query head
and sums afterwards; the CUDA kernel sums inside its block, so the two
differ in f32 order only.

What bounds it on the H100: tensor-core operations (about 10 * D per
visible pair and head) against q, k, v, o, do, dq, dk, dv moved once. The
CUDA launch (``csrc/flash_bwd.cu``, bf16 and fp16 at every D) is three
kernels: the row statistics (D and lse = m + ln l, per row, in the kernel's
own launch), a dK/dV pass per key block and KV head (at D 192 and 256 two
warpgroups on the same keys, each on half of dK's and dV's columns) and a
dQ pass per q tile and head, on TMA-fed ``wgmma``. Past D 256 both passes
run on column parts (``flash_attention.plan_bwd``: dQ the forward's parts
of up to 512 columns, dK/dV parts of 256), S and dP formed once a tile and
part between the two warpgroups, a producer warp streaming the operands.
One call counts as one launch.

The entry keeps the JAX entry's head-major layout (q, o, do [B, NH, Tq,
D], k, v [B, NKV, Tkv, D]), here as any views: the autograd Function passes
transposed views of the model-layout tensors, which the launch reads
without a copy. l and m are f32 [B, NH, Tq] (JAX's carry 128 padded lanes;
the tests compare its column 0). That launch reads either forward's
statistics (m of the scaled scores, l the f32 sum against the running
max). f32 at D 64 and 128 launches ``csrc/flash_tf32_bwd.cu`` (two prep
launches write every operand once as tf32 ``wgmma`` reads it: rounded, dO
and V also split into hi and lo for dP, Q, dO and K also transposed; then
a dK/dV and a dQ kernel on TMA and tf32 ``wgmma``; one call, one count).
f32 from D 192 (``flash_attention.routes``: "sync") launches
``csrc/flash_sync_bwd.cu`` (a dQ kernel that also forms D, then a dK/dV
kernel; one call, one count) on blocks of 8 warps that own up to 512
columns (two parts at D 1024), form S and dP once a tile on ``wgmma``'s
tf32 form and stage each operand once. Every f32 dP runs on split tf32
operands, summed in f32. A causal call with a
negative ``kv_offset`` (rows with no visible key) raises on the card, as
the forward does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels.flash_attention import routes
from mila_tpu_torch.ops.attention import causal_mask

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_TILE = 64  # keys per tile in csrc/flash_bwd.cu
_TQ_ALIGN = 64  # the kernel's statistics rows are padded to this


def flash_attention_bwd_plain(q, k, v, o, l, m, do, *, causal: bool, sm_scale: float,
                              kv_offset: int = 0):
    """Plain version of :func:`flash_attention_bwd`, all pairs at once in f32
    (the JAX kernels' tile math with one tile)."""
    flash_attention_bwd_plain.calls += 1
    B, NH, Tq, D = q.shape
    NKV, Tkv = k.shape[1], k.shape[2]
    G = NH // NKV
    qg = q.float().reshape(B, NKV, G, Tq, D)
    dog = do.float().reshape(B, NKV, G, Tq, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * sm_scale
    if causal:
        cm = causal_mask(Tq, Tkv, kv_offset, device=q.device)
        s = torch.where(cm, s, MASK_VALUE)
    l5, m5 = l.float().reshape(B, NKV, G, Tq, 1), m.float().reshape(B, NKV, G, Tq, 1)
    p = torch.exp(s - m5) / torch.where(l5 == 0, 1.0, l5)
    del s
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dog)
    di = (o.float() * do.float()).sum(-1).reshape(B, NKV, G, Tq, 1)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, vf) - di) * sm_scale
    del p
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qg)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(), kf)
    return dq.reshape(B, NH, Tq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_bwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd.argtypes = [vp] * 12 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        lib.flash_bwd.restype = ci
        lib._typed = True
    return lib


def _sync_lib(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    lib = lib or _build.library("flash_sync_bwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_sync_bwd.argtypes = [vp] + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        lib.flash_sync_bwd.restype = ci
        lib._typed = True
    return lib


def _tf32_lib(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    lib = lib or _build.library("flash_tf32_bwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_tf32_bwd.argtypes = [vp, vp] + [ci] * 6 + [ctypes.c_float, ci, ci, vp]
        lib.flash_tf32_bwd.restype = ci
        lib.flash_tf32_bwd_scratch.argtypes = [ci] * 6
        lib.flash_tf32_bwd_scratch.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _launch(q, k, v, o, l, m, do, causal: bool, sm_scale: float, kv_offset: int,
            lib: Optional[ctypes.CDLL] = None):
    """One call of the backward family ``routes`` names. ``lib``: for the
    f32 families, a library built from a variant of that family's source,
    launched in place of the package's build (``tools/flash_f32_rows.py``)."""
    B, NH, Tq, D = q.shape
    NKV, Tkv = k.shape[1], k.shape[2]
    if any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise NotImplementedError(f"flash_bwd takes q/k/v/o/do of one type; got {q.dtype}, "
                                  f"{k.dtype}, {v.dtype}, {o.dtype}, {do.dtype}")
    fam = routes(q.dtype, D)[1]
    if (Tkv % _TILE or v.shape != k.shape or k.shape[0] != B or o.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"flash_bwd needs Tkv % {_TILE} == 0 (q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)})")
    if causal and kv_offset < 0:
        raise ValueError("flash_bwd: a negative kv_offset leaves rows with no key")

    def model_layout(t):  # [B, H, T, D] view -> contiguous [B, T, H, D] (a view if it is one)
        t = t.transpose(1, 2).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()  # TMA reads 16-byte-aligned bases

    qm, km, vm, om, dom = (model_layout(t) for t in (q, k, v, o, do))
    lc, mc = l.float().contiguous(), m.float().contiguous()
    if lib is not None and fam not in ("tf32", "sync"):
        raise ValueError(f"flash_bwd: no variant library for the {fam} family")
    if fam == "tf32":
        lib = _tf32_lib(lib)
        # The operand copies the prep launches write (rounded, split and
        # transposed for the products), lse2 and D.
        scratch = torch.empty(lib.flash_tf32_bwd_scratch(B, Tq, Tkv, NH, NKV, D),
                              device=q.device, dtype=torch.float32)
        dq, dk, dv = torch.empty_like(qm), torch.empty_like(km), torch.empty_like(vm)
        ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in (qm, km, vm, om, dom, lc, mc, dq,
                                                                dk, dv)))
        rc = lib.flash_tf32_bwd(ptrs, _build.ptr(scratch), B, Tq, Tkv, NH, NKV, D, sm_scale,
                                kv_offset, int(causal), _build.stream_of(q))
        _build.check(lib, rc, "flash_tf32_bwd")
        flash_attention_bwd.launches += 1
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if fam == "sync":
        delta = torch.empty(B, NH, Tq, device=q.device, dtype=torch.float32)  # scratch
        dq, dk, dv = torch.empty_like(qm), torch.empty_like(km), torch.empty_like(vm)
        ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (qm, km, vm, om, dom, lc, mc, delta,
                                                                dq, dk, dv)))
        lib = _sync_lib(lib)
        rc = lib.flash_sync_bwd(ptrs, B, Tq, Tkv, NH, NKV, D, _build.DTYPE_CODES[q.dtype],
                                sm_scale, kv_offset, int(causal), _build.stream_of(q))
        _build.check(lib, rc, "flash_sync_bwd")
        flash_attention_bwd.launches += 1
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    tq64 = -(-Tq // _TQ_ALIGN) * _TQ_ALIGN
    lse2 = torch.empty(B, NH, tq64, device=q.device, dtype=torch.float32)  # scratch
    delta = torch.empty_like(lse2)
    dq, dk, dv = torch.empty_like(qm), torch.empty_like(km), torch.empty_like(vm)
    lib = _lib()
    rc = lib.flash_bwd(*(_build.ptr(t) for t in (qm, km, vm, om, dom, lc, mc, lse2, delta, dq, dk,
                                                 dv)),
                       B, Tq, Tkv, NH, NKV, D, _build.DTYPE_CODES[q.dtype], sm_scale, kv_offset,
                       int(causal), _build.stream_of(q))
    _build.check(lib, rc, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        l: torch.Tensor, m: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        sm_scale: float, kv_offset: int = 0):
    """(dq [B, NH, Tq, D] in q's dtype, dk, dv [B, NKV, Tkv, D] in k's and
    v's) for head-major q, o, do [B, NH, Tq, D], k, v [B, NKV, Tkv, D] and
    l, m f32 [B, NH, Tq]. CUDA tensors launch ``flash_bwd`` (one call, its
    statistics, dK/dV and dQ kernels); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads {q.shape[1]} not divisible by num_kv_heads {k.shape[1]}")
    if q.is_cuda:
        return _launch(q, k, v, o, l, m, do, causal, sm_scale, kv_offset)
    return flash_attention_bwd_plain(q, k, v, o, l, m, do, causal=causal, sm_scale=sm_scale,
                                     kv_offset=kv_offset)


flash_attention_bwd.launches = 0
