"""Decode-shape fused weight streams (M <= 32 rows): RMSNorm, residual add,
SwiGLU and the greedy argmax folded into the int8 dequant matmul.

Replaces four TPU kernels of ``mila_tpu/kernels/decode_fused.py``:

- ``rms_quant_linear`` (``_rms_qmm_kernel``): y = bf16(rmsnorm(x)*gamma) @ W
  -- wqkv at decode, and norm_f -> lm_head;
- ``quant_linear_residual`` (``_qmm_res_kernel``): y = x @ W + res -- wo, down;
- ``rms_quant_linear_swiglu`` (``_rms_qmm_swiglu_kernel``): rmsnorm ->
  [gate|up] -> silu(g)*u -- wgu;
- ``rms_quant_linear_argmax`` (``_rms_qmm_argmax_kernel``): norm_f ->
  lm_head -> per-row argmax token; the logits are never written. Each
  block reduces its columns to a 64-bit key (order-preserving f32 bits
  above the inverted column index, so the larger value and then the lower
  index win) and merges it with one ``atomicMax`` per warp into a per-row
  key the call resets first; a last tiny pass turns keys into indices.

What bounds it on the H100: the int8 weight stream (K*N bytes against
2*M*K*N operations, M <= 32: far below the card's operations-per-byte
balance). One CUDA kernel family (``csrc/qgemv_int8.cu``) serves all four:
a block owns 128 output columns and a slice of K, each thread streams
4-byte coalesced weight words, activations are staged per K slice in shared
memory (the whole [M, K] x of the TPU kernel does not fit: 32x8192 bf16 is
512 KB), and the K slices are summed by a second small pass when the
column tiles alone are too few to fill the card's 132 SMs.

Arithmetic (the Pallas kernels'): rstd = rsqrt(mean(x^2) + eps) in f32 over
the whole row, xs = bf16(x * rstd * gamma), partial sums (xs @ bf16(q))_f32
times the scale row, then the epilogue in f32 and a cast to the output
dtype. The plain versions below compute the same; on the CPU they mirror
the JAX dispatch, which falls back to unfused ops when a shape does not
fit its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mila_tpu_torch.inference.quantize import QTensor
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels.quant_matmul import (
    _DECODE_TILE_BYTES,
    _pick_blocks,
    quant_linear_plain,
    scaled_partials,
)
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.swiglu import swiglu

_X_RESIDENT_BYTES = 1024 * 1024  # the JAX kernels' [M, K] residency limit


def _decode_ok(M: int, K: int, N: int, qt: QTensor, *, resident: bool,
               halve: bool = False) -> bool:
    """Whether the JAX entry point takes its Pallas kernel at this shape."""
    bn, bk = _pick_blocks(M, K, N, 1024, 512, qt.block_size)
    while N % bn or (halve and bn * bk > _DECODE_TILE_BYTES // 2):
        bn //= 2
    while K % bk or qt.block_size % bk:
        bk //= 2
    return (M <= 32 and bn >= 128 and bk >= 128
            and (not resident or M * K * 2 <= _X_RESIDENT_BYTES)
            and qt.q.element_size() == 1 and not qt.packed_rows)


def _rms_scaled(x2: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x2.float()
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rstd * gamma.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def rms_quant_linear_plain(x, gamma, qt: QTensor, eps: float = 1e-5):
    rms_quant_linear_plain.calls += 1
    K = qt.packed_rows or qt.q.shape[0]
    N = qt.q.shape[1]
    x2 = x.reshape(-1, K)
    if not _decode_ok(x2.shape[0], K, N, qt, resident=True):
        out = quant_linear_plain(rms_norm(x2, gamma, eps), qt)
        return out.reshape(*x.shape[:-1], N)
    y = scaled_partials(_rms_scaled(x2, gamma, eps), qt)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


def quant_linear_residual_plain(x, qt: QTensor, res):
    quant_linear_residual_plain.calls += 1
    K = qt.packed_rows or qt.q.shape[0]
    N = qt.q.shape[1]
    x2 = x.reshape(-1, K)
    r2 = res.reshape(-1, N)
    if not _decode_ok(x2.shape[0], K, N, qt, resident=False):
        out = quant_linear_plain(x2, qt) + r2.to(x2.dtype)
        return out.reshape(res.shape)
    y = scaled_partials(x2.to(torch.bfloat16), qt) + r2.float()
    return y.to(res.dtype).reshape(res.shape)


def rms_quant_linear_swiglu_plain(x, gamma, qt: QTensor, eps: float = 1e-5):
    rms_quant_linear_swiglu_plain.calls += 1
    K = qt.packed_rows or qt.q.shape[0]
    N2 = qt.q.shape[1]
    I = N2 // 2
    x2 = x.reshape(-1, K)
    if N2 % 2 or not _decode_ok(x2.shape[0], K, I, qt, resident=True, halve=True):
        gu = quant_linear_plain(rms_norm(x2, gamma, eps), qt)
        g, u = gu.split(N2 // 2, dim=-1)
        return swiglu(g, u).reshape(*x.shape[:-1], I)
    gu = scaled_partials(_rms_scaled(x2, gamma, eps), qt)
    g, u = gu[:, :I], gu[:, I:]
    return (g * torch.sigmoid(g) * u).to(x.dtype).reshape(*x.shape[:-1], I)


def rms_quant_linear_argmax_plain(x, gamma, qt: QTensor, *, vocab_size: int,
                                  eps: float = 1e-5):
    """Plain version of :func:`rms_quant_linear_argmax` for a shape the
    kernel takes: argmax over the f32 scaled partial sums (not over
    bf16-rounded logits), padded vocab columns excluded, first index on ties."""
    rms_quant_linear_argmax_plain.calls += 1
    K = qt.q.shape[0]
    x2 = x.reshape(-1, K)
    logits = scaled_partials(_rms_scaled(x2, gamma, eps), qt)[:, :vocab_size]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok.reshape(*x.shape[:-1], 1)


for _f in (rms_quant_linear_plain, quant_linear_residual_plain,
           rms_quant_linear_swiglu_plain, rms_quant_linear_argmax_plain):
    _f.calls = 0

# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_COLS = 128  # output columns per block (csrc/qgemv_int8.cu)
_X_SMEM_BYTES = 64 * 1024  # staged activations per block


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_ksplit(M: int, K: int, n_cols: int, block_size: int,
                 sms: int) -> tuple[int, int]:
    """(m_tile, ksplit): K slices per column tile so that the launch has
    about two blocks per SM, each slice inside one scale block."""
    mt = 8 if M <= 8 else 32
    tiles = -(-n_cols // _COLS)
    ks = 1
    while K % (2 * ks) == 0 and (
        (K // ks) * mt * 4 > _X_SMEM_BYTES
        or block_size % (K // ks)
        or (tiles * ks < 2 * sms and K // (2 * ks) >= 128)
    ):
        ks *= 2
    kc = K // ks
    if K % ks or kc % 32 or block_size % kc or kc * mt * 4 > _X_SMEM_BYTES:
        raise ValueError(f"qgemv_int8 cannot slice K={K} (block_size={block_size})")
    return mt, ks


def _qgemv_lib() -> ctypes.CDLL:
    lib = _build.library("qgemv_int8")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qgemv_int8.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                   ci, ci, ci, ctypes.c_float, ci, ci, ci, vp]
        lib.qgemv_int8.restype = ci
        lib.qgemv_int8_argmax.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                          ctypes.c_float, ci, ci, ci, vp]
        lib.qgemv_int8_argmax.restype = ci
        lib._typed = True
    return lib


_MODE = {"store": 0, "residual": 1, "swiglu": 2}


def _launch(x, qt: QTensor, *, mode: str, gamma=None, res=None, eps: float = 0.0,
            vocab: int = 0):
    K = qt.packed_rows or qt.q.shape[0]
    ldq = qt.q.shape[1]
    n_out = ldq // 2 if mode == "swiglu" else ldq
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if qt.packed_rows or qt.q.dtype != torch.int8:
        raise NotImplementedError(f"qgemv_int8 takes int8 weights; got {qt.q.dtype}"
                                  f"{' (int4-packed)' if qt.packed_rows else ''}")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qgemv_int8 takes bf16/f32 activations, got {x2.dtype}")
    if not 0 < M <= 32:
        raise ValueError(f"qgemv_int8 is a decode kernel: 1 <= M <= 32, got M={M}")
    if ldq % 4 or (mode == "swiglu" and ldq % 8) or K % 8:
        raise ValueError(f"qgemv_int8 needs N % 4 == 0 and K % 8 == 0 (K={K}, N={ldq})")
    if qt.scale.dtype != torch.float32:
        raise TypeError("qgemv_int8: scales must be f32")
    for t in (qt.q, qt.scale):
        if not (t.is_cuda and t.is_contiguous() and t.device == x2.device):
            raise ValueError("qgemv_int8: weights must be contiguous on x's device")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the RMSNorm pass reads x in 16-byte words
        x2 = x2.clone()
    g32 = None
    if gamma is not None:
        g32 = gamma.to(device=x2.device, dtype=torch.float32).contiguous()
    r2 = None
    if res is not None:
        r2 = res.reshape(-1, n_out)
        if r2.dtype != x2.dtype or r2.shape[0] != M:
            raise TypeError("qgemv_int8: residual must match x's dtype and rows")
        r2 = r2.contiguous()
    mt, ks = _plan_ksplit(M, K, n_out, qt.block_size,
                           _sm_count(x2.device.index or 0))
    ws = None
    if ks > 1:
        ws = torch.empty((ks, M, ldq), dtype=torch.float32, device=x2.device)
    lib = _qgemv_lib()
    if mode == "argmax":
        if ldq % 128:
            raise ValueError(f"qgemv_int8 argmax needs N % 128 == 0 (N={ldq})")
        keys = torch.empty((M,), dtype=torch.int64, device=x2.device)  # reset in the call
        tok = torch.empty((M,), dtype=torch.int32, device=x2.device)
        rc = lib.qgemv_int8_argmax(
            _build.ptr(x2), _build.ptr(g32), _build.ptr(qt.q), _build.ptr(qt.scale),
            _build.ptr(keys), _build.ptr(tok), None if ws is None else _build.ptr(ws),
            M, ldq, K, qt.block_size, vocab, eps, ks, mt, int(x2.dtype == torch.float32),
            _build.stream_of(x2))
        _build.check(lib, rc, "qgemv_int8_argmax")
        return tok
    out = torch.empty((M, n_out), dtype=x2.dtype, device=x2.device)
    rc = lib.qgemv_int8(
        _build.ptr(x2), None if g32 is None else _build.ptr(g32),
        _build.ptr(qt.q), _build.ptr(qt.scale),
        None if r2 is None else _build.ptr(r2), _build.ptr(out),
        None if ws is None else _build.ptr(ws),
        M, n_out, K, ldq, qt.block_size, _MODE[mode], int(gamma is not None),
        eps, ks, mt, int(x2.dtype == torch.float32), _build.stream_of(x2))
    _build.check(lib, rc, "qgemv_int8")
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def rms_quant_linear(x: torch.Tensor, gamma: torch.Tensor, qt: QTensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """Fused rmsnorm(x, gamma) @ dequant(qt) for decode shapes (M <= 32)."""
    if not x.is_cuda:
        return rms_quant_linear_plain(x, gamma, qt, eps)
    out = _launch(x, qt, mode="store", gamma=gamma, eps=eps)
    rms_quant_linear.launches += 1
    return out.reshape(*x.shape[:-1], out.shape[-1])


def quant_linear_residual(x: torch.Tensor, qt: QTensor, res: torch.Tensor) -> torch.Tensor:
    """Fused x @ dequant(qt) + res for decode shapes (M <= 32)."""
    if not x.is_cuda:
        return quant_linear_residual_plain(x, qt, res)
    out = _launch(x, qt, mode="residual", res=res)
    quant_linear_residual.launches += 1
    return out.reshape(res.shape)


def rms_quant_linear_swiglu(x: torch.Tensor, gamma: torch.Tensor, qt: QTensor, *,
                            eps: float = 1e-5) -> torch.Tensor:
    """Fused rmsnorm -> [gate|up] projection -> silu(g)*u for decode shapes;
    ``qt`` holds the fused [K, 2I] weight, the result is [..., I]."""
    if not x.is_cuda:
        return rms_quant_linear_swiglu_plain(x, gamma, qt, eps)
    out = _launch(x, qt, mode="swiglu", gamma=gamma, eps=eps)
    rms_quant_linear_swiglu.launches += 1
    return out.reshape(*x.shape[:-1], out.shape[-1])


def rms_quant_linear_argmax(x: torch.Tensor, gamma: torch.Tensor, qt: QTensor, *,
                            vocab_size: int, eps: float = 1e-5) -> Optional[torch.Tensor]:
    """Greedy head: argmax over rmsnorm(x, gamma) @ dequant(qt), the argmax
    fused into the weight stream. Returns [..., 1] int32 token ids, or None
    exactly where the JAX entry point does (a shape its kernel does not
    take, or vocab_size > N): the caller then takes the unfused head and
    argmaxes its logits."""
    K = qt.packed_rows or qt.q.shape[0]
    N = qt.q.shape[1]
    M = x.numel() // K
    if not (_decode_ok(M, K, N, qt, resident=True) and vocab_size <= N):
        return None
    if not x.is_cuda:
        return rms_quant_linear_argmax_plain(x, gamma, qt, vocab_size=vocab_size, eps=eps)
    tok = _launch(x, qt, mode="argmax", gamma=gamma, eps=eps, vocab=vocab_size)
    rms_quant_linear_argmax.launches += 1
    return tok.reshape(*x.shape[:-1], 1)


for _f in (rms_quant_linear, quant_linear_residual, rms_quant_linear_swiglu,
           rms_quant_linear_argmax):
    _f.launches = 0
