"""Weight-only dequant+matmul with bias/activation epilogue: ``quant_linear``.

Replaces the TPU kernel ``mila_tpu/kernels/quant_matmul.py:_qmm_kernel``
(entry ``quant_linear`` -> ``_quant_matmul_2d``). On this path it serves
every prefill projection (M = max_batch * bucket rows).

Packed int4 weights take the JAX package's ``_quant_linear_int4`` route:
shapes its gate passes (M <= 32, a K window of at least 128 packed rows
inside one scale block, M*K*2 <= 1 MB) go to :func:`quant_linear_int4`,
which replaces ``_qmm4_kernel`` (CUDA: ``csrc/qgemv_int4.cu``, counted as
its own entry point); the others (prefill) are unpacked to int8 rows and
take the int8 kernel.

What bounds it on the H100: at prefill shapes (M >= 256) the product is
bound by tensor-core operations once each block's tiles are large enough
that the L2-to-SM traffic keeps up. The CUDA kernel (``csrc/qmm_int8.cu``)
tiles 128x256 outputs per block where that grid covers most of the card,
else (and with block scales) 128x128: one thread keeps TMA loads of x and
the one-byte weight tile in flight through a ring of shared-memory stages,
and two consumer warpgroups run bf16 ``wgmma`` with f32 accumulation while
they convert the next weight tile to bf16 (int8 and fp8 -> bf16 are exact,
so fp8 weights take the QTensor's scales as they are), so the weight is
read from device memory once per 128-row block of x. The wrapper needs x's
bf16 copy and the weight on 16-byte-aligned bases (TMA); it copies either
one that is not.

Arithmetic (the Pallas kernel's, not ``quant_linear_ref``'s): y =
sum over K-blocks of (bf16(x) @ bf16(q))_f32 * scale_row, + bias, then
GELU(tanh)/SiLU, cast to x's dtype. ``quant_linear_plain`` computes the
same on any device; the wrapper takes it only for CPU tensors and mirrors
the JAX dispatch there (shapes that do not tile fall to
``quant_linear_ref``, ``mila_tpu/kernels/quant_matmul.py:402-415``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from mila_tpu_torch.inference.quantize import QTensor, quant_linear_ref, unpack_int4
from mila_tpu_torch.kernels import _build

# Block choice of the JAX package for decode shapes (M <= 32), mirrored so
# that the CPU path takes the same arithmetic branch as the reference.
_DECODE_BLOCKS: dict[tuple[int, int], tuple[int, int]] = {
    (2048, 3072): (1024, 2048),
    (2048, 2048): (1024, 1024),
    (2048, 16384): (1024, 2048),
    (2048, 8192): (1024, 2048),
    (8192, 2048): (1024, 2048),
    (2048, 129024): (1536, 2048),
}
_DECODE_TILE_BYTES = 4 * 1024 * 1024


def _pick_blocks(M: int, K: int, N: int, block_n: int, block_k: int,
                 qblock: int, budget: int = _DECODE_TILE_BYTES):
    """Mirror of ``mila_tpu.kernels.quant_matmul._pick_blocks``."""
    if M > 32:
        return block_n, block_k
    hit = _DECODE_BLOCKS.get((K, N))
    if hit is not None and hit[1] <= qblock and qblock % hit[1] == 0:
        bn, bk = hit
        while bn > 128 and bn * bk > budget:
            bn //= 2
        if N % bn == 0 and bn * bk <= budget:
            return bn, bk
    bk = min(2048, qblock)
    while bk >= 128 and (K % bk or qblock % bk):
        bk //= 2
    if bk < 128:
        return block_n, block_k
    for bn in (4096, 3072, 2048, 1536, 1024, 512, 256):
        if N % bn == 0 and bn * bk <= budget:
            return bn, bk
    return block_n, block_k


def activate(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return y * torch.sigmoid(y)
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def scaled_partials(xb: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """f32 [M, N]: sum over K-blocks of (xb @ bf16(q))_block * scale_row,
    with xb already rounded to bf16 (any float dtype holding those values)."""
    K, N = qt.q.shape
    bs = qt.block_size
    nb = K // bs
    x32 = xb.float().reshape(-1, nb, bs)
    w32 = qt.q.to(torch.bfloat16).float().reshape(nb, bs, N)
    if nb == 1:
        return torch.matmul(x32[:, 0], w32[0]) * qt.scale[0]
    part = torch.einsum("mjk,jkn->mjn", x32, w32)
    return (part * qt.scale[None]).sum(dim=1)


def _tiles_ok(M: int, K: int, N: int, qt: QTensor) -> bool:
    """Whether the JAX ``quant_linear`` takes its Pallas kernel (True) or
    its ``quant_linear_ref`` fallback (False) at this shape."""
    block_n, block_k = _pick_blocks(M, K, N, 1024, 512, qt.block_size)
    bm, bn, bk = min(256, M), min(block_n, N), min(block_k, K)
    while M % bm:
        bm //= 2
    while N % bn:
        bn //= 2
    while K % bk:
        bk //= 2
    return (bm >= 8 and bn >= 128 and bk >= 128 and qt.block_size % bk == 0
            and qt.q.element_size() == 1)


def _int4_blocks(M: int, K: int, N: int, qblock: int) -> tuple[bool, int]:
    """Mirror of the gate of ``mila_tpu.kernels.quant_matmul._quant_linear_int4``:
    (whether its nibble kernel takes this shape, its packed-row K window)."""
    Kp = K // 2
    bkp = min(2048, Kp)
    while bkp >= 128 and (Kp % bkp or qblock % bkp):
        bkp //= 2
    bn = 1024
    for cand in (4096, 3072, 2048, 1536, 1024, 512, 256):
        if N % cand == 0 and cand * bkp <= _DECODE_TILE_BYTES:
            bn = cand
            break
    ok = M <= 32 and bkp >= 128 and N % bn == 0 and M * K * 2 <= 1024 * 1024
    return ok, bkp


def _epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
              activation: Optional[str]) -> torch.Tensor:
    """The int4 route's bias and activation, applied to the kernel's output
    as the JAX package applies them outside its nibble kernel."""
    if bias is not None:
        out = (out.float() + bias.float()).to(out.dtype)
    return activate(out, activation)


def quant_linear_int4_plain(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version of :func:`quant_linear_int4`: ``_qmm4_kernel``'s
    arithmetic. For each window of ``bkp`` packed rows, the low and high
    halves' products (bf16 operands, f32 sums) times their scale rows,
    summed over windows, cast to x's dtype."""
    quant_linear_int4_plain.calls += 1
    M, K = x2.shape
    Kp, N = qt.q.shape
    _, bkp = _int4_blocks(M, K, N, qt.block_size)
    nw = Kp // bkp
    b = qt.q.to(torch.int32)
    lo, hi = (b << 28) >> 28, (b << 24) >> 28  # sign-extended low and high nibbles
    xb = x2.to(torch.bfloat16).float()
    x_lo, x_hi = xb[:, :Kp].reshape(M, nw, bkp), xb[:, Kp:].reshape(M, nw, bkp)
    win = torch.arange(nw, device=x2.device) * bkp
    s_lo = qt.scale[win // qt.block_size]  # [nw, N]
    s_hi = qt.scale[(Kp + win) // qt.block_size]
    p_lo = torch.einsum("mjk,jkn->mjn", x_lo, lo.float().reshape(nw, bkp, N))
    p_hi = torch.einsum("mjk,jkn->mjn", x_hi, hi.float().reshape(nw, bkp, N))
    return (p_lo * s_lo[None] + p_hi * s_hi[None]).sum(dim=1).to(x2.dtype)


quant_linear_int4_plain.calls = 0


def _route(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor],
           activation: Optional[str], int4, int8) -> torch.Tensor:
    """The JAX ``quant_linear``'s routing, for the wrapper and its plain
    version alike: packed int4 weights at a shape the int4 gate passes go to
    ``int4(x2, qt)`` and the epilogue; others (prefill) are unpacked to
    int8 rows; int8 rows go to ``int8(x2, qt, bias, activation)``."""
    K, N = qt.packed_rows or qt.q.shape[0], qt.q.shape[1]
    x2 = x.reshape(-1, K)
    if qt.packed_rows:
        if _int4_blocks(x2.shape[0], K, N, qt.block_size)[0]:
            out = _epilogue(int4(x2, qt), bias, activation)
            return out.reshape(*x.shape[:-1], N)
        qt = unpack_int4(qt)
    return int8(x2, qt, bias, activation).reshape(*x.shape[:-1], N)


def _int8_plain(x2: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor],
                activation: Optional[str]) -> torch.Tensor:
    K, N = qt.q.shape
    if not _tiles_ok(x2.shape[0], K, N, qt):
        return activate(quant_linear_ref(x2, qt, bias), activation)
    y = scaled_partials(x2.to(torch.bfloat16), qt)
    if bias is not None:
        y = y + bias.float()
    return activate(y, activation).to(x2.dtype)


def quant_linear_plain(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_linear` (same arithmetic)."""
    quant_linear_plain.calls += 1
    return _route(x, qt, bias, activation, quant_linear_int4_plain, _int8_plain)


quant_linear_plain.calls = 0

_ACT_CODES = {None: 0, "gelu": 1, "silu": 2}
# One-byte weight formats of the CUDA kernels (their wfmt argument, WFMT_* in
# csrc/gemv.cuh): each converts its weights exactly to bf16 operands.
WFMT = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


def _qmm_lib() -> ctypes.CDLL:
    lib = _build.library("qmm_int8")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmm_int8.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.qmm_int8.restype = ci
        lib._typed = True
    return lib


def _launch(x2: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor],
            activation: Optional[str]) -> torch.Tensor:
    K, N = qt.q.shape
    M = x2.shape[0]
    if qt.packed_rows or qt.q.dtype not in WFMT:  # int4 is unpacked before
        raise NotImplementedError(f"qmm_int8 takes int8 or fp8 weights; got {qt.q.dtype}")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm_int8 takes bf16/f32 activations, got {x2.dtype}")
    if K % 32 or N % 8 or qt.block_size % 16:
        raise ValueError(f"qmm_int8 needs K % 32 == 0, N % 8 == 0 and block_size "
                         f"% 16 == 0 (K={K}, N={N}, block_size={qt.block_size})")
    for t in (qt.q, qt.scale):
        if not (t.is_cuda and t.is_contiguous() and t.device == x2.device):
            raise ValueError("qmm_int8: weights must be contiguous on x's device")
    if qt.scale.dtype != torch.float32:
        raise TypeError("qmm_int8: scales must be f32")
    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # TMA reads from 16-byte-aligned bases only
        xb = xb.clone()
    wq = qt.q if qt.q.data_ptr() % 16 == 0 else qt.q.clone()
    b32 = None
    if bias is not None:
        b32 = bias.to(device=x2.device, dtype=torch.float32).contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    lib = _qmm_lib()
    rc = lib.qmm_int8(
        _build.ptr(xb), _build.ptr(wq), _build.ptr(qt.scale),
        None if b32 is None else _build.ptr(b32), _build.ptr(out),
        M, N, K, qt.block_size, _ACT_CODES[activation],
        int(x2.dtype == torch.float32), WFMT[qt.q.dtype], _build.stream_of(x2))
    _build.check(lib, rc, "qmm_int8")
    quant_linear.launches += 1
    return out


INT4_COLS = 256  # output columns per block of qgemv_int4
INT4_STAGE_ROWS = 32  # packed rows per stage (and per slice's multiple)
INT4_RING_BYTES = 8 * INT4_STAGE_ROWS * (INT4_COLS + 32)  # the kernel's ring of 8 stages
INT4_RECV_BYTES = 8 * 4 * INT4_COLS * 4  # the K slices' receive buffer at M 32
INT4_X_BYTES = 72 * 1024  # staged x pairs per block
INT4_MIN_ROWS = 64  # packed rows a slice keeps at least (unless x's stage forces fewer)
INT4_MAX_SLICES = 8  # the slices of a column tile form one cluster: 8 blocks at most


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _int4_x_bytes(M: int, kc: int) -> int:
    """Shared memory of x's staged bf16 pairs for kc packed rows: 8 rows of
    x per n-tile of the mma (M <= 8, 16 or 32 take 1, 2 or 4)."""
    return 8 * (1 if M <= 8 else 2 if M <= 16 else 4) * (kc + 4) * 4


def _plan_int4(M: int, K: int, N: int, block_size: int, sms: int) -> tuple[int, int]:
    """(ksplit, win) for ``qgemv_int4``: ksplit slices of kc = K/2 / ksplit
    packed rows (one cluster of at most ``INT4_MAX_SLICES`` blocks per
    column tile), doubled while the grid of N / 256 column tiles x ksplit
    stays within one block per SM (a slice keeping ``INT4_MIN_ROWS`` rows),
    and until x's staged slice fits ``INT4_X_BYTES``. (Clusters past one
    block per SM measured slower: wgu at M 8 took 19.6 us at ksplit 4
    against 14.1 at 2.) win is the JAX gate's window of packed rows (inside
    one scale block for both halves), over which the kernel sums before it
    scales."""
    Kp = K // 2
    ok, win = _int4_blocks(M, K, N, block_size)
    tiles = N // INT4_COLS
    ks = 1
    while (ks < INT4_MAX_SLICES and Kp % (2 * ks) == 0
           and (Kp // (2 * ks)) % INT4_STAGE_ROWS == 0 and (
               _int4_x_bytes(M, Kp // ks) > INT4_X_BYTES
               or (tiles * 2 * ks <= sms and Kp // (2 * ks) >= INT4_MIN_ROWS))):
        ks *= 2
    kc = Kp // ks
    if (not ok or not 1 <= M <= 32 or N % INT4_COLS or kc % INT4_STAGE_ROWS
            or win % INT4_STAGE_ROWS or _int4_x_bytes(M, kc) > INT4_X_BYTES):
        raise ValueError(f"qgemv_int4 cannot tile M={M}, K={K}, N={N} "
                         f"(block_size={block_size})")
    return ks, win


def _int4_lib() -> ctypes.CDLL:
    lib = _build.library("qgemv_int4")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qgemv_int4.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.qgemv_int4.restype = ci
        lib._typed = True
    return lib


def quant_linear_int4(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x2 [M, K] @ dequant(qt) for packed int4 ``qt`` ([K/2, N]) at a shape
    the int4 gate passes, in x2's dtype (no bias or activation: the caller
    applies them, as JAX's ``_quant_linear_int4`` does).

    CUDA tensors launch ``qgemv_int4``; CPU tensors take
    :func:`quant_linear_int4_plain`."""
    if not x2.is_cuda:
        return quant_linear_int4_plain(x2, qt)
    M, K = x2.shape
    N = qt.q.shape[1]
    if not qt.packed_rows or qt.q.dtype != torch.int8 or K != qt.packed_rows:
        raise ValueError("qgemv_int4 takes int4-packed weights [K/2, N] int8")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qgemv_int4 takes bf16/f32 activations, got {x2.dtype}")
    if not 0 < M <= 32:
        raise ValueError(f"qgemv_int4 is a decode kernel: 1 <= M <= 32, got M={M}")
    if qt.scale.dtype != torch.float32:
        raise TypeError("qgemv_int4: scales must be f32")
    for t in (qt.q, qt.scale):
        if not (t.is_cuda and t.is_contiguous() and t.device == x2.device):
            raise ValueError("qgemv_int4: weights must be contiguous on x's device")
    if qt.q.data_ptr() % 16 or qt.scale.data_ptr() % 16:
        raise ValueError("qgemv_int4: weights and scales must be 16-byte aligned "
                         "(16-byte copies and loads)")
    ks, win = _plan_int4(M, K, N, qt.block_size, _sm_count(x2.device.index or 0))
    xc = x2.contiguous()
    if xc.data_ptr() % 16:  # the kernel stages x by 16-byte loads
        xc = xc.clone()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    lib = _int4_lib()
    rc = lib.qgemv_int4(
        _build.ptr(xc), _build.ptr(qt.q), _build.ptr(qt.scale), _build.ptr(out), M, N, K,
        qt.block_size, ks, win, int(x2.dtype == torch.float32), _build.stream_of(x2))
    _build.check(lib, rc, "qgemv_int4")
    quant_linear_int4.launches += 1
    return out


quant_linear_int4.launches = 0


def quant_linear(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """Weight-only quantized linear: x [..., K] @ dequant(qt) [K, N] (+bias).

    CUDA tensors launch ``qmm_int8`` for int8 and fp8 (e4m3fn, e5m2)
    weights, and for packed int4 weights either ``qgemv_int4`` (shapes the
    int4 gate passes) or, after ``unpack_int4``, ``qmm_int8``; other weight
    types raise. CPU tensors take :func:`quant_linear_plain`.
    """
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if not x.is_cuda:
        return quant_linear_plain(x, qt, bias, activation)
    return _route(x, qt, bias, activation, quant_linear_int4, _launch)


quant_linear.launches = 0
