"""Weight-only dequant+matmul with bias/activation epilogue: ``quant_linear``.

Replaces the TPU kernel ``mila_tpu/kernels/quant_matmul.py:_qmm_kernel``
(entry ``quant_linear`` -> ``_quant_matmul_2d``). On this path it serves
every prefill projection (M = max_batch * bucket rows, up to 1024).

What bounds it on the H100: at prefill shapes (M >= 256) the product is
bound by tensor-core operations, not by the int8 weight stream. The CUDA
kernel (``csrc/qmm_int8.cu``) tiles 128x128 outputs per block, converts
each int8 weight tile to bf16 once in shared memory (int8 -> bf16 is
exact) and runs bf16 ``mma.sync`` with f32 accumulation, so the weight is
read from device memory once per 128-row block of x.

Arithmetic (the Pallas kernel's, not ``quant_linear_ref``'s): y =
sum over K-blocks of (bf16(x) @ bf16(q))_f32 * scale_row, + bias, then
GELU(tanh)/SiLU, cast to x's dtype. ``quant_linear_plain`` computes the
same on any device; the wrapper takes it only for CPU tensors and mirrors
the JAX dispatch there (shapes that do not tile fall to
``quant_linear_ref``, ``mila_tpu/kernels/quant_matmul.py:402-415``).
"""

from __future__ import annotations

import ctypes
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


def quant_linear_plain(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_linear` (same arithmetic)."""
    quant_linear_plain.calls += 1
    if qt.packed_rows:
        # int4: the reference unpacks to int8 rows for prefill shapes; its
        # nibble kernel computes the same scaled partial sums at decode.
        qt = unpack_int4(qt)
    K, N = qt.q.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if not _tiles_ok(M, K, N, qt):
        out = activate(quant_linear_ref(x2, qt, bias), activation)
        return out.reshape(*x.shape[:-1], N)
    y = scaled_partials(x2.to(torch.bfloat16), qt)
    if bias is not None:
        y = y + bias.float()
    return activate(y, activation).to(x.dtype).reshape(*x.shape[:-1], N)


quant_linear_plain.calls = 0

_ACT_CODES = {None: 0, "gelu": 1, "silu": 2}


def _qmm_lib() -> ctypes.CDLL:
    lib = _build.library("qmm_int8")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmm_int8.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.qmm_int8.restype = ci
        lib._typed = True
    return lib


def _launch(x2: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor],
            activation: Optional[str]) -> torch.Tensor:
    K, N = qt.q.shape
    M = x2.shape[0]
    if qt.packed_rows or qt.q.dtype != torch.int8:
        raise NotImplementedError(
            f"qmm_int8 takes int8 weights; got {qt.q.dtype}"
            f"{' (int4-packed)' if qt.packed_rows else ''}")
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
    b32 = None
    if bias is not None:
        b32 = bias.to(device=x2.device, dtype=torch.float32).contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    lib = _qmm_lib()
    rc = lib.qmm_int8(
        _build.ptr(xb), _build.ptr(qt.q), _build.ptr(qt.scale),
        None if b32 is None else _build.ptr(b32), _build.ptr(out),
        M, N, K, qt.block_size, _ACT_CODES[activation],
        int(x2.dtype == torch.float32), _build.stream_of(x2))
    _build.check(lib, rc, "qmm_int8")
    quant_linear.launches += 1
    return out


def quant_linear(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """Weight-only quantized linear: x [..., K] @ dequant(qt) [K, N] (+bias).

    CUDA tensors launch the ``qmm_int8`` kernel (int8 weights only; other
    weight types raise); CPU tensors take :func:`quant_linear_plain`.
    """
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if not x.is_cuda:
        return quant_linear_plain(x, qt, bias, activation)
    K = qt.packed_rows or qt.q.shape[0]
    out = _launch(x.reshape(-1, K), qt, bias, activation)
    return out.reshape(*x.shape[:-1], qt.q.shape[1])


quant_linear.launches = 0
