"""Weight-only quantization: INT8/FP8/INT4 with per-channel or block scales
(port of ``mila_tpu/inference/quantize.py``).

Layout: weight [in, out] quantized along ``in`` (the contraction axis) in
blocks of ``block_size`` rows sharing one f32 scale -> scales [n_blocks, out].
For the same weight the q bytes and scales are bit-identical to the JAX
package's: the same f32 division, and ``torch.round`` rounds half to even
like ``jnp.round``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.runtime.memory import tree_nbytes


class QTensor(NamedTuple):
    """Quantized weight: q [in, out] int8/fp8 (int4 nibble-packed into int8
    [in//2, out] when ``packed_rows`` > 0), scale [n_blocks, out] f32."""

    q: torch.Tensor
    scale: torch.Tensor
    block_size: int
    packed_rows: int = 0

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device),
                       self.block_size, self.packed_rows)


QUANT_DTYPES = {
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "int4": "int4",  # stored nibble-packed in int8
}


def _qmax(dtype) -> float:
    if dtype == torch.int8:
        return 127.0
    if dtype == "int4":
        return 7.0
    return float(torch.finfo(dtype).max)  # 448 for e4m3, 57344 for e5m2


def quantize(w: torch.Tensor, dtype="int8", block_size: int = 0) -> QTensor:
    """Symmetric absmax quantization of a [in, out] weight along ``in``."""
    qdt = QUANT_DTYPES[dtype] if isinstance(dtype, str) else dtype
    In, Out = w.shape
    bs = block_size if block_size > 0 else In
    if In % bs != 0:
        raise ValueError(f"in dim {In} not divisible by block_size {bs}")
    w32 = w.float().reshape(In // bs, bs, Out)
    absmax = w32.abs().amax(dim=1)  # [n_blocks, out]
    qmax = _qmax(qdt)
    scale = torch.clamp_min(absmax / qmax, 1e-12)
    scaled = w32 / scale[:, None, :]
    if qdt == "int4":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
        return pack_int4(QTensor(q.reshape(In, Out), scale, bs))
    if qdt == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(qdt)
    return QTensor(q.reshape(In, Out), scale, bs)


def unit_qtensor(w: torch.Tensor) -> QTensor:
    """A plain weight matrix as a bf16 QTensor with unit scales, so the
    decode stream packers carry bf16 tiles through the same code."""
    w = w.to(torch.bfloat16)
    K, N = w.shape
    return QTensor(w, torch.ones((1, N), dtype=torch.float32, device=w.device), K, 0)


def pack_int4(qt: QTensor) -> QTensor:
    """Two signed nibbles per byte, split-halves layout: byte row r holds
    value row r (low nibble) and row r + K/2 (high nibble)."""
    if qt.packed_rows:
        return qt
    K = qt.q.shape[0]
    if K % 2:
        raise ValueError("int4 packing needs an even in-dim")
    v = qt.q.to(torch.int32)
    lo = v[: K // 2] & 0xF
    hi = v[K // 2:] & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return QTensor(packed, qt.scale, qt.block_size, K)


def unpack_int4(qt: QTensor) -> QTensor:
    """Inverse of :func:`pack_int4` (int4-valued int8 rows)."""
    if not qt.packed_rows:
        return qt
    b = qt.q.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8  # sign-extend the low nibble
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    full = torch.cat([lo, hi], dim=0).to(torch.int8)
    return QTensor(full, qt.scale, qt.block_size, 0)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    if qt.packed_rows:
        qt = unpack_int4(qt)
    In, Out = qt.q.shape
    bs = qt.block_size
    q32 = qt.q.reshape(In // bs, bs, Out).float()
    return (q32 * qt.scale[:, None, :]).reshape(In, Out).to(dtype)


def quant_linear_ref(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Reference dequant+matmul: dequantize to the compute dtype first, then
    one product accumulated in f32 (not the kernels' arithmetic, which
    scales f32 partial sums; see ``kernels/quant_matmul.py``)."""
    w = dequantize(qt, compute_dtype)
    y = torch.matmul(x.to(compute_dtype).float(), w.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def quantization_error(w: torch.Tensor, dtype="int8", block_size: int = 0) -> float:
    """Relative RMS error of quantize then dequantize (a diagnostic)."""
    back = dequantize(quantize(w, dtype, block_size))
    w32 = w.float()
    err = torch.sqrt(torch.mean((back - w32) ** 2))
    rms = torch.sqrt(torch.mean(w32 ** 2))
    return float(err / (rms + 1e-12))


def quantize_model_params(params: Any, dtype: str = "int8", block_size: int = 0,
                          min_size: int = 4096,
                          skip_names: tuple = ("wte", "wpe", "gamma", "beta", "bias"),
                          device=None) -> Any:
    """Quantize every 2-D 'weight' leaf of a params dict to a QTensor, on
    ``device`` (the GPU unless told otherwise). Embeddings, norms and biases
    stay high-precision."""
    dev = resolve_device(device)

    def visit(names: list, leaf):
        if isinstance(leaf, dict):
            return {k: visit(names + [k], v) for k, v in leaf.items()}
        if isinstance(leaf, QTensor) or not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.to(dev)
        name = names[-1] if names else ""
        if (name == "weight" and leaf.ndim == 2 and leaf.numel() >= min_size
                and not any(s in names for s in skip_names)):
            return quantize(leaf, dtype, block_size)
        return leaf

    return visit([], params)


def model_bytes(params: Any) -> int:
    """Total parameter bytes of a params tree, QTensors' q and scales
    included (int4 q is stored packed, two values a byte)."""
    return tree_nbytes(params)
