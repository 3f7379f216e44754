"""FP8 -> INT8 weight requantization for the decode weight streams (port of
``mila_tpu/inference/requant.py``).

fp8 and int8 are both one byte per value, so a decode stream gains nothing
in bytes from fp8; the giga pack re-expresses fp8 values on an int8 grid
with the same scale blocks, and its kernel streams int8 tiles only. For
the same QTensor the bytes and scales are bit-identical to the JAX
package's.
"""

from __future__ import annotations

import torch

from mila_tpu_torch.inference.quantize import QTensor

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def requantize_int8(qt: QTensor) -> QTensor:
    """An fp8 QTensor's values on an int8 grid with the same scale-block
    structure; int8 and int4-packed QTensors pass through unchanged."""
    if qt.packed_rows or qt.q.dtype not in _FP8:
        return qt
    v = qt.q.float()  # exact fp8 decode
    K, N = v.shape
    bs = qt.block_size
    vb = v.reshape(K // bs, bs, N)
    m = vb.abs().amax(dim=1, keepdim=True)  # [K // bs, 1, N]
    m = torch.where(m == 0.0, torch.ones_like(m), m)
    q8 = torch.round(vb / m * 127.0).to(torch.int8).reshape(K, N)
    scale = qt.scale * (m[:, 0, :] / 127.0)
    return QTensor(q8, scale.float(), bs, 0)
