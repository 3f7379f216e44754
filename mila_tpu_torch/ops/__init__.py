"""Plain PyTorch ops, forward only (counterparts of ``mila_tpu/ops``)."""

from mila_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    NEG_INF,
    causal_mask,
    decode_attention,
    dot_product_attention,
    flash_tiles_ok,
    resolve_attention_impl,
)
from mila_tpu_torch.ops.linear import linear
from mila_tpu_torch.ops.residual import residual
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from mila_tpu_torch.ops.swiglu import silu, swiglu

__all__ = [
    "FLASH_MIN_SEQ", "NEG_INF", "apply_rope", "causal_mask", "decode_attention",
    "dot_product_attention", "flash_tiles_ok", "linear", "resolve_attention_impl",
    "residual", "rms_norm", "rope_cos_sin", "rope_frequencies", "silu", "swiglu",
]
