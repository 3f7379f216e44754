"""Plain PyTorch ops, forward only (counterparts of ``mila_tpu/ops``)."""

from mila_tpu_torch.ops.attention import (
    NEG_INF,
    causal_mask,
    decode_attention,
    dot_product_attention,
)
from mila_tpu_torch.ops.linear import linear
from mila_tpu_torch.ops.residual import residual
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from mila_tpu_torch.ops.swiglu import silu, swiglu

__all__ = [
    "NEG_INF", "apply_rope", "causal_mask", "decode_attention", "dot_product_attention",
    "linear",
    "residual", "rms_norm", "rope_cos_sin", "rope_frequencies", "silu", "swiglu",
]
