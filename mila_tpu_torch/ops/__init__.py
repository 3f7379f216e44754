"""Plain PyTorch ops (counterparts of ``mila_tpu/ops``). Where the JAX op
has a manual VJP (linear, residual, gelu, layer_norm, encoder, softmax,
softmax_cross_entropy), the port's is a ``torch.autograd.Function`` with
the same backward; the others are forward only or differentiate through
PyTorch's autograd, as JAX's do through its own."""

from mila_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    NEG_INF,
    causal_mask,
    decode_attention,
    dot_product_attention,
    flash_tiles_ok,
    mha_qkv,
    resolve_attention_impl,
)
from mila_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from mila_tpu_torch.ops.embedding import encoder
from mila_tpu_torch.ops.gelu import gelu
from mila_tpu_torch.ops.layernorm import layer_norm
from mila_tpu_torch.ops.linear import linear
from mila_tpu_torch.ops.residual import residual
from mila_tpu_torch.ops.rmsnorm import rms_norm
from mila_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from mila_tpu_torch.ops.softmax import softmax
from mila_tpu_torch.ops.swiglu import silu, swiglu

__all__ = [
    "FLASH_MIN_SEQ", "NEG_INF", "apply_rope", "causal_mask", "decode_attention",
    "dot_product_attention", "encoder", "flash_tiles_ok", "gelu", "layer_norm", "linear",
    "mha_qkv", "resolve_attention_impl", "residual", "rms_norm", "rope_cos_sin",
    "rope_frequencies", "silu", "softmax", "softmax_cross_entropy", "swiglu",
]
