"""Plain PyTorch ops (counterparts of ``mila_tpu/ops``). Where the JAX op
has a manual VJP (linear, residual, gelu, layer_norm, rms_norm, swiglu,
encoder, softmax, softmax_cross_entropy), the port's is a
``torch.autograd.Function`` with the same backward; so are conv2d (to keep
its backward in true f32 on the card) and embedding_lookup (a segment sum
in a fixed order). The others differentiate through PyTorch's autograd, as
JAX's do through its own. Each op JAX registers in its ``operations``
registry is registered here under the same name."""

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
from mila_tpu_torch.ops.conv import avg_pool2d, conv2d, max_pool2d
from mila_tpu_torch.ops.cross_entropy import cross_entropy_from_probs, softmax_cross_entropy
from mila_tpu_torch.ops.embedding import embedding_lookup, encoder
from mila_tpu_torch.ops.gelu import gelu, gelu_exact, gelu_sigmoid, gelu_tanh
from mila_tpu_torch.ops.layernorm import layer_norm
from mila_tpu_torch.ops.linear import linear, linear_gelu
from mila_tpu_torch.ops.residual import residual
from mila_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_ref
from mila_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_interleaved,
    rope_cos_sin,
    rope_frequencies,
)
from mila_tpu_torch.ops.softmax import log_softmax, softmax
from mila_tpu_torch.ops.swiglu import silu, swiglu
from mila_tpu_torch.utils.registry import operations as _operations

for _name, _fn in {
    "LinearOp": linear,
    "GeluOp": gelu,
    "LayerNormOp": layer_norm,
    "RMSNormOp": rms_norm,
    "AttentionOp": mha_qkv,
    "EncoderOp": encoder,
    "ResidualOp": residual,
    "SoftmaxOp": softmax,
    "SoftmaxCrossEntropyOp": softmax_cross_entropy,
    "SwiGLUOp": swiglu,
    "RoPEOp": apply_rope,
    "FusedOp": linear_gelu,
    "Conv2DOp": conv2d,
}.items():
    if not _operations.contains(_name):
        _operations.register(_name, _fn)

__all__ = [
    "FLASH_MIN_SEQ", "NEG_INF", "apply_rope", "apply_rope_interleaved", "avg_pool2d",
    "causal_mask", "conv2d", "cross_entropy_from_probs", "decode_attention",
    "dot_product_attention", "embedding_lookup", "encoder", "flash_tiles_ok", "gelu",
    "gelu_exact", "gelu_sigmoid", "gelu_tanh",
    "layer_norm", "linear", "linear_gelu", "log_softmax", "max_pool2d", "mha_qkv",
    "resolve_attention_impl", "residual", "rms_norm", "rms_norm_ref", "rope_cos_sin",
    "rope_frequencies", "silu", "softmax", "softmax_cross_entropy", "swiglu",
]
