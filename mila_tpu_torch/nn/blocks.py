"""Composite blocks (port of ``mila_tpu/nn/blocks.py``): the MLP
(Linear -> [LayerNorm] -> Gelu -> [Dropout] -> Linear) and the pre-LN GPT-2
transformer block.

``remat`` (JAX's ``jax.checkpoint`` of the block under grad) maps to
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the block's
activations are recomputed in the backward instead of kept. A dropout
generator is rewound for the recomputation, so it draws the forward's mask
again, and then set back to where the rest of the step left it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from mila_tpu_torch import ops
from mila_tpu_torch.nn.layers import (
    Attention,
    AttentionConfig,
    Dropout,
    DropoutConfig,
    Gelu,
    GeluConfig,
    LayerNorm,
    LayerNormConfig,
    Linear,
    LinearConfig,
)
from mila_tpu_torch.nn.module import CompositeModule
from mila_tpu_torch.utils.config import BaseConfig, ConfigError


@dataclasses.dataclass(frozen=True)
class MLPConfig(BaseConfig):
    in_features: int = 0
    hidden_features: int = 0
    out_features: int = 0  # 0 -> in_features
    has_bias: bool = True
    use_layernorm: bool = False
    activation: str = "tanh"  # GELU approximation
    dropout: float = 0.0
    param_dtype: str = "float32"

    def validate(self):
        if self.in_features <= 0 or self.hidden_features <= 0:
            raise ConfigError("MLP needs positive in/hidden features")


class MLP(CompositeModule):
    def __init__(self, config: MLPConfig):
        super().__init__(config)
        cfg = config
        self.add("fc1", Linear(LinearConfig(
            name="fc1", in_features=cfg.in_features, out_features=cfg.hidden_features,
            has_bias=cfg.has_bias, param_dtype=cfg.param_dtype)))
        if cfg.use_layernorm:
            self.add("ln", LayerNorm(LayerNormConfig(name="ln", features=cfg.hidden_features)))
        self.add("act", Gelu(GeluConfig(name="act", approximation=cfg.activation)))
        if cfg.dropout > 0:
            self.add("drop", Dropout(DropoutConfig(name="drop", rate=cfg.dropout)))
        self.add("fc2", Linear(LinearConfig(
            name="fc2", in_features=cfg.hidden_features,
            out_features=cfg.out_features or cfg.in_features, has_bias=cfg.has_bias,
            param_dtype=cfg.param_dtype)))

    def apply(self, params, x, *, training=False, rngs=None):
        for name, child in self.children():
            x = child.apply(params.get(name, {}), x, training=training, rngs=rngs)
        return x


@dataclasses.dataclass(frozen=True)
class TransformerBlockConfig(BaseConfig):
    embedding_dim: int = 0
    num_heads: int = 0
    mlp_ratio: int = 4
    dropout: float = 0.0
    param_dtype: str = "float32"
    remat: bool = False  # recompute the block's activations in the backward
    attention_impl: str = "auto"  # auto | xla | flash

    def validate(self):
        if self.embedding_dim <= 0 or self.num_heads <= 0:
            raise ConfigError("TransformerBlock needs positive dims")
        if self.embedding_dim % self.num_heads != 0:
            raise ConfigError("embedding_dim must divide by num_heads")


class TransformerBlock(CompositeModule):
    """Pre-LN GPT-2 block: x += proj(attn(qkv(ln1(x)))); x += mlp(ln2(x))."""

    def __init__(self, config: TransformerBlockConfig):
        super().__init__(config)
        cfg = config
        C = cfg.embedding_dim
        self.add("ln1", LayerNorm(LayerNormConfig(name="ln1", features=C)))
        self.add("qkv", Linear(LinearConfig(name="qkv", in_features=C, out_features=3 * C,
                                            param_dtype=cfg.param_dtype)))
        self.add("attn", Attention(AttentionConfig(name="attn", embedding_dim=C,
                                                   num_heads=cfg.num_heads,
                                                   impl=cfg.attention_impl)))
        self.add("proj", Linear(LinearConfig(name="proj", in_features=C, out_features=C,
                                             param_dtype=cfg.param_dtype)))
        self.add("ln2", LayerNorm(LayerNormConfig(name="ln2", features=C)))
        self.add("mlp", MLP(MLPConfig(name="mlp", in_features=C,
                                      hidden_features=cfg.mlp_ratio * C, out_features=C,
                                      dropout=cfg.dropout, param_dtype=cfg.param_dtype)))

    def apply(self, params, x, *, training=False, rngs=None):
        def body(params, x):
            h = self.get("ln1").apply(params["ln1"], x)
            h = self.get("qkv").apply(params["qkv"], h)
            h = self.get("attn").apply({}, h)
            h = self.get("proj").apply(params["proj"], h)
            x = ops.residual(h, x)
            h = self.get("ln2").apply(params["ln2"], x)
            h = self.get("mlp").apply(params["mlp"], h, training=training, rngs=rngs)
            return ops.residual(h, x)

        if not (self.config.remat and training):
            return body(params, x)
        gen = (rngs or {}).get("dropout")
        if gen is None:
            return checkpoint(body, params, x, use_reentrant=False)
        start, calls = gen.get_state(), [0]

        def replay(params, x):  # the recomputation draws the forward's mask again
            calls[0] += 1
            if calls[0] == 1:
                return body(params, x)
            now = gen.get_state()
            gen.set_state(start)
            try:
                return body(params, x)
            finally:
                gen.set_state(now)

        return checkpoint(replay, params, x, use_reentrant=False)

    def output_shape(self, input_shape):
        return tuple(input_shape)
