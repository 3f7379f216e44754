"""GPT-2: encoder, N pre-LN transformer blocks, final LayerNorm and the LM
head, tied to the token table by default (port of ``GPT2Config`` and
``GPT2``'s training forward in ``mila_tpu/models/gpt2.py``; its KV-cache and
paged decode methods are not ported yet).

Parameters are the JAX package's tree: ``encoder/{wte, wpe}``, ``h{i}/{ln1,
qkv, proj, ln2, mlp/{fc1, fc2}}``, ``ln_f``, and ``lm_head`` when untied;
LayerNorm parameters stay f32 whatever ``param_dtype`` is.
"""

from __future__ import annotations

import dataclasses

from mila_tpu_torch import ops
from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.nn import (
    Encoder,
    EncoderConfig,
    LayerNorm,
    LayerNormConfig,
    Linear,
    LinearConfig,
    TransformerBlock,
    TransformerBlockConfig,
)
from mila_tpu_torch.nn.module import CompositeModule, Params
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import split_named


@dataclasses.dataclass(frozen=True)
class GPT2Config(BaseConfig):
    """Architecture config (llm.c's header fields: maxT, V, Vp, L, NH, C)."""

    vocab_size: int = 50257
    padded_vocab_size: int = 0  # 0 -> round up to a multiple of 128
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embedding_dim: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    remat: bool = False
    attention_impl: str = "auto"  # auto | xla | flash

    def validate(self):
        if min(self.vocab_size, self.max_seq_len, self.num_layers, self.num_heads,
               self.embedding_dim) <= 0:
            raise ConfigError("all GPT2 dims must be positive")
        if self.embedding_dim % self.num_heads != 0:
            raise ConfigError("embedding_dim must divide num_heads")

    @property
    def vp(self) -> int:
        """The padded vocabulary (llm.c's Vp)."""
        if self.padded_vocab_size:
            return self.padded_vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config(name="gpt2-124M")

    @staticmethod
    def char_lm(vocab_size: int = 256) -> "GPT2Config":
        return GPT2Config(name="char-lm", vocab_size=vocab_size,
                          padded_vocab_size=max(128, ((vocab_size + 127) // 128) * 128),
                          max_seq_len=256, num_layers=4, num_heads=8, embedding_dim=256,
                          mlp_ratio=4)


class GPT2(CompositeModule):
    def __init__(self, config: GPT2Config):
        super().__init__(config)
        cfg = config
        C = cfg.embedding_dim
        self.add("encoder", Encoder(EncoderConfig(
            name="encoder", vocab_size=cfg.vp, embedding_dim=C, max_seq_len=cfg.max_seq_len,
            param_dtype=cfg.param_dtype)))
        for i in range(cfg.num_layers):
            self.add(f"h{i}", TransformerBlock(TransformerBlockConfig(
                name=f"h{i}", embedding_dim=C, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                dropout=cfg.dropout, param_dtype=cfg.param_dtype, remat=cfg.remat,
                attention_impl=cfg.attention_impl)))
        self.add("ln_f", LayerNorm(LayerNormConfig(name="ln_f", features=C)))
        if not cfg.tie_embeddings:
            self.add("lm_head", Linear(LinearConfig(
                name="lm_head", in_features=C, out_features=cfg.vp, has_bias=False,
                param_dtype=cfg.param_dtype)))

    def init(self, gen, input_shape, device=None) -> Params:
        device = resolve_device(device)
        gens = split_named(gen, *[n for n, _ in self.children()])
        B, T = input_shape
        params: Params = {"encoder": self.get("encoder").init(gens["encoder"], (B, T), device)}
        shape = (B, T, self.config.embedding_dim)
        for name, child in self.children():
            if name != "encoder":
                params[name] = child.init(gens[name], shape, device=device)
        return params

    def apply(self, params, tokens, *, training=False, rngs=None):
        """tokens [B, T] -> logits [B, T, Vp]."""
        x = self.get("encoder").apply(params["encoder"], tokens)
        for i in range(self.config.num_layers):
            x = self.get(f"h{i}").apply(params[f"h{i}"], x, training=training, rngs=rngs)
        x = self.get("ln_f").apply(params["ln_f"], x)
        return self._logits(params, x)

    def _logits(self, params, x):
        if self.config.tie_embeddings:
            return ops.linear(x, params["encoder"]["wte"].t(), None)  # lm_head = wte^T
        return self.get("lm_head").apply(params["lm_head"], x)

    def output_shape(self, input_shape):
        return (*tuple(input_shape), self.config.vp)
