"""Concrete layers (port of ``mila_tpu/nn/layers.py``): Linear, Gelu,
LayerNorm, RMSNorm, Attention, Encoder, Residual, Softmax, Dropout and the
softmax cross-entropy loss, each a config-validated binding of an op into
the module system, with the JAX package's parameter names and layouts
(Linear weights [in, out])."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mila_tpu_torch import ops
from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.nn.module import Module, Params
from mila_tpu_torch.tensor import init as tinit
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import split_named


def torch_dtype(name: str) -> torch.dtype:
    """"float32", "bfloat16", ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ConfigError(f"unknown dtype '{name}'")
    return dt


# --------------------------------------------------------------------------
# Linear
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinearConfig(BaseConfig):
    in_features: int = 0
    out_features: int = 0
    has_bias: bool = True
    initializer: str = "xavier_uniform"
    param_dtype: str = "float32"

    def validate(self):
        if self.in_features <= 0 or self.out_features <= 0:
            raise ConfigError(
                f"Linear needs positive dims, got in={self.in_features} out={self.out_features}")
        if self.initializer not in tinit.INITIALIZERS:
            raise ConfigError(f"unknown initializer '{self.initializer}'")


class Linear(Module):
    """y = x @ w (+ b); weight [in, out]. A ``QTensor`` weight (from
    ``inference.quantize``) routes to the quantized kernel."""

    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        cfg: LinearConfig = self.config
        if input_shape[-1] != cfg.in_features:
            raise ValueError(f"{self.name}: input last dim {input_shape[-1]} != in_features "
                             f"{cfg.in_features}")
        dtype = torch_dtype(cfg.param_dtype)
        gens = split_named(gen, "weight", "bias")
        p: Params = {"weight": tinit.INITIALIZERS[cfg.initializer](
            gens["weight"], (cfg.in_features, cfg.out_features), dtype=dtype, device=device)}
        if cfg.has_bias:
            p["bias"] = tinit.zeros((cfg.out_features,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, training=False, rngs=None):
        from mila_tpu_torch.inference.quantize import QTensor

        w = params["weight"]
        if isinstance(w, QTensor):
            from mila_tpu_torch.kernels.quant_matmul import quant_linear

            return quant_linear(x, w, params.get("bias"))
        return ops.linear(x, w, params.get("bias"))

    def output_shape(self, input_shape):
        return (*tuple(input_shape[:-1]), self.config.out_features)


# --------------------------------------------------------------------------
# Gelu
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GeluConfig(BaseConfig):
    approximation: str = "tanh"  # exact | tanh | sigmoid

    def validate(self):
        from mila_tpu_torch.ops.gelu import GELU_VARIANTS

        if self.approximation not in GELU_VARIANTS:
            raise ConfigError(f"unknown GELU approximation '{self.approximation}'")


class Gelu(Module):
    def __init__(self, config: Optional[GeluConfig] = None):
        super().__init__(config or GeluConfig())

    def apply(self, params, x, *, training=False, rngs=None):
        return ops.gelu(x, self.config.approximation)


# --------------------------------------------------------------------------
# LayerNorm / RMSNorm
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerNormConfig(BaseConfig):
    features: int = 0
    eps: float = 1e-5
    param_dtype: str = "float32"

    def validate(self):
        if self.features <= 0:
            raise ConfigError("LayerNorm needs positive features")
        if self.eps <= 0:
            raise ConfigError("eps must be positive")


class LayerNorm(Module):
    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        cfg = self.config
        dtype = torch_dtype(cfg.param_dtype)
        return {"gamma": tinit.ones((cfg.features,), dtype, device),
                "beta": tinit.zeros((cfg.features,), dtype, device)}

    def apply(self, params, x, *, training=False, rngs=None):
        return ops.layer_norm(x, params["gamma"], params["beta"], self.config.eps)


class RMSNorm(Module):
    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        cfg = self.config
        return {"gamma": tinit.ones((cfg.features,), torch_dtype(cfg.param_dtype), device)}

    def apply(self, params, x, *, training=False, rngs=None):
        return ops.rms_norm(x, params["gamma"], self.config.eps)


# --------------------------------------------------------------------------
# Attention (fused QKV [B, T, 3C] -> [B, T, C])
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionConfig(BaseConfig):
    embedding_dim: int = 0
    num_heads: int = 0
    causal: bool = True
    impl: str = "auto"  # auto | xla (the plain product) | flash (the kernel)

    def validate(self):
        if self.embedding_dim <= 0 or self.num_heads <= 0:
            raise ConfigError("Attention needs positive embedding_dim and num_heads")
        if self.embedding_dim % self.num_heads != 0:
            raise ConfigError(f"embedding_dim {self.embedding_dim} not divisible by num_heads "
                              f"{self.num_heads}")


class Attention(Module):
    """Parameter-free causal MHA over fused QKV. The impl resolves as in
    ``ops.attention``: "flash" takes ``flash_mha_qkv`` (the kernel, forward
    and backward, on the card; its plain versions on the CPU) where the
    tiling gate passes the shape, else the plain product ``ops.mha_qkv``,
    as JAX's flash wrapper falls back to its reference."""

    def apply(self, params, x, *, training=False, rngs=None):
        cfg = self.config
        if x.shape[-1] != 3 * cfg.embedding_dim:
            raise ValueError(f"{self.name}: expected fused QKV last dim "
                             f"{3 * cfg.embedding_dim}, got {x.shape[-1]}")
        T = x.shape[1]
        if (ops.resolve_attention_impl(cfg.impl, seq_len=T, device=x.device) == "flash"
                and ops.flash_tiles_ok(T, T, cfg.embedding_dim // cfg.num_heads)):
            from mila_tpu_torch.kernels.flash_attention import flash_mha_qkv

            return flash_mha_qkv(x, cfg.num_heads, causal=cfg.causal)
        return ops.mha_qkv(x, cfg.num_heads, causal=cfg.causal)

    def output_shape(self, input_shape):
        return (*tuple(input_shape[:-1]), self.config.embedding_dim)


# --------------------------------------------------------------------------
# Encoder (wte + wpe)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncoderConfig(BaseConfig):
    vocab_size: int = 0
    embedding_dim: int = 0
    max_seq_len: int = 0  # 0 = no positional table
    init_stddev: float = 0.02
    param_dtype: str = "float32"

    def validate(self):
        if self.vocab_size <= 0 or self.embedding_dim <= 0:
            raise ConfigError("Encoder needs positive vocab_size and embedding_dim")


class Encoder(Module):
    """Token (+ positional) embedding of int token ids [B, T]."""

    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        cfg = self.config
        dtype = torch_dtype(cfg.param_dtype)
        gens = split_named(gen, "wte", "wpe")
        p: Params = {"wte": tinit.normal(gens["wte"], (cfg.vocab_size, cfg.embedding_dim),
                                         cfg.init_stddev, dtype, device)}
        if cfg.max_seq_len > 0:
            p["wpe"] = tinit.normal(gens["wpe"], (cfg.max_seq_len, cfg.embedding_dim),
                                    cfg.init_stddev, dtype, device)
        return p

    def apply(self, params, tokens, *, training=False, rngs=None):
        return ops.encoder(tokens, params["wte"], params.get("wpe"))

    def output_shape(self, input_shape):
        return (*tuple(input_shape), self.config.embedding_dim)


# --------------------------------------------------------------------------
# Residual / Softmax / Dropout
# --------------------------------------------------------------------------

class Residual(Module):
    """y = x + inner(x)."""

    def __init__(self, inner: Module, name: str = ""):
        super().__init__(BaseConfig(name=name or f"residual_{inner.name}"))
        self.inner = inner

    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        return {"inner": self.inner.init(gen, input_shape, device=device)}

    def apply(self, params, x, *, training=False, rngs=None):
        return ops.residual(self.inner.apply(params["inner"], x, training=training, rngs=rngs),
                            x)


@dataclasses.dataclass(frozen=True)
class SoftmaxConfig(BaseConfig):
    axis: int = -1


class Softmax(Module):
    def __init__(self, config: Optional[SoftmaxConfig] = None):
        super().__init__(config or SoftmaxConfig())

    def apply(self, params, x, *, training=False, rngs=None):
        return ops.softmax(x, self.config.axis)


@dataclasses.dataclass(frozen=True)
class DropoutConfig(BaseConfig):
    rate: float = 0.1

    def validate(self):
        if not 0.0 <= self.rate < 1.0:
            raise ConfigError(f"dropout rate must be in [0,1), got {self.rate}")


class Dropout(Module):
    """Inverted dropout; active only when training, with a generator under
    ``rngs["dropout"]`` (the mask is drawn on the generator's device)."""

    def __init__(self, config: Optional[DropoutConfig] = None):
        super().__init__(config or DropoutConfig())

    def apply(self, params, x, *, training=False, rngs=None):
        rate = self.config.rate
        if not training or rate == 0.0:
            return x
        if rngs is None or "dropout" not in rngs:
            raise ValueError("Dropout in training mode needs rngs={'dropout': generator}")
        gen = rngs["dropout"]
        keep = 1.0 - rate
        u = torch.rand(x.shape, generator=gen, device=gen.device)
        mask = (u < keep).to(x.device)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SoftmaxCrossEntropyConfig(BaseConfig):
    ignore_index: int = -100
    reduction: str = "mean"  # mean | sum | none

    def validate(self):
        if self.reduction not in ("mean", "sum", "none"):
            raise ConfigError(f"unknown reduction '{self.reduction}'")


class SoftmaxCrossEntropy(Module):
    """Fused softmax + CE: apply(params, logits, targets=...) -> loss."""

    def __init__(self, config: Optional[SoftmaxCrossEntropyConfig] = None):
        super().__init__(config or SoftmaxCrossEntropyConfig())

    def apply(self, params, logits, *, targets=None, training=False, rngs=None):
        if targets is None:
            raise ValueError("SoftmaxCrossEntropy.apply needs targets=")
        cfg = self.config
        loss = ops.softmax_cross_entropy(logits, targets, cfg.ignore_index)
        if cfg.reduction == "none":
            return loss
        if cfg.reduction == "sum":
            return loss.sum()
        valid = (targets != cfg.ignore_index).float()
        return loss.sum() / torch.clamp(valid.sum(), min=1.0)
