"""Conv2D and pooling layers in NHWC (port of ``mila_tpu/nn/conv.py``):
``Conv2D`` holds He-normal HWIO weights [KH, KW, Cin, Cout] and a zero
bias, the JAX package's parameter names; ``Pool2D`` and ``Flatten`` hold
none."""

from __future__ import annotations

import dataclasses
from typing import Optional

from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.nn.layers import torch_dtype
from mila_tpu_torch.nn.module import Module
from mila_tpu_torch.ops.conv import avg_pool2d, conv2d, max_pool2d
from mila_tpu_torch.tensor import init as tinit
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import split_named


@dataclasses.dataclass(frozen=True)
class Conv2DConfig(BaseConfig):
    in_channels: int = 0
    out_channels: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: str = "SAME"
    has_bias: bool = True
    param_dtype: str = "float32"

    def validate(self):
        if self.in_channels <= 0 or self.out_channels <= 0:
            raise ConfigError("Conv2D needs positive channel counts")
        if self.padding not in ("SAME", "VALID"):
            raise ConfigError("padding must be SAME or VALID")


class Conv2D(Module):
    """NHWC convolution; weights [KH, KW, Cin, Cout] (HWIO)."""

    def init(self, gen, input_shape, device=None):
        device = resolve_device(device)
        cfg = self.config
        if input_shape[-1] != cfg.in_channels:
            raise ValueError(f"{self.name}: input channels {input_shape[-1]} != "
                             f"{cfg.in_channels}")
        dtype = torch_dtype(cfg.param_dtype)
        gens = split_named(gen, "weight", "bias")
        p = {"weight": tinit.he_normal(
            gens["weight"], (cfg.kernel_size, cfg.kernel_size, cfg.in_channels,
                             cfg.out_channels), dtype=dtype, device=device)}
        if cfg.has_bias:
            p["bias"] = tinit.zeros((cfg.out_channels,), dtype, device)
        return p

    def apply(self, params, x, *, training=False, rngs=None):
        cfg = self.config
        return conv2d(x, params["weight"], params.get("bias"), stride=cfg.stride,
                      padding=cfg.padding)

    def output_shape(self, input_shape):
        cfg = self.config
        B, H, W, _ = input_shape
        if cfg.padding == "SAME":
            oh, ow = -(-H // cfg.stride), -(-W // cfg.stride)
        else:
            oh = (H - cfg.kernel_size) // cfg.stride + 1
            ow = (W - cfg.kernel_size) // cfg.stride + 1
        return (B, oh, ow, cfg.out_channels)


@dataclasses.dataclass(frozen=True)
class Pool2DConfig(BaseConfig):
    window: int = 2
    stride: int = 0  # 0 -> window
    kind: str = "max"  # max | avg

    def validate(self):
        if self.kind not in ("max", "avg"):
            raise ConfigError("pool kind must be max or avg")


class Pool2D(Module):
    def __init__(self, config: Optional[Pool2DConfig] = None):
        super().__init__(config or Pool2DConfig())

    def apply(self, params, x, *, training=False, rngs=None):
        cfg = self.config
        fn = max_pool2d if cfg.kind == "max" else avg_pool2d
        return fn(x, cfg.window, cfg.stride or None)

    def output_shape(self, input_shape):
        cfg = self.config
        s = cfg.stride or cfg.window
        B, H, W, C = input_shape
        return (B, (H - cfg.window) // s + 1, (W - cfg.window) // s + 1, C)


class Flatten(Module):
    """[B, ...] -> [B, prod(...)]."""

    def apply(self, params, x, *, training=False, rngs=None):
        return x.reshape(x.shape[0], -1)

    def output_shape(self, input_shape):
        n = 1
        for s in input_shape[1:]:
            n *= int(s)
        return (input_shape[0], n)
