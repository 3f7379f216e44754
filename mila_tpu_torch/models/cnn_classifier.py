"""The CNN MNIST classifier (port of ``mila_tpu/models/cnn_classifier.py``):
a ``Sequential`` of reshape -> (Conv -> GELU -> Pool) x N -> Flatten ->
fc1 -> GELU -> head, NHWC throughout, with JAX's child and parameter names
(conv1, act1, pool1, ..., flatten, fc1, fc_act, head). Trained through
``Model``, its convolutions and pools run on PyTorch's own (cuDNN on the
card, as JAX leaves them to XLA), its loss on the softmax cross-entropy
kernel (K13) and its update on AdamW's fused kernel (K12), one launch per
leaf.

Export writes what JAX's writes: the class is not in the archive's model
table, so ``export_model`` stores the ``Sequential``'s factory spec, whose
first entry is the reshape ``Lambda``; neither package's
``load_exported`` can rebuild that (no component named 'Lambda')."""

from __future__ import annotations

import dataclasses
from typing import Optional

from mila_tpu_torch.nn import (
    Conv2D,
    Conv2DConfig,
    Flatten,
    Gelu,
    GeluConfig,
    Linear,
    LinearConfig,
    Pool2D,
    Pool2DConfig,
    Sequential,
)
from mila_tpu_torch.nn.module import Lambda
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.registry import models as _models


@dataclasses.dataclass(frozen=True)
class CNNClassifierConfig(BaseConfig):
    image_size: int = 28
    in_channels: int = 1
    conv_channels: tuple = (32, 64)
    hidden_dim: int = 128
    num_classes: int = 10
    param_dtype: str = "float32"

    def validate(self):
        if not self.conv_channels:
            raise ConfigError("need at least one conv layer")


class CNNClassifier(Sequential):
    """Input [B, H*W*C] (flat, like the MLP) or [B, H, W, C]."""

    def __init__(self, config: Optional[CNNClassifierConfig] = None):
        cfg = config or CNNClassifierConfig()
        cfg.validate()
        s = cfg.image_size
        layers = [("reshape", Lambda(lambda x, s=s, c=cfg.in_channels: x.reshape(-1, s, s, c),
                                     name="reshape"))]
        prev, size = cfg.in_channels, s
        for i, ch in enumerate(cfg.conv_channels):
            layers.append((f"conv{i + 1}", Conv2D(Conv2DConfig(
                name=f"conv{i + 1}", in_channels=prev, out_channels=ch, kernel_size=3,
                param_dtype=cfg.param_dtype))))
            layers.append((f"act{i + 1}", Gelu(GeluConfig())))
            layers.append((f"pool{i + 1}", Pool2D(Pool2DConfig(window=2))))
            prev, size = ch, size // 2
        layers.append(("flatten", Flatten()))
        layers.append(("fc1", Linear(LinearConfig(
            name="fc1", in_features=size * size * prev, out_features=cfg.hidden_dim,
            param_dtype=cfg.param_dtype))))
        layers.append(("fc_act", Gelu(GeluConfig())))
        layers.append(("head", Linear(LinearConfig(
            name="head", in_features=cfg.hidden_dim, out_features=cfg.num_classes,
            param_dtype=cfg.param_dtype))))
        super().__init__(layers, cfg)

    def init(self, gen, input_shape, device=None):
        """Shape propagation runs on the image view."""
        cfg = self.config
        return super().init(gen, (input_shape[0], cfg.image_size, cfg.image_size,
                                  cfg.in_channels), device=device)


_models.register("CNNClassifier", CNNClassifier)
