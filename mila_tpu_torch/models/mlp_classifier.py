"""The MNIST MLP classifier (port of ``mila_tpu/models/mlp_classifier.py``):
784 -> Linear(128) -> GELU -> Linear(64) -> GELU -> Linear(10), a
``Sequential`` with JAX's child and parameter names (fc1, act1, fc2, act2,
head). Trained through ``Model``, its loss is ``ops.softmax_cross_entropy``
(K13 on the card) and its update AdamW's fused kernel (K12), one launch per
leaf."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mila_tpu_torch.nn import Gelu, GeluConfig, Linear, LinearConfig, Sequential
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.registry import models as _models


@dataclasses.dataclass(frozen=True)
class MLPClassifierConfig(BaseConfig):
    input_dim: int = 784
    hidden_dims: tuple = (128, 64)
    num_classes: int = 10
    activation: str = "tanh"  # GELU approximation
    param_dtype: str = "float32"

    def validate(self):
        if self.input_dim <= 0 or self.num_classes <= 0:
            raise ConfigError("positive dims required")
        if not self.hidden_dims:
            raise ConfigError("need at least one hidden layer")


class MLPClassifier(Sequential):
    """input_dim -> hidden_dims (GELU after each) -> num_classes."""

    def __init__(self, config: Optional[MLPClassifierConfig] = None):
        cfg = config or MLPClassifierConfig()
        cfg.validate()
        dims = [cfg.input_dim, *cfg.hidden_dims]
        layers = []
        for i in range(len(dims) - 1):
            layers.append((f"fc{i + 1}", Linear(LinearConfig(
                name=f"fc{i + 1}", in_features=dims[i], out_features=dims[i + 1],
                param_dtype=cfg.param_dtype))))
            layers.append((f"act{i + 1}", Gelu(GeluConfig(approximation=cfg.activation))))
        layers.append(("head", Linear(LinearConfig(
            name="head", in_features=dims[-1], out_features=cfg.num_classes,
            param_dtype=cfg.param_dtype))))
        super().__init__(layers, cfg)


def accuracy(logits, targets) -> float:
    """The share of rows whose argmax is the target."""
    logits = logits if isinstance(logits, torch.Tensor) else torch.as_tensor(np.asarray(logits))
    pred = logits.argmax(dim=-1).cpu().numpy()
    targets = targets.cpu().numpy() if isinstance(targets, torch.Tensor) else np.asarray(targets)
    return float((pred == targets).mean())


_models.register("MLPClassifier", MLPClassifier)
