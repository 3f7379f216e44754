"""SGD with momentum and Nesterov (port of ``mila_tpu/optim/sgd.py``): the
same functional ``init``/``step`` contract as AdamW, over nested-dict
trees of tensors. JAX computes it in XLA with no Pallas kernel; here it is
a few plain tensor operations per leaf, with f32 velocities."""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class SGDConfig(BaseConfig):
    learning_rate: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def validate(self):
        if self.learning_rate <= 0:
            raise ConfigError("learning_rate must be positive")
        if not 0 <= self.momentum < 1:
            raise ConfigError("momentum must be in [0,1)")


class SGDState(NamedTuple):
    step: int
    velocity: Any  # f32, shaped like the params


class SGD:
    def __init__(self, config: Optional[SGDConfig] = None):
        self.config = config or SGDConfig()
        self.config.validate()

    def init(self, params) -> SGDState:
        return SGDState(step=0, velocity=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    def step(self, state: SGDState, params, grads, lr=None, rng=None):
        """One update (``rng`` is accepted for the trainer's call and not read)."""
        cfg = self.config
        lr = cfg.learning_rate if lr is None else float(lr)
        new_p, new_v = [], []
        for p, v, g in zip(tree_leaves(params), tree_leaves(state.velocity), tree_leaves(grads)):
            p32 = p.float()
            g32 = g.float() + cfg.weight_decay * p32
            v_new = cfg.momentum * v + g32
            d = g32 + cfg.momentum * v_new if cfg.nesterov else v_new
            new_p.append((p32 - lr * d).to(p.dtype))
            new_v.append(v_new)
        return tree_unflatten(params, new_p), SGDState(step=int(state.step) + 1,
                                                       velocity=tree_unflatten(params, new_v))

    def get_learning_rate(self) -> float:
        return self.config.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.config = self.config.replace(learning_rate=lr)
