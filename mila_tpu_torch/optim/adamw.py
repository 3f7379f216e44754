"""AdamW with bias correction, decoupled weight decay and stochastic
rounding onto f32 masters (port of ``mila_tpu/optim/adamw.py``).

A functional optimizer over nested-dict parameter trees, as in JAX:
``init(params) -> state`` and ``step(state, params, grads) -> (params',
state')``; the new trees are new tensors, the old ones are left as they
were. Each leaf is updated by ``kernels.fused_adamw.fused_adamw_update``
(kernel table row 17): the CUDA kernel on the card, its plain version on
the CPU. JAX's trainer reaches the same per-leaf function as an XLA fusion
(``tests/kernels/test_fused_kernels.py`` holds the two equal); the port has
no XLA, so it calls the kernel. The global-norm clip is computed plainly
and its factor applied inside the update (``grad_scale``).

Stochastic-rounding noise: JAX draws ``jax.random.bits`` per leaf from
``rng`` (``key(0)`` when none is given). Here ``rng`` is a
``torch.Generator`` and the noise for each bf16 leaf is drawn on its device
(uint16 values in int32); without one, a generator seeded 0 on the
parameters' device is made for the step, as JAX falls back to ``key(0)``.
fp16 parameters draw no noise: the update rounds the f32 master to the
nearest fp16 value, with or without stochastic rounding. That is what
JAX's ``_stochastic_round`` gives on fp16: it steps to the neighbouring
*f32* value and casts back, which is the nearest fp16 value (ROADMAP §C.3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from mila_tpu_torch.kernels.fused_adamw import fused_adamw_update
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Params = Any
Grads = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig(BaseConfig):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # bf16/fp16 params: keep f32 masters and round the updated master back
    # to the storage dtype stochastically.
    stochastic_rounding: bool = False
    grad_clip_norm: float = 0.0  # 0 = off

    def validate(self):
        if self.learning_rate <= 0:
            raise ConfigError(f"learning_rate must be positive, got {self.learning_rate}")
        if not 0 <= self.beta1 < 1 or not 0 <= self.beta2 < 1:
            raise ConfigError("betas must be in [0, 1)")
        if self.eps <= 0:
            raise ConfigError("eps must be positive")
        if self.weight_decay < 0:
            raise ConfigError("weight_decay must be non-negative")


class AdamWState(NamedTuple):
    step: int
    m: Params  # first moments (f32)
    v: Params  # second moments (f32)
    master: Optional[Params]  # f32 masters when stochastic rounding


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))


def _noise(gen: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    bits = torch.randint(0, 1 << 16, p.shape, generator=gen, device=gen.device,
                         dtype=torch.int32)
    return bits.to(p.device)


class AdamW:
    def __init__(self, config: Optional[AdamWConfig] = None):
        self.config = config or AdamWConfig()
        self.config.validate()

    def init(self, params: Params) -> AdamWState:
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        master = None
        if self.config.stochastic_rounding:
            master = tree_map(lambda p: p.detach().float().clone(), params)
        return AdamWState(step=0, m=tree_map(zeros32, params), v=tree_map(zeros32, params),
                          master=master)

    def step(self, state: AdamWState, params: Params, grads: Grads, lr=None,
             rng: Optional[torch.Generator] = None) -> tuple[Params, AdamWState]:
        """One update. ``lr`` is a float or a 0-dim tensor (a schedule's
        value); ``rng`` the generator of the stochastic-rounding noise."""
        cfg = self.config
        lr = cfg.learning_rate if lr is None else float(lr)
        t = int(state.step) + 1
        leaves = tree_leaves(params)
        grad_scale = 1.0
        if cfg.grad_clip_norm > 0:
            gn = global_norm(grads)
            num = torch.tensor(cfg.grad_clip_norm, dtype=torch.float32, device=gn.device)
            grad_scale = float(torch.clamp(num / (gn + 1e-6), max=1.0))
        if rng is None and cfg.stochastic_rounding and leaves:
            rng = torch.Generator(device=leaves[0].device)
            rng.manual_seed(0)
        masters = tree_leaves(state.master) if state.master is not None else [None] * len(leaves)
        out = []
        for p, w, m, v, g in zip(leaves, masters, tree_leaves(state.m), tree_leaves(state.v),
                                 tree_leaves(grads)):
            kw = dict(step=t, lr=lr, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                      weight_decay=cfg.weight_decay, grad_scale=grad_scale)
            noise = (_noise(rng, p) if cfg.stochastic_rounding and p.dtype == torch.bfloat16
                     else None)
            out.append(fused_adamw_update(p, g, m, v, w, noise=noise, **kw))
        p_new, m_new, v_new, w_new = (tree_unflatten(params, [o[i] for o in out])
                                      for i in range(4))
        return p_new, AdamWState(step=t, m=m_new, v=v_new,
                                 master=w_new if state.master is not None else None)

    def get_learning_rate(self) -> float:
        return self.config.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.config = self.config.replace(learning_rate=lr)


def zero_grads(params: Params) -> Grads:
    """A zero gradient tree shaped like ``params``."""
    return tree_map(torch.zeros_like, params)
