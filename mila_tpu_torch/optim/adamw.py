"""AdamW with bias correction, decoupled weight decay and stochastic
rounding onto f32 masters (port of ``mila_tpu/optim/adamw.py``).

A functional optimizer over nested-dict parameter trees, as in JAX:
``init(params) -> state`` and ``step(state, params, grads) -> (params',
state')``; the new trees are new tensors, the old ones are left as they
were. The update is ``kernels.fused_adamw`` (kernel table row 17): on the
card the clip's global norm is one launch (``grad_clip_scale``, its factor
left on the device) and every leaf's update one launch per (param dtype,
grad dtype) group (``fused_adamw_step``), with no host sync; on the CPU
their plain versions. A CUDA graph captured over ``step`` replays that one
step (its count and learning rate, and a key given as words on the
host, are captured as values), so it serves to time a step, not to run a
sequence of them. JAX's trainer reaches the same per-leaf function as an
XLA fusion (``tests/kernels/test_fused_kernels.py`` holds the two equal);
the port has no XLA, so it calls the kernels.

Stochastic-rounding noise is JAX's: the step key gives each leaf
``split(key, n)[j]`` (``j`` the leaf's index in JAX's tree order, which
sorts dict keys) and each bf16 leaf ``bits(leaf_key, shape) & 0xffff``,
drawn inside the kernel. ``rng``: None is JAX's ``key(0)``, as JAX's AdamW
falls back to it; a 2-word integer tensor is a key's words
(``jax.random.key_data``); a ``torch.Generator`` draws the two words of a
fresh key on its device each step. With the same key and equal masters the
rounded params equal JAX's bit for bit. fp16 parameters draw nothing: the
update rounds the f32 master to the nearest fp16 value, with or without
stochastic rounding. That is what JAX's ``_stochastic_round`` gives on
fp16: it steps to the neighbouring *f32* value and casts back, which is the
nearest fp16 value (ROADMAP §C.3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import torch

from mila_tpu_torch.kernels.fused_adamw import (  # global_norm: the optimizer's public name
    fused_adamw_step,
    global_norm,
    grad_clip_scale,
)
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.tree import (
    sorted_leaf_index,
    tree_leaves,
    tree_leaves_like,
    tree_map,
    tree_unflatten,
)

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


def step_key(rng: Union[None, torch.Tensor, torch.Generator]):
    """The step key ``AdamW.step`` hands the kernel: None (JAX's ``key(0)``),
    a key's two words as given, or two words a generator draws on its
    device (int32 bits)."""
    if isinstance(rng, torch.Generator):
        return torch.randint(-1 << 31, 1 << 31, (2,), generator=rng, device=rng.device,
                             dtype=torch.int32)
    return rng


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
             rng: Union[None, torch.Tensor, torch.Generator] = None
             ) -> tuple[Params, AdamWState]:
        """One update. ``lr`` is a float or a 0-dim CPU tensor (a schedule's
        value); ``rng`` the stochastic rounding's key (:func:`step_key`)."""
        cfg = self.config
        lr = cfg.learning_rate if lr is None else float(lr)
        t = int(state.step) + 1
        # Leaves pair by key, as JAX's tree_map pairs them (its flatten
        # sorts dict keys): grads in another key order than params.
        leaves, g_leaves = tree_leaves(params), tree_leaves_like(grads, params)
        scale = None
        if cfg.grad_clip_norm > 0 and leaves:
            scale, _ = grad_clip_scale(g_leaves, cfg.grad_clip_norm)
        key = step_key(rng) if cfg.stochastic_rounding else None
        if isinstance(key, torch.Tensor) and key.is_cuda and leaves:
            key = key.to(leaves[0].device)  # a CPU key stays on the host: two words
        p_new, m_new, v_new, w_new = fused_adamw_step(
            leaves, g_leaves, tree_leaves_like(state.m, params),
            tree_leaves_like(state.v, params),
            tree_leaves_like(state.master, params) if state.master is not None else None,
            step=t, lr=lr,
            beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
            grad_scale=scale, key=key, leaf_ids=sorted_leaf_index(params))
        master = tree_unflatten(params, w_new) if state.master is not None else None
        return tree_unflatten(params, p_new), AdamWState(
            step=t, m=tree_unflatten(params, m_new), v=tree_unflatten(params, v_new),
            master=master)

    def get_learning_rate(self) -> float:
        return self.config.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.config = self.config.replace(learning_rate=lr)


def zero_grads(params: Params) -> Grads:
    """A zero gradient tree shaped like ``params``."""
    return tree_map(torch.zeros_like, params)
