"""Optimizers (port of ``mila_tpu/optim``)."""

from mila_tpu_torch.optim.adamw import AdamW, AdamWConfig, AdamWState, global_norm, zero_grads
from mila_tpu_torch.optim.schedules import (
    Schedule,
    constant,
    step_decay,
    warmup_cosine,
    warmup_linear,
)
from mila_tpu_torch.optim.sgd import SGD, SGDConfig, SGDState

__all__ = ["AdamW", "AdamWConfig", "AdamWState", "global_norm", "zero_grads", "Schedule",
           "constant", "step_decay", "warmup_cosine", "warmup_linear", "SGD", "SGDConfig",
           "SGDState"]
