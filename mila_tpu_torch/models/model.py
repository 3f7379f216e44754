"""The trainer: a module, its parameters, an optimizer and the training step
(port of ``mila_tpu/models/model.py``).

JAX compiles one XLA program per step (value_and_grad of the loss, then
``opt.step``). Here the step is eager: the parameter leaves are detached
copies that require grad, the loss's ``torch.autograd.grad`` runs the ops'
``torch.autograd.Function`` backwards (the flash, softmax-CE kernels on the
card), and the optimizer's step updates every leaf (AdamW through the
fused kernel). With ``grad_accum_steps`` > 1 the batch splits into
microbatches whose f32 gradients are summed and averaged before the one
update, as JAX's scan does. With ``prefetch_depth`` > 0 (JAX's default 2)
the batches come through ``data.prefetch.PrefetchLoader``, staged on the
device ahead of the step; they are the same batches as at depth 0.

Checkpoints are JAX's archive (``serialization/checkpoint.py``): the
params, the optimizer state as its dict (AdamW: step, m, v, master), the
training config and history. ``load_checkpoint`` puts every leaf on the
model's device in the structure of the built tree (the file's own order
of sorted keys where the model was not built), so the leaf order is that
of an uninterrupted run (AdamW's stochastic-rounding noise depends only on
the step key and each leaf's place in JAX's sorted order). ``resume_training`` continues the epoch count
after the checkpoint's epoch (the readers' shuffles of the epochs that
follow), where JAX's restarts it at 0; a resumed run is bit-equal to one
trained straight through.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from mila_tpu_torch.data.loader import ArrayReader, DatasetReader
from mila_tpu_torch.data.prefetch import PrefetchLoader
from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.nn.module import Module
from mila_tpu_torch.optim.adamw import AdamW
from mila_tpu_torch.serialization.archive import SerializationMode, restore_tree
from mila_tpu_torch.serialization.checkpoint import (
    CheckpointMetadata,
    find_latest_checkpoint,
    generate_checkpoint_filename,
    load_checkpoint,
    save_checkpoint,
    to_device_tree,
)
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import GeneratorLike, generator
from mila_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

log = logging.getLogger("mila_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ModelConfig(BaseConfig):
    """Training-loop config (the JAX ModelConfig's fields)."""

    epochs: int = 10
    checkpoint_dir: str = ""
    checkpoint_frequency: int = 0  # epochs; 0 = off
    early_stopping_patience: int = 0  # 0 = off
    validation_split: float = 0.0
    verbose: bool = True
    grad_accum_steps: int = 1
    prefetch_depth: int = 2  # batches staged on the device ahead (0 = synchronous)

    def validate(self):
        if self.epochs <= 0:
            raise ConfigError("epochs must be positive")
        if not 0.0 <= self.validation_split < 1.0:
            raise ConfigError("validation_split must be in [0,1)")
        if self.grad_accum_steps < 1:
            raise ConfigError("grad_accum_steps must be >= 1")


@dataclasses.dataclass
class TrainingHistory:
    """Per-epoch record."""

    train_losses: list = dataclasses.field(default_factory=list)
    val_losses: list = dataclasses.field(default_factory=list)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    epochs_without_improvement: int = 0
    samples_per_sec: list = dataclasses.field(default_factory=list)

    def record(self, train_loss: float, val_loss: Optional[float], sps: float) -> None:
        self.train_losses.append(float(train_loss))
        if val_loss is not None:
            self.val_losses.append(float(val_loss))
            if val_loss < self.best_val_loss:
                self.best_val_loss = float(val_loss)
                self.best_epoch = len(self.train_losses) - 1
                self.epochs_without_improvement = 0
            else:
                self.epochs_without_improvement += 1
        self.samples_per_sec.append(float(sps))


class Callback:
    """Training-loop hooks; override any subset."""

    def on_train_begin(self, model: "Model") -> None: ...

    def on_epoch_begin(self, model: "Model", epoch: int) -> None: ...

    def on_epoch_end(self, model: "Model", epoch: int, train_loss: float,
                     val_loss: Optional[float]) -> None: ...

    def on_train_end(self, model: "Model") -> None: ...


def split_validation(reader: DatasetReader, fraction: float):
    """Split an ArrayReader into (train, val) readers, JAX's permutation."""
    if not isinstance(reader, ArrayReader):
        raise TypeError("validation_split requires an ArrayReader; pass val_reader explicitly")
    n = len(reader)
    n_val = max(int(n * fraction), 1)
    perm = np.random.default_rng(reader.seed).permutation(n)
    tr_idx, va_idx = perm[n_val:], perm[:n_val]
    train = ArrayReader(reader._inputs[tr_idx], reader._targets[tr_idx], reader.batch_size,
                        shuffle=reader.shuffle, seed=reader.seed)
    val = ArrayReader(reader._inputs[va_idx], reader._targets[va_idx], reader.batch_size,
                      shuffle=False, drop_last=False)
    return train, val


def value_and_grad(loss_fn: Callable, params):
    """(loss_fn(params) detached, the gradient tree of params): the eager
    stand-in for ``jax.value_and_grad``, autograd through detached leaves
    that require grad; an unused leaf's gradient is zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


class Model:
    """Owns a module, its params, an optimizer and the training step.

    ``loss_fn(module, params, inputs, targets)`` defaults to the mean
    softmax cross-entropy of the module's logits. ``device`` defaults to the
    GPU. ``sr_rng``, when set, is the stochastic-rounding key of AdamW's
    steps (a generator drawing a key a step, or a key's two words); JAX's
    trainer passes no key, so AdamW takes its ``key(0)``, and None here
    gives that key likewise.
    """

    def __init__(self, module: Module, optimizer: Optional[AdamW] = None,
                 config: Optional[ModelConfig] = None, loss_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.module = module
        self.optimizer = optimizer or AdamW()
        self.config = config or ModelConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self._loss_fn = loss_fn or self._default_loss
        self.params: Any = None
        self.opt_state: Any = None
        self.history = TrainingHistory()
        self.sr_rng: Optional[torch.Generator] = None
        self._train_step = None
        self._eval_step = None

    @staticmethod
    def _default_loss(module: Module, params, inputs, targets) -> torch.Tensor:
        from mila_tpu_torch.ops import softmax_cross_entropy

        logits = module.apply(params, inputs, training=True)
        return softmax_cross_entropy(logits, targets).mean()

    # --- lifecycle ---

    def build(self, seed: GeneratorLike, input_shape) -> None:
        """Allocate params from ``seed`` (an int or a ``torch.Generator``;
        draws on the generator's device, the CPU for an int) and set up the
        steps."""
        self.params = self.module.init(generator(seed), tuple(input_shape), device=self.device)
        self.opt_state = self.optimizer.init(self.params)
        self._compile()

    def _value_and_grad(self, params, inputs, targets):
        return value_and_grad(lambda p: self._loss_fn(self.module, p, inputs, targets), params)

    def _compile(self) -> None:
        opt, accum = self.optimizer, self.config.grad_accum_steps

        def train_step(params, opt_state, inputs, targets):
            if accum == 1:
                loss, grads = self._value_and_grad(params, inputs, targets)
            else:
                mb = inputs.shape[0] // accum
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                loss = 0.0
                for i in range(accum):
                    sl = slice(i * mb, (i + 1) * mb)
                    l, g = self._value_and_grad(params, inputs[sl], targets[sl])
                    grads = tree_map(torch.add, grads, g)
                    loss = loss + l
                grads = tree_map(lambda g: g / accum, grads)
                loss = loss / accum
            params, opt_state = opt.step(opt_state, params, grads, rng=self.sr_rng)
            return params, opt_state, loss

        @torch.no_grad()
        def eval_step(params, inputs, targets):
            return self._loss_fn(self.module, params, inputs, targets)

        self._train_step = train_step
        self._eval_step = eval_step

    def parameter_count(self) -> int:
        return self.module.parameter_count(self.params)

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a)).to(self.device)

    # --- training ---

    def train(self, reader: DatasetReader, val_reader: Optional[DatasetReader] = None,
              step_logger=None, callbacks: Optional[list] = None,
              start_epoch: int = 0) -> TrainingHistory:
        """``config.epochs`` epochs, numbered from ``start_epoch`` (each
        resets the reader to its number, so its shuffle)."""
        if self.params is None:
            raise RuntimeError("call build() before train()")
        cfg = self.config
        callbacks = callbacks or []
        if val_reader is None and cfg.validation_split > 0:
            reader, val_reader = split_validation(reader, cfg.validation_split)
        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(start_epoch, start_epoch + cfg.epochs):
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            t0 = time.monotonic()
            reader.reset(epoch)
            losses, n_seen = [], 0
            batches = reader
            if cfg.prefetch_depth > 0:
                batches = PrefetchLoader(reader, depth=cfg.prefetch_depth, device=self.device)
            for inputs, targets in batches:
                self.params, self.opt_state, loss = self._train_step(
                    self.params, self.opt_state, self._to_device(inputs),
                    self._to_device(targets))
                losses.append(loss)
                n_seen += len(inputs)
            train_loss = float(torch.stack(losses).mean()) if losses else 0.0
            dt = time.monotonic() - t0
            val_loss = self.evaluate(val_reader) if val_reader is not None else None
            self.history.record(train_loss, val_loss, n_seen / max(dt, 1e-9))
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, train_loss, val_loss)
            if step_logger is not None:
                step_logger.log_step(epoch, loss=train_loss,
                                     val_loss=val_loss if val_loss is not None else "")
            if cfg.verbose:
                log.info("epoch %d/%d: train_loss=%.4f%s (%.0f samples/s)", epoch + 1,
                         start_epoch + cfg.epochs, train_loss,
                         f" val_loss={val_loss:.4f}" if val_loss is not None else "",
                         n_seen / max(dt, 1e-9))
            if (cfg.checkpoint_frequency > 0 and cfg.checkpoint_dir
                    and (epoch + 1) % cfg.checkpoint_frequency == 0):
                self.save_checkpoint(epoch=epoch)
            if (cfg.early_stopping_patience > 0
                    and self.history.epochs_without_improvement >= cfg.early_stopping_patience):
                log.info("early stopping at epoch %d", epoch + 1)
                break
        for cb in callbacks:
            cb.on_train_end(self)
        return self.history

    def evaluate(self, reader: DatasetReader) -> float:
        losses = [self._eval_step(self.params, self._to_device(x), self._to_device(y))
                  for x, y in reader]
        return float(torch.stack(losses).mean()) if losses else 0.0

    @torch.no_grad()
    def predict(self, inputs) -> torch.Tensor:
        return self.module.apply(self.params, self._to_device(inputs), training=False)

    # --- checkpointing ---

    def save_checkpoint(self, path: Optional[str | Path] = None, epoch: int = 0) -> Path:
        """Write params, optimizer state, config and history; ``path``
        defaults to ``<checkpoint_dir>/<name>_epochNNNN.mila``."""
        if path is None:
            d = Path(self.config.checkpoint_dir or ".")
            d.mkdir(parents=True, exist_ok=True)
            path = d / generate_checkpoint_filename(self.config.name or "model", epoch)
        meta = CheckpointMetadata(
            epoch=epoch,
            step=int(self.opt_state.step) if hasattr(self.opt_state, "step") else 0,
            train_loss=self.history.train_losses[-1] if self.history.train_losses else 0.0,
            val_loss=self.history.val_losses[-1] if self.history.val_losses else 0.0,
            filepath=str(path))
        save_checkpoint(path, self.params, opt_state=self.opt_state, model_config=self.config,
                        metadata=meta, history=self.history)
        return Path(path)

    def load_checkpoint(self, path: str | Path) -> dict:
        """Load params, optimizer state and history onto the model's device;
        returns the checkpoint's metadata. A built model keeps its tree's
        structure and dtypes (a leaf the file lacks or shapes differently
        raises); an unbuilt one takes the file's tree."""
        data = load_checkpoint(path)
        like = self.params if self.params is not None else data["params"]
        params = restore_tree(data["params"], like)
        self.params = tree_map(lambda p, q: p.to(self.device, q.dtype), params, like)
        od = data["optimizer"]
        if od is not None:
            def tree(name):  # a state tree shaped as the params (None if absent)
                if name not in od:
                    return None
                return to_device_tree(restore_tree(od[name], self.params), device=self.device)

            state_cls = type(self.optimizer.init({}))  # AdamWState or SGDState
            self.opt_state = state_cls(**{f: int(od[f]) if f == "step" else tree(f)
                                          for f in state_cls._fields})
        else:
            self.opt_state = self.optimizer.init(self.params)
        if data["history"]:
            self.history = TrainingHistory(**data["history"])
        self._compile()
        return data["meta"]

    def resume_training(self, reader: DatasetReader,
                        val_reader: Optional[DatasetReader] = None) -> TrainingHistory:
        """Load the latest checkpoint of ``checkpoint_dir`` (if any) and
        train ``config.epochs`` more epochs, numbered on from the
        checkpoint's."""
        latest = find_latest_checkpoint(self.config.checkpoint_dir, self.config.name or "model")
        start = 0
        if latest is not None:
            log.info("resuming from %s", latest)
            start = int(self.load_checkpoint(latest)["epoch"]) + 1
        return self.train(reader, val_reader, start_epoch=start)

    def export(self, path: str | Path) -> None:
        """Inference-only archive: params and config, no optimizer state."""
        save_checkpoint(path, self.params, model_config=self.config,
                        mode=SerializationMode.EXPORT)
