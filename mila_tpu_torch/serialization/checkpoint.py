"""Checkpoint save, discovery, load and export (port of
``mila_tpu/serialization/checkpoint.py``, the same archive layout):

    model/meta.json        {epoch, step, losses, timestamp, filepath,
                            framework_version, mode}
    model/config.json      the training config (``to_dict``)
    params/...             the parameter tree
    optimizer/...          the optimizer state as a dict tree (checkpoints only)
    history.json           the training history

An optimizer state is written as its named tuple's dict (AdamW: step, m, v
and master, the last left out when None), ``step`` as an int32 scalar, as
JAX writes it; so a checkpoint either package writes resumes in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import time
from pathlib import Path
from typing import Any, Optional

import torch

from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.serialization.archive import ModelArchive, OpenMode, SerializationMode
from mila_tpu_torch.utils.tree import tree_map
from mila_tpu_torch.version import __version__

log = logging.getLogger("mila_tpu_torch")


@dataclasses.dataclass
class CheckpointMetadata:
    epoch: int = 0
    step: int = 0
    train_loss: float = 0.0
    val_loss: float = 0.0
    timestamp: float = 0.0
    filepath: str = ""


def generate_checkpoint_filename(prefix: str, epoch: int) -> str:
    return f"{prefix}_epoch{epoch:04d}.mila"


def find_latest_checkpoint(directory: str | Path, prefix: str = "") -> Optional[Path]:
    """The ``<prefix>*_epochNNNN.mila`` in ``directory`` with the largest
    epoch, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    pat = re.compile(rf"{re.escape(prefix)}.*_epoch(\d+)\.mila$")
    best, best_epoch = None, -1
    for p in directory.iterdir():
        m = pat.match(p.name)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = p, int(m.group(1))
    return best


def _state_tree(opt_state: Any) -> Any:
    """An optimizer state as the dict tree JAX writes: a named tuple's
    fields, an int ``step`` as an int32 scalar."""
    tree = opt_state._asdict() if hasattr(opt_state, "_asdict") else opt_state
    if isinstance(tree, dict) and "step" in tree and not isinstance(tree["step"], torch.Tensor):
        tree = {**tree, "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}
    return tree


def save_checkpoint(path: str | Path, params: Any, *, opt_state: Any = None,
                    model_config: Any = None, metadata: Optional[CheckpointMetadata] = None,
                    history: Any = None,
                    mode: SerializationMode = SerializationMode.CHECKPOINT) -> None:
    meta = metadata or CheckpointMetadata()
    meta.timestamp = meta.timestamp or time.time()
    with ModelArchive(path, OpenMode.WRITE) as ar:
        ar.write_json("model/meta.json", {**dataclasses.asdict(meta),
                                          "framework_version": __version__, "mode": mode.value})
        if model_config is not None:
            cfg = model_config.to_dict() if hasattr(model_config, "to_dict") else model_config
            ar.write_json("model/config.json", cfg)
        ar.write_tree("params", params)
        if opt_state is not None and mode == SerializationMode.CHECKPOINT:
            ar.write_tree("optimizer", _state_tree(opt_state))
        if history is not None:
            h = dataclasses.asdict(history) if dataclasses.is_dataclass(history) else history
            ar.write_json("history.json", h)
    log.debug("checkpoint saved to %s", path)


def load_checkpoint(path: str | Path) -> dict:
    """{meta, config, params, optimizer, history}, a missing part None; the
    trees as ``ModelArchive.read_tree`` gives them (CPU tensors)."""
    with ModelArchive(path, OpenMode.READ) as ar:
        out: dict[str, Any] = {
            "meta": ar.read_json("model/meta.json"),
            "config": ar.read_json("model/config.json") if ar.exists("model/config.json") else None,
            "params": ar.read_tree("params"),
            "optimizer": None,
            "history": ar.read_json("history.json") if ar.exists("history.json") else None,
        }
        if ar.exists("optimizer/__index__.json"):
            out["optimizer"] = ar.read_tree("optimizer")
    return out


def to_device_tree(tree: Any, dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None) -> Any:
    """A tree's leaves on ``device`` (the GPU unless named), floating
    leaves cast to ``dtype`` where given."""
    dev = resolve_device(device)

    def put(x):
        from mila_tpu_torch.serialization.archive import as_cpu_tensor

        t = x if isinstance(x, torch.Tensor) else as_cpu_tensor(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(put, tree)
