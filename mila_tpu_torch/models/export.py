"""Inference export and load: self-describing model archives (port of
``mila_tpu/models/export.py``, the same archive). The archive holds the
architecture (a registered model's class name and config, or a
``Sequential``'s factory spec) beside the weights, so ``load_exported``
rebuilds the module without user code; an archive either package exports
loads in the other."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike
from mila_tpu_torch.nn.module import Module, Sequential
from mila_tpu_torch.serialization.archive import ModelArchive, OpenMode
from mila_tpu_torch.serialization.checkpoint import to_device_tree
from mila_tpu_torch.utils.registry import models as _models
from mila_tpu_torch.utils.tree import tree_leaves
from mila_tpu_torch.version import __version__

_MODEL_CLASSES: dict[str, Any] = {}
_TAKE_DEVICE = ("GPT2", "Llama")  # constructors that take the module's device


def _model_registry() -> dict[str, Any]:
    """name -> (class, config class) of the models an archive may name;
    each is also in ``utils.registry.models``."""
    if not _MODEL_CLASSES:
        from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
        from mila_tpu_torch.models.llama import Llama, LlamaConfig
        from mila_tpu_torch.models.mlp_classifier import MLPClassifier, MLPClassifierConfig

        _MODEL_CLASSES.update({"GPT2": (GPT2, GPT2Config), "Llama": (Llama, LlamaConfig),
                               "MLPClassifier": (MLPClassifier, MLPClassifierConfig)})
        for name, (cls, _) in _MODEL_CLASSES.items():
            if not _models.contains(name):
                _models.register(name, cls)
    return _MODEL_CLASSES


def export_model(path: str | Path, module: Module, params: Any) -> None:
    """Write a self-describing inference archive."""
    cls_name = type(module).__name__
    if cls_name in _model_registry():
        arch: dict[str, Any] = {"kind": "model", "class": cls_name,
                                "config": module.config.to_dict()}
    elif isinstance(module, Sequential):
        from mila_tpu_torch.nn.factory import network_to_spec

        arch = {"kind": "sequential", "spec": network_to_spec(module)}
    else:
        raise ValueError(f"cannot export architecture for {cls_name}; register it or use "
                         "Sequential")
    with ModelArchive(path, OpenMode.WRITE) as ar:
        ar.write_json("model/meta.json", {"mode": "export", "framework_version": __version__})
        ar.write_json("model/architecture.json", arch)
        ar.write_tree("params", params)


def load_exported(path: str | Path, dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> tuple[Module, Any]:
    """(module, params on ``device``, the GPU unless named), floating
    params cast to ``dtype`` where given."""
    with ModelArchive(path, OpenMode.READ) as ar:
        arch = ar.read_json("model/architecture.json")
        params = ar.read_tree("params")
    if arch["kind"] == "model":
        cls, cfg_cls = _model_registry()[arch["class"]]
        cfg = cfg_cls.from_dict(arch["config"])
        module = cls(cfg, device=device) if arch["class"] in _TAKE_DEVICE else cls(cfg)
    else:
        from mila_tpu_torch.nn.factory import create_network

        module = create_network(arch["spec"])
    return module, to_device_tree(params, dtype=dtype, device=device)


class Predictor:
    """predict / predict_batch over a module and its params, without
    gradients, on the params' device."""

    def __init__(self, module: Module, params: Any):
        self.module = module
        self.params = params
        self.device = next(p.device for p in tree_leaves(params) if isinstance(p, torch.Tensor))

    @classmethod
    def from_archive(cls, path: str | Path, dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> "Predictor":
        return cls(*load_exported(path, dtype=dtype, device=device))

    def _input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(self.device)

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        return self.module.apply(self.params, self._input(x)[None])[0]

    @torch.no_grad()
    def predict_batch(self, x) -> torch.Tensor:
        return self.module.apply(self.params, self._input(x))
