"""Component factory: modules from (type name, config dict) descriptions
(port of ``mila_tpu/nn/factory.py``). ``network_to_spec`` writes the same
spec as JAX's, so a ``Sequential`` exported by either package is rebuilt
by the other."""

from __future__ import annotations

from typing import Any

from mila_tpu_torch.nn import blocks as _blocks
from mila_tpu_torch.nn import layers as _layers
from mila_tpu_torch.nn.module import Module, Sequential
from mila_tpu_torch.utils.registry import components as _components

_BUILTINS = {
    "Linear": (_layers.Linear, _layers.LinearConfig),
    "Gelu": (_layers.Gelu, _layers.GeluConfig),
    "LayerNorm": (_layers.LayerNorm, _layers.LayerNormConfig),
    "RMSNorm": (_layers.RMSNorm, _layers.LayerNormConfig),
    "Attention": (_layers.Attention, _layers.AttentionConfig),
    "Encoder": (_layers.Encoder, _layers.EncoderConfig),
    "Softmax": (_layers.Softmax, _layers.SoftmaxConfig),
    "Dropout": (_layers.Dropout, _layers.DropoutConfig),
    "SoftmaxCrossEntropy": (_layers.SoftmaxCrossEntropy, _layers.SoftmaxCrossEntropyConfig),
    "MLP": (_blocks.MLP, _blocks.MLPConfig),
    "TransformerBlock": (_blocks.TransformerBlock, _blocks.TransformerBlockConfig),
}

for _name, (_cls, _cfg) in _BUILTINS.items():
    if not _components.contains(_name):
        _components.register(_name, (_cls, _cfg))


def create_component(type_name: str, config: dict[str, Any] | None = None) -> Module:
    """A registered component built from a config dict."""
    cls, cfg_cls = _components.get(type_name)
    return cls(cfg_cls.from_dict(config or {}))


def create_network(spec: list[dict[str, Any]], name: str = "network") -> Sequential:
    """A Sequential from ``[{"type": "Linear", "name": "fc1", "config":
    {...}}, ...]``."""
    net = Sequential()
    for i, entry in enumerate(spec):
        type_name = entry["type"]
        net.add(entry.get("name", f"{type_name.lower()}{i}"),
                create_component(type_name, entry.get("config")))
    return net


def network_to_spec(net: Sequential) -> list[dict[str, Any]]:
    """The inverse of :func:`create_network`."""
    return [{"type": type(child).__name__, "name": name, "config": child.config.to_dict()}
            for name, child in net.children()]
