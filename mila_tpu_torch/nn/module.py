"""Functional module system (port of ``mila_tpu/nn/module.py``).

Modules are stateless config objects; parameters live in nested dicts of
tensors keyed by child name, with the JAX package's key names, so
``bridge.params_from_jax`` carries a JAX tree over unchanged. ``init``
allocates parameters from a ``torch.Generator`` and an input shape,
``apply`` is the forward; the backward is PyTorch's autograd through the
ops' ``torch.autograd.Function``s, which reproduce JAX's manual VJPs.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import torch

from mila_tpu_torch.device import resolve_device
from mila_tpu_torch.runtime.memory import tree_nbytes
from mila_tpu_torch.utils.config import BaseConfig
from mila_tpu_torch.utils.rng import split_named
from mila_tpu_torch.utils.tree import tree_leaves

Params = dict  # nested dict: child name -> subtree | tensor


class Module:
    """Base class: ``init(gen, input_shape, device=None) -> Params`` (``None``
    means the GPU, through ``device.resolve_device``),
    ``apply(params, x, *, training=False, rngs=None)``, ``output_shape``.
    ``rngs`` maps a stream name ("dropout") to a ``torch.Generator``."""

    config: BaseConfig

    def __init__(self, config: Optional[BaseConfig] = None):
        self.config = config if config is not None else BaseConfig()
        self.config.validate()

    @property
    def name(self) -> str:
        return self.config.name or type(self).__name__

    def init(self, gen: torch.Generator, input_shape: Sequence[int], device=None) -> Params:
        resolve_device(device)
        return {}

    def apply(self, params: Params, x: torch.Tensor, *, training: bool = False,
              rngs: Optional[dict] = None) -> torch.Tensor:
        raise NotImplementedError

    def output_shape(self, input_shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(input_shape)

    def parameter_count(self, params: Params) -> int:
        return sum(int(p.numel()) for p in tree_leaves(params) if isinstance(p, torch.Tensor))

    def parameter_bytes(self, params: Params) -> int:
        return tree_nbytes(params)

    def __call__(self, params: Params, x: torch.Tensor, **kw: Any) -> torch.Tensor:
        return self.apply(params, x, **kw)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.config})"


class CompositeModule(Module):
    """Module with named children; parameters nest by child name."""

    def __init__(self, config: Optional[BaseConfig] = None):
        super().__init__(config)
        self._children: dict[str, Module] = {}

    def add(self, name: str, module: Module) -> Module:
        if not name or "/" in name:
            raise ValueError(f"invalid child name '{name}'")
        if name in self._children:
            raise KeyError(f"child '{name}' already exists")
        self._children[name] = module
        return module

    def get(self, name: str) -> Module:
        return self._children[name]

    def has(self, name: str) -> bool:
        return name in self._children

    def remove(self, name: str) -> None:
        del self._children[name]

    def replace(self, name: str, module: Module) -> None:
        if name not in self._children:
            raise KeyError(f"no child '{name}'")
        self._children[name] = module

    def children(self) -> Iterator[tuple[str, Module]]:
        return iter(self._children.items())

    def init(self, gen: torch.Generator, input_shape: Sequence[int], device=None) -> Params:
        """Default: sequential shape propagation through the children, each
        given the resolved device."""
        device = resolve_device(device)
        gens = split_named(gen, *self._children.keys())
        params: Params = {}
        shape = tuple(input_shape)
        for name, child in self._children.items():
            params[name] = child.init(gens[name], shape, device=device)
            shape = child.output_shape(shape)
        return params

    def output_shape(self, input_shape: Sequence[int]) -> tuple[int, ...]:
        shape = tuple(input_shape)
        for child in self._children.values():
            shape = child.output_shape(shape)
        return shape


class Sequential(CompositeModule):
    """Children applied in registration order."""

    def __init__(self, layers: Optional[Sequence[tuple[str, Module]]] = None, config=None):
        super().__init__(config)
        for name, mod in layers or []:
            self.add(name, mod)

    def apply(self, params, x, *, training=False, rngs=None):
        for name, child in self._children.items():
            x = child.apply(params.get(name, {}), x, training=training, rngs=rngs)
        return x


class Lambda(Module):
    """Parameter-free module wrapping a function of one tensor."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], name: str = ""):
        super().__init__(BaseConfig(name=name or getattr(fn, "__name__", "lambda")))
        self._fn = fn

    def apply(self, params, x, *, training=False, rngs=None):
        return self._fn(x)
