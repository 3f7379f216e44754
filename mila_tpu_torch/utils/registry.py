"""Generic name -> factory registry (a copy of
``mila_tpu/utils/registry.py``): entries keyed by (name, variant), a
lookup falling back from a variant to the name's default entry."""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, Hashable, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """Thread-safe name -> factory registry with optional variant keys."""

    def __init__(self, kind: str):
        self._kind = kind
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, Hashable], T] = {}

    def register(self, name: str, value: T, variant: Hashable = None,
                 overwrite: bool = False) -> None:
        key = (name, variant)
        with self._lock:
            if key in self._entries and not overwrite:
                raise KeyError(f"{self._kind} '{name}' (variant={variant}) already registered")
            self._entries[key] = value

    def get(self, name: str, variant: Hashable = None) -> T:
        with self._lock:
            key = (name, variant)
            if key in self._entries:
                return self._entries[key]
            if variant is not None and (name, None) in self._entries:
                return self._entries[(name, None)]
        raise KeyError(f"no {self._kind} named '{name}' (variant={variant}); "
                       f"registered: {sorted({n for n, _ in self._entries})}")

    def contains(self, name: str, variant: Hashable = None) -> bool:
        with self._lock:
            return (name, variant) in self._entries or (name, None) in self._entries

    def names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _ in self._entries})

    def decorator(self, name: Optional[str] = None, variant: Hashable = None) -> Callable:
        """Use as ``@registry.decorator("Name")`` on a function or class."""

        def deco(obj: Any) -> Any:
            self.register(name or obj.__name__, obj, variant=variant)
            return obj

        return deco


operations: Registry[Callable] = Registry("operation")  # ops/__init__.py's names
components: Registry[type] = Registry("component")  # nn/factory.py's builtins
models: Registry[type] = Registry("model")  # the models an archive may name
