"""Plugins (port of ``mila_tpu/extensibility.py``): a plugin is a Python
module that exports ``MILA_TPU_PLUGIN``, an object with ``name``,
``version``, ``initialize()`` and ``shutdown()``. ``initialize`` usually
registers components, operations or models in this package's registries
(``utils.registry``: ``operations``, ``components``, ``models``).
``PluginManager`` loads plugins from a module name, a file or a directory,
and unloads them.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Optional, Protocol, runtime_checkable

from mila_tpu_torch.utils.logging import Logger


@runtime_checkable
class ModulePlugin(Protocol):
    name: str
    version: str

    def initialize(self) -> None:
        ...

    def shutdown(self) -> None:
        ...


class PluginManager:
    """Loads, tracks and unloads plugins by name."""

    def __init__(self):
        self._plugins: dict[str, ModulePlugin] = {}

    def load_from_module(self, module_name: str) -> ModulePlugin:
        return self._register(importlib.import_module(module_name), module_name)

    def load_from_path(self, path: str | Path) -> ModulePlugin:
        path = Path(path)
        spec = importlib.util.spec_from_file_location(path.stem, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load plugin from {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[path.stem] = mod
        spec.loader.exec_module(mod)
        return self._register(mod, str(path))

    def _register(self, mod, origin: str) -> ModulePlugin:
        plugin = getattr(mod, "MILA_TPU_PLUGIN", None)
        if plugin is None:
            raise ImportError(f"{origin} does not export MILA_TPU_PLUGIN")
        if not isinstance(plugin, ModulePlugin):
            raise TypeError(f"{origin}: MILA_TPU_PLUGIN does not satisfy ModulePlugin")
        if plugin.name in self._plugins:
            raise KeyError(f"plugin '{plugin.name}' already loaded")
        plugin.initialize()
        self._plugins[plugin.name] = plugin
        Logger.info("loaded plugin {} v{}", plugin.name, plugin.version)
        return plugin

    def scan_directory(self, directory: str | Path) -> list[ModulePlugin]:
        """Load every ``*.py`` of ``directory`` in name order; a file that is
        no plugin, or a second plugin of a name, is skipped with a warning."""
        loaded = []
        d = Path(directory)
        if not d.is_dir():
            return loaded
        for p in sorted(d.glob("*.py")):
            try:
                loaded.append(self.load_from_path(p))
            except (ImportError, TypeError, KeyError) as e:
                Logger.warning("skipping plugin {}: {}", p.name, e)
        return loaded

    def get(self, name: str) -> Optional[ModulePlugin]:
        return self._plugins.get(name)

    def list_plugins(self) -> list[str]:
        return sorted(self._plugins)

    def unload(self, name: str) -> None:
        self._plugins.pop(name).shutdown()

    def unload_all(self) -> None:
        for name in list(self._plugins):
            self.unload(name)
