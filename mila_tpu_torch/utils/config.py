"""Config base: frozen, validated dataclasses (port of the part of
``mila_tpu/utils/config.py`` that ``LlamaConfig`` needs)."""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T", bound="BaseConfig")


class ConfigError(ValueError):
    """Raised when a config fails validation."""


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    name: str = ""

    def validate(self) -> None:
        """Raise :class:`ConfigError` if the config is invalid."""

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)
