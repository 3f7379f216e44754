"""Config base: frozen, validated dataclasses (port of
``mila_tpu/utils/config.py``). ``to_dict``/``from_dict`` write and read the
same dicts as JAX's, so a config stored in an archive by either package
builds the other's module."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Type, TypeVar

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

    def to_dict(self) -> dict[str, Any]:
        def enc(v: Any) -> Any:
            if isinstance(v, enum.Enum):
                return v.name
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return {f.name: enc(getattr(v, f.name)) for f in dataclasses.fields(v)}
            if isinstance(v, (list, tuple)):
                return [enc(x) for x in v]
            if isinstance(v, dict):
                return {k: enc(x) for k, x in v.items()}
            return v

        return {f.name: enc(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls: Type[T], d: dict[str, Any]) -> T:
        """Unknown keys are ignored; enums come back from their names,
        nested configs from their dicts, lists as tuples where the field is
        a tuple."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw: dict[str, Any] = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ftype = fields[k].type
            resolved = _resolve_type(ftype, cls)
            if (isinstance(resolved, type) and issubclass(resolved, enum.Enum)
                    and isinstance(v, str)):
                v = resolved[v]
            elif (isinstance(resolved, type) and dataclasses.is_dataclass(resolved)
                  and isinstance(v, dict)):
                v = resolved.from_dict(v) if issubclass(resolved, BaseConfig) else resolved(**v)
            elif isinstance(v, list):
                v = tuple(v) if _wants_tuple(ftype) else v
            kw[k] = v
        return cls(**kw)


def _resolve_type(tp: Any, owner: type) -> Any:
    """The class a field annotation names (``Optional[X]`` gives X), or None."""
    if isinstance(tp, str):
        import sys
        import typing

        mod = sys.modules.get(owner.__module__)
        ns = dict(vars(typing))
        if mod is not None:
            ns.update(vars(mod))
        try:
            tp = eval(tp, ns)  # noqa: S307 - annotations from this package's modules
        except Exception:
            return None
    if getattr(tp, "__origin__", None) is not None:
        args = [a for a in getattr(tp, "__args__", ()) if a is not type(None)]
        return _resolve_type(args[0], owner) if args else None
    return tp


def _wants_tuple(tp: Any) -> bool:
    s = str(tp)
    return "tuple" in s or "Tuple" in s
