"""The abstract dtype registry with per-dtype traits, and the archive's
dtype names (port of ``mila_tpu/tensor/dtypes.py``).

``DTypeTraits`` holds JAX's traits but its TPU ones (``mxu_native``,
``min_tile``). ``INT4`` has no torch dtype (``torch_dtype`` None): the port stores
it two nibbles to an int8 byte. JAX's ``from_jnp`` is ``from_torch`` here.

JAX's archive records a blob's dtype by its abstract name ("FP32", "BF16",
"FP8_E4M3", ...) where its registry has one, and by numpy's name otherwise
("int64", "bool"); its reader also accepts the jnp names ("bfloat16").
These map the same names to torch dtypes and back. ``INT4`` has a name but
no torch dtype: a blob of it raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

# abstract name -> (jnp name, torch dtype)
_ABSTRACT = {
    "FP32": ("float32", torch.float32),
    "FP16": ("float16", torch.float16),
    "BF16": ("bfloat16", torch.bfloat16),
    "FP8_E4M3": ("float8_e4m3fn", torch.float8_e4m3fn),
    "FP8_E5M2": ("float8_e5m2", torch.float8_e5m2),
    "INT8": ("int8", torch.int8),
    "INT16": ("int16", torch.int16),
    "INT32": ("int32", torch.int32),
    "UINT8": ("uint8", torch.uint8),
    "UINT16": ("uint16", torch.uint16),
    "UINT32": ("uint32", torch.uint32),
    "INT4": ("int4", None),
}
# Dtypes without an abstract name, recorded by numpy's name as JAX does.
_NUMPY_NAMED = {"float64": torch.float64, "int64": torch.int64, "uint64": torch.uint64,
                "bool": torch.bool, "complex64": torch.complex64,
                "complex128": torch.complex128}


def to_name(dtype: torch.dtype) -> str:
    """The name an archive records for ``dtype``."""
    for name, (_, d) in _ABSTRACT.items():
        if d == dtype:
            return name
    for name, d in _NUMPY_NAMED.items():
        if d == dtype:
            return name
    raise KeyError(f"no archive name for {dtype}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an archive's name: abstract ("BF16", any case),
    jnp ("bfloat16") or numpy ("int64")."""
    for abstract, (jnp_name, d) in _ABSTRACT.items():
        if name.upper() == abstract or name == jnp_name:
            if d is None:
                raise KeyError(f"dtype {abstract} has no torch dtype")
            return d
    if name in _NUMPY_NAMED:
        return _NUMPY_NAMED[name]
    raise KeyError(f"unknown dtype '{name}'; known: {sorted(_ABSTRACT)}")


class IInfo(NamedTuple):
    """``torch.iinfo``'s fields, for INT4, which has no torch dtype."""

    bits: int
    min: int
    max: int


@dataclasses.dataclass(frozen=True)
class DTypeTraits:
    """Static traits of an abstract tensor dtype."""

    name: str
    torch_dtype: Optional[torch.dtype]
    bits: int
    is_float: bool
    is_signed: bool
    packed: bool = False  # sub-byte, stored two to a byte

    @property
    def jnp_name(self) -> str:
        """numpy's (and JAX's) name of the dtype: "bfloat16", "int4"."""
        return _ABSTRACT[self.name][0]

    @property
    def size_in_bytes(self) -> float:
        return self.bits / 8

    @property
    def finfo(self):
        return torch.finfo(self.torch_dtype) if self.is_float else None

    @property
    def iinfo(self):
        if self.is_float:
            return None
        if self.torch_dtype is None:
            half = 1 << (self.bits - 1)
            return IInfo(self.bits, -half, half - 1)
        return torch.iinfo(self.torch_dtype)


_REGISTRY: dict[str, DTypeTraits] = {}


def _reg(name: str, bits: int, is_float: bool, is_signed: bool,
         packed: bool = False) -> DTypeTraits:
    t = DTypeTraits(name, _ABSTRACT[name][1], bits, is_float, is_signed, packed)
    _REGISTRY[name] = t
    return t


FP32 = _reg("FP32", 32, True, True)
FP16 = _reg("FP16", 16, True, True)
BF16 = _reg("BF16", 16, True, True)
FP8_E4M3 = _reg("FP8_E4M3", 8, True, True)
FP8_E5M2 = _reg("FP8_E5M2", 8, True, True)
INT8 = _reg("INT8", 8, False, True)
INT16 = _reg("INT16", 16, False, True)
INT32 = _reg("INT32", 32, False, True)
UINT8 = _reg("UINT8", 8, False, False)
UINT16 = _reg("UINT16", 16, False, False)
UINT32 = _reg("UINT32", 32, False, False)
INT4 = _reg("INT4", 4, False, True, packed=True)


def all_dtypes() -> list[DTypeTraits]:
    return list(_REGISTRY.values())


def from_name(name: str) -> DTypeTraits:
    """By abstract name ("BF16", any case) or numpy's ("bfloat16")."""
    key = name.upper()
    if key in _REGISTRY:
        return _REGISTRY[key]
    for t in _REGISTRY.values():
        if t.jnp_name == name:
            return t
    raise KeyError(f"unknown dtype '{name}'; known: {sorted(_REGISTRY)}")


def from_torch(dtype: torch.dtype) -> DTypeTraits:
    for t in _REGISTRY.values():
        if t.torch_dtype == dtype:
            return t
    raise KeyError(f"no abstract dtype for torch dtype {dtype}")


def is_float_type(dtype: torch.dtype) -> bool:
    return from_torch(dtype).is_float


def itemsize_bits(dtype: torch.dtype) -> int:
    return from_torch(dtype).bits


def host_equivalent(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that stages ``dtype`` on the host: floats narrower
    than 16 bits, and bfloat16, which numpy lacks, through float32 (JAX
    keeps bfloat16 through ml_dtypes); others their own."""
    t = from_torch(dtype)
    if t.is_float and (t.bits < 16 or t.name == "BF16"):
        return np.dtype(np.float32)
    return np.dtype(t.jnp_name)
