"""The archive's dtype names (the part of ``mila_tpu/tensor/dtypes.py`` that
``serialization/archive.py`` needs).

JAX's archive records a blob's dtype by its abstract name ("FP32", "BF16",
"FP8_E4M3", ...) where its registry has one, and by numpy's name otherwise
("int64", "bool"); its reader also accepts the jnp names ("bfloat16").
These map the same names to torch dtypes and back. ``INT4`` has a name but
no torch dtype: a blob of it raises.
"""

from __future__ import annotations

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
