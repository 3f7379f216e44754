"""Compute-precision policy (port of ``mila_tpu/runtime/precision.py``).

A policy resolves to (param, compute, accumulation) dtypes: PERFORMANCE is
bf16 params and compute with f32 accumulation (what the card's tensor
cores take at full rate), ACCURACY f32 throughout, NATIVE the caller's
dtype with f32 accumulation, AUTO PERFORMANCE on an accelerator and
ACCURACY on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class PrecisionPolicy(enum.Enum):
    NATIVE = "native"
    PERFORMANCE = "performance"
    ACCURACY = "accuracy"
    AUTO = "auto"

    @staticmethod
    def from_string(s: str) -> "PrecisionPolicy":
        key = s.strip().lower()
        for p in PrecisionPolicy:
            if p.value == key:
                return p
        raise ValueError(f"unknown precision policy '{s}'")


@dataclasses.dataclass(frozen=True)
class ResolvedPrecision:
    """The dtypes a policy resolves to."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype


def resolve(policy: PrecisionPolicy, *, on_accelerator: bool = True,
            native_dtype: torch.dtype = torch.float32) -> ResolvedPrecision:
    f32, bf16 = torch.float32, torch.bfloat16
    if policy == PrecisionPolicy.AUTO:
        policy = PrecisionPolicy.PERFORMANCE if on_accelerator else PrecisionPolicy.ACCURACY
    if policy == PrecisionPolicy.ACCURACY:
        return ResolvedPrecision(f32, f32, f32)
    if policy == PrecisionPolicy.PERFORMANCE:
        return ResolvedPrecision(bf16, bf16, f32)
    return ResolvedPrecision(native_dtype, native_dtype, f32)
