"""Tensor helpers (port of ``mila_tpu/tensor``): the dtype registry, the
initializers and the free-function tensor ops."""

from mila_tpu_torch.tensor import dtypes, init
from mila_tpu_torch.tensor.tensor_ops import (
    AxisPartition,
    add,
    compute_axis_partition,
    copy,
    describe,
    divide,
    fill,
    fill_like,
    multiply,
    normalize_axis,
    scale,
    subtract,
    to_host,
)

__all__ = [
    "dtypes",
    "init",
    "AxisPartition",
    "add",
    "subtract",
    "multiply",
    "divide",
    "scale",
    "fill",
    "fill_like",
    "copy",
    "to_host",
    "describe",
    "compute_axis_partition",
    "normalize_axis",
]
