"""Bridge from the JAX package's parameter trees to the port's.

``params_from_jax`` takes a params tree whose leaves are already numpy
arrays (the caller runs ``np.asarray`` on the JAX side, so this module never
sees JAX) and returns the port's dict of tensors with the same nesting.
Quantized weights (any object with ``q``, ``scale``, ``block_size`` and
``packed_rows``) become :class:`~mila_tpu_torch.inference.quantize.QTensor`
with those fields carried unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.inference.quantize import QTensor

# numpy cannot name these dtypes without extra packages; move their bytes.
_BITCAST = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    spec = _BITCAST.get(a.dtype.name)
    if spec is None:
        return torch.from_numpy(a.copy()).to(device)
    raw, dtype = spec
    return torch.from_numpy(a.view(raw).copy()).view(dtype).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Convert a numpy-leaved params tree (dicts, QTensor-like tuples,
    arrays) to the port's params on ``device``; other leaves raise."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if all(hasattr(node, f) for f in ("q", "scale", "block_size", "packed_rows")):
            return QTensor(tensor_from_numpy(node.q, dev), tensor_from_numpy(node.scale, dev),
                           int(node.block_size), int(node.packed_rows))
        if isinstance(node, np.ndarray):
            return tensor_from_numpy(node, dev)
        raise TypeError(f"cannot bridge a {type(node).__name__} leaf")

    return visit(tree)
