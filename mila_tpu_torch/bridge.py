"""Bridge from the JAX package's parameter trees to the port's.

``params_from_jax`` takes a params tree whose leaves are already numpy
arrays (the caller runs ``np.asarray`` on the JAX side, so this module never
sees JAX) and returns the port's dict of tensors with the same nesting.
Quantized weights (any object with ``q``, ``scale``, ``block_size`` and
``packed_rows``) become :class:`~mila_tpu_torch.inference.quantize.QTensor`
with those fields carried unchanged. The decode weight packs
(``LayerPack``, ``LayerStream``, ``MLPPack``, ``MegaPack``, ``GigaPack``:
named tuples of arrays and scalar fields) become the port's named tuples of
the same name and fields: arrays converted, ints kept ints, floats kept
floats (``GigaPack.eps``) and ``None`` kept ``None`` (a ``GigaPack``
without RoPE rows), so a JAX-packed tree runs the port's kernels on the
same bytes. ``adamw_state_from_jax`` carries an ``AdamWState`` (step, m,
v and master trees, numpy-leaved) over to the port's, and
``sgd_state_from_jax`` an ``SGDState`` (step, velocity), so that both
optimizers can start from one state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.inference.quantize import QTensor
from mila_tpu_torch.kernels.decode_giga import GigaPack
from mila_tpu_torch.kernels.decode_mlp import MLPPack
from mila_tpu_torch.kernels.layer_fused import LayerPack
from mila_tpu_torch.kernels.layer_mega import MegaPack
from mila_tpu_torch.kernels.layer_stream import LayerStream

_PACKS = {p.__name__: p for p in (LayerPack, LayerStream, MLPPack, MegaPack, GigaPack)}

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


def _pack_field(v, device: torch.device):
    """One field of a decode pack: an array, None, or a Python/numpy scalar
    that keeps its kind (int stays int, float stays float)."""
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return tensor_from_numpy(v, device)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    raise TypeError(f"cannot bridge a {type(v).__name__} pack field")


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Convert a numpy-leaved params tree (dicts, QTensor-like tuples,
    arrays) to the port's params on ``device``; other leaves raise."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if all(hasattr(node, f) for f in ("q", "scale", "block_size", "packed_rows")):
            return QTensor(tensor_from_numpy(node.q, dev), tensor_from_numpy(node.scale, dev),
                           int(node.block_size), int(node.packed_rows or 0))
        port = _PACKS.get(type(node).__name__)
        if port is not None and getattr(node, "_fields", None) == port._fields:
            return port(*(_pack_field(v, dev) for v in node))
        if isinstance(node, np.ndarray):
            return tensor_from_numpy(node, dev)
        raise TypeError(f"cannot bridge a {type(node).__name__} leaf")

    return visit(tree)


def adamw_state_from_jax(state: Any, device: DeviceLike = None):
    """The port's ``AdamWState`` from a JAX one whose trees hold numpy
    arrays (``step`` an int or a 0-dim array; ``master`` a tree or None)."""
    from mila_tpu_torch.optim.adamw import AdamWState

    master = None if state.master is None else params_from_jax(state.master, device)
    return AdamWState(step=int(np.asarray(state.step)), m=params_from_jax(state.m, device),
                      v=params_from_jax(state.v, device), master=master)


def sgd_state_from_jax(state: Any, device: DeviceLike = None):
    """The port's ``SGDState`` from a JAX one whose velocity tree holds
    numpy arrays."""
    from mila_tpu_torch.optim.sgd import SGDState

    return SGDState(step=int(np.asarray(state.step)),
                    velocity=params_from_jax(state.velocity, device))
