"""Path-addressed zip archive of JSON documents and raw tensor blobs (port
of ``mila_tpu/serialization/archive.py``, the same layout).

A tensor at ``<path>`` is two members: ``<path>.json`` (dtype, shape,
byte_size, layout "row_major", byte_order "little") and ``<path>.bin``, its
little-endian row-major bytes. A tree is one tensor per leaf under
``<prefix>/<key>/<key>...`` plus ``<prefix>/__index__.json``, the leaf paths
in order. Dict keys are written sorted, list and tuple items by index, and
``None`` leaves are left out, as JAX writes them; so a file either package
writes is read by the other, blob for blob. The dtype is recorded by its
abstract name ("FP32", "BF16", "FP8_E4M3", ...; ``tensor.dtypes``) or by
numpy's ("int64"). Blobs come back as CPU tensors read from their raw bytes
(``torch.frombuffer``), bf16 and fp8 included. The port stores the ``.bin``
members uncompressed (``ZIP_STORED``; JAX deflates them): weights and
optimizer moments are close to random bits, so deflate shrinks them little
and holds a GPT-2 checkpoint of several hundred MB for tens of seconds. A
zip reader takes either, so the files still cross both ways.

As in JAX, ``read_tree`` gives nested dicts only: a list comes back as a
dict keyed "0", "1", ... and a ``None`` leaf is missing. :func:`restore_tree`
puts a tree read back into the shape of a tree it was written from.
"""

from __future__ import annotations

import enum
import json
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mila_tpu_torch.tensor import dtypes as _dt


class OpenMode(enum.Enum):
    READ = "r"
    WRITE = "w"


class SerializationMode(enum.Enum):
    CHECKPOINT = "checkpoint"  # full training state
    EXPORT = "export"  # inference-only weights


def _normalize(path: str) -> str:
    parts = [p for p in path.replace("\\", "/").split("/") if p and p != "."]
    if any(p == ".." for p in parts):
        raise ValueError(f"path escapes archive: {path}")
    return "/".join(parts)


# numpy arrays of the dtypes numpy cannot name without extra packages arrive
# with these names; their bytes move as the raw type.
_NUMPY_BITCAST = {"bfloat16": (np.int16, torch.bfloat16),
                  "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                  "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def as_cpu_tensor(value) -> torch.Tensor:
    """A tensor, numpy array or Python scalar as a contiguous CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    arr = np.ascontiguousarray(np.asarray(value))
    spec = _NUMPY_BITCAST.get(arr.dtype.name)
    if spec is not None:
        raw, dtype = spec
        return torch.from_numpy(arr.view(raw).copy()).view(dtype)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return torch.from_numpy(arr.copy())


class ModelArchive:
    """Zip-backed archive: ``write_json``/``read_json`` and tensor blobs."""

    def __init__(self, path: str | Path, mode: OpenMode = OpenMode.READ):
        self.path = Path(path)
        self.mode = mode
        self._zf = zipfile.ZipFile(self.path, mode.value, compression=zipfile.ZIP_DEFLATED)

    # --- json ---

    def write_json(self, path: str, obj: Any) -> None:
        self._zf.writestr(_normalize(path), json.dumps(obj, indent=1))

    def read_json(self, path: str) -> Any:
        return json.loads(self._zf.read(_normalize(path)))

    # --- raw blobs ---

    def write_bytes(self, path: str, data: bytes) -> None:
        self._zf.writestr(_normalize(path), data)

    def read_bytes(self, path: str) -> bytes:
        return self._zf.read(_normalize(path))

    def exists(self, path: str) -> bool:
        try:
            self._zf.getinfo(_normalize(path))
            return True
        except KeyError:
            return False

    def list(self, prefix: str = "") -> list[str]:
        prefix = _normalize(prefix) + "/" if prefix else ""
        return sorted(n for n in self._zf.namelist() if n.startswith(prefix))

    # --- tensors ---

    def write_tensor(self, path: str, value) -> None:
        t = as_cpu_tensor(value)
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()  # the host's (little) order
        meta = {"dtype": _dt.to_name(t.dtype), "shape": list(t.shape), "byte_size": len(data),
                "layout": "row_major", "byte_order": "little"}
        self.write_json(path + ".json", meta)
        self._zf.writestr(_normalize(path + ".bin"), data, compress_type=zipfile.ZIP_STORED)

    def read_tensor(self, path: str) -> torch.Tensor:
        meta = self.read_json(path + ".json")
        raw = self.read_bytes(path + ".bin")
        dtype = _dt.torch_dtype(meta["dtype"])
        if not raw:
            return torch.empty(meta["shape"], dtype=dtype)
        return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(meta["shape"])

    # --- trees ---

    def write_tree(self, prefix: str, tree: Any) -> None:
        """Write a nested dict/list tree of tensors or arrays under ``prefix``."""
        index = []
        for keypath, leaf in _flatten_paths(tree):
            self.write_tensor(f"{prefix}/{keypath}", leaf)
            index.append(keypath)
        self.write_json(f"{prefix}/__index__.json", index)

    def read_tree(self, prefix: str) -> dict:
        out: dict = {}
        for keypath in self.read_json(f"{prefix}/__index__.json"):
            _set_path(out, keypath.split("/"), self.read_tensor(f"{prefix}/{keypath}"))
        return out

    def close(self) -> None:
        self._zf.close()

    def __enter__(self) -> "ModelArchive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _flatten_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten_paths(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_flatten_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        out.append((prefix[:-1], tree))
    return out


def _set_path(d: dict, keys: list[str], value: Any) -> None:
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def restore_tree(read: Any, like: Any, where: str = "") -> Any:
    """``read`` (a tree as ``read_tree`` gives it) in the structure of
    ``like``, the tree it was written from or one shaped as it: dicts in
    ``like``'s key order, lists and tuples (named tuples too) rebuilt from
    their "0", "1", ... keys, ``None`` where ``like`` holds None and empty
    subtrees where ``like``'s hold no leaf (neither is written). A leaf
    missing from ``read``, a key ``like`` lacks or a leaf whose shape
    differs from ``like``'s raises."""
    if like is None:
        return None
    if isinstance(like, (dict, list, tuple)):
        items = list(like.items()) if isinstance(like, dict) else list(enumerate(like))
        if not isinstance(read, dict):
            raise ValueError(f"archive tree at '{where}': expected a subtree")
        want = {str(k) for k, v in items if _has_leaves(v)}
        if set(read) != want:
            raise ValueError(f"archive tree at '{where}': keys {sorted(read)} != {sorted(want)}")
        out = [(k, restore_tree(read.get(str(k), {}), v, f"{where}/{k}")) for k, v in items]
        if isinstance(like, dict):
            return dict(out)
        vals = [v for _, v in out]
        return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)
    if isinstance(read, dict) or read is None:
        raise ValueError(f"archive tree at '{where}': expected a leaf")
    if hasattr(like, "shape") and tuple(read.shape) != tuple(like.shape):
        raise ValueError(f"archive tree at '{where}': shape {tuple(read.shape)} != "
                         f"{tuple(like.shape)}")
    return read


def _has_leaves(tree: Any) -> bool:
    return bool(_flatten_paths(tree))
