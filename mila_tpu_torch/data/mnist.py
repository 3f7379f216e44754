"""MNIST: the IDX reader and the synthetic surrogate (port of
``mila_tpu/data/mnist.py``, numpy only and unchanged in behaviour, so
``synthetic_mnist`` is bit-equal to JAX's for the same arguments).

Images come as float32 [N, 784] in [0, 1], labels as int32. Where the IDX
files are missing, ``MnistReader(source="auto")`` falls back to the
synthetic surrogate, a learnable 10-class problem (labelled as such: its
accuracy is not real MNIST's).
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from mila_tpu_torch import native
from mila_tpu_torch.data.loader import ArrayReader

log = logging.getLogger("mila_tpu_torch")

IDX_IMAGE_MAGIC = 2051
IDX_LABEL_MAGIC = 2049

_FILES = {
    "train_images": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
}


def _open_maybe_gz(path: Path):
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def read_idx_images(path: Path) -> np.ndarray:
    """An IDX3 image file -> float32 [N, rows * cols] in [0, 1]."""
    path = Path(path)
    if path.suffix != ".gz":
        fast = native.read_idx_images(str(path))
        if fast is not None:
            return fast
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != IDX_IMAGE_MAGIC:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32) / 255.0


def read_idx_labels(path: Path) -> np.ndarray:
    """An IDX1 label file -> int32 [N]."""
    path = Path(path)
    if path.suffix != ".gz":
        fast = native.read_idx_labels(str(path))
        if fast is not None:
            return fast
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != IDX_LABEL_MAGIC:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def _find(data_dir: Path, names: list[str]) -> Optional[Path]:
    for name in names:
        for cand in (data_dir / name, data_dir / (name + ".gz")):
            if cand.exists():
                return cand
    return None


def load_mnist(data_dir: Optional[str] = None,
               split: str = "train") -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Real MNIST from IDX files under ``data_dir`` (``$MILA_TPU_DATA`` or
    ``data`` by default), or None."""
    root = Path(data_dir or os.environ.get("MILA_TPU_DATA", "data"))
    for sub in (root, root / "mnist", root / "MNIST" / "raw"):
        img = _find(sub, _FILES[f"{split}_images"])
        lbl = _find(sub, _FILES[f"{split}_labels"])
        if img and lbl:
            return read_idx_images(img), read_idx_labels(lbl)
    return None


def synthetic_mnist(n: int = 12000, seed: int = 0,
                    noise: float = 0.25) -> tuple[np.ndarray, np.ndarray]:
    """A deterministic 10-class 28x28 surrogate: fixed smoothed random
    prototypes (independent of ``seed``) plus noise; ``seed`` draws the
    labels and the noise."""
    proto_rng = np.random.default_rng(1234567)
    rng = np.random.default_rng(seed)
    protos = proto_rng.normal(0, 1, (10, 784)).astype(np.float32).reshape(10, 28, 28)
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                  + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)) / 5.0
    protos = protos.reshape(10, 784)
    protos = (protos - protos.min(1, keepdims=True)) / (
        protos.max(1, keepdims=True) - protos.min(1, keepdims=True) + 1e-9)
    labels = rng.integers(0, 10, n).astype(np.int32)
    images = protos[labels] + rng.normal(0, noise, (n, 784)).astype(np.float32)
    return np.clip(images, 0.0, 1.0).astype(np.float32), labels


class MnistReader(ArrayReader):
    """Batched MNIST. ``source``: "real" (the IDX files or raise),
    "synthetic", or "auto" (real where found). The synthetic train split
    holds ``synthetic_n`` examples (seed 0), the test split a fifth of it
    (seed 1)."""

    def __init__(self, batch_size: int, *, split: str = "train", data_dir: Optional[str] = None,
                 source: str = "auto", synthetic_n: int = 12000, **kw):
        self.is_synthetic = False
        data = None
        if source in ("real", "auto"):
            data = load_mnist(data_dir, split)
            if data is None and source == "real":
                raise FileNotFoundError(
                    "MNIST IDX files not found (looked under "
                    f"{data_dir or os.environ.get('MILA_TPU_DATA', 'data')})")
        if data is None:
            self.is_synthetic = True
            n = synthetic_n if split == "train" else synthetic_n // 5
            data = synthetic_mnist(n, seed=0 if split == "train" else 1)
            log.warning("MNIST IDX files not found: using the synthetic surrogate "
                        "(%d examples, split=%s)", len(data[0]), split)
        super().__init__(data[0], data[1], batch_size, **kw)
