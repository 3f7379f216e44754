"""Character corpus with sliding windows (port of ``mila_tpu/data/chars.py``,
numpy only and unchanged in behaviour): a byte vocabulary and (inputs,
targets) windows at a 50 % overlap by default."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from mila_tpu_torch.data.loader import DatasetReader


class CharVocabulary:
    """Each distinct byte of a corpus -> a dense id; unknown bytes -> 0."""

    def __init__(self, text_bytes: bytes):
        distinct = sorted(set(text_bytes))
        self.id_of = np.zeros(256, np.int32)
        self.byte_of: list[int] = []
        for i, b in enumerate(distinct):
            self.id_of[b] = i
            self.byte_of.append(b)

    @property
    def size(self) -> int:
        return len(self.byte_of)

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode() if isinstance(text, str) else text
        return self.id_of[np.frombuffer(data, dtype=np.uint8)]

    def decode(self, ids) -> str:
        return bytes(self.byte_of[int(i)] for i in ids).decode(errors="replace")


class CharReader(DatasetReader):
    """Sliding-window char batches: (inputs [B, T], targets [B, T]) int32;
    ``stride`` defaults to T // 2."""

    def __init__(self, text: str | bytes | Path, batch_size: int, seq_len: int, *,
                 stride: Optional[int] = None, vocab: Optional[CharVocabulary] = None,
                 shuffle: bool = True, **kw):
        super().__init__(batch_size, **kw)
        if isinstance(text, Path):
            data = text.read_bytes()
        elif isinstance(text, str):
            data = text.encode()
        else:
            data = text
        self.vocab = vocab or CharVocabulary(data)
        self.tokens = self.vocab.encode(data)
        self.seq_len = seq_len
        self.stride = stride or max(seq_len // 2, 1)
        if len(self.tokens) < seq_len + 1:
            raise ValueError("corpus shorter than one window")
        n = (len(self.tokens) - seq_len - 1) // self.stride + 1
        self._starts = (np.arange(n) * self.stride)[self.process_rank:: self.num_processes]
        self.shuffle = shuffle
        self._perm: Optional[np.ndarray] = None
        self.reset(0)

    def __len__(self) -> int:
        return len(self._starts)

    def reset(self, epoch: Optional[int] = None) -> None:
        super().reset(epoch)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 31337 * self._epoch)
            self._perm = rng.permutation(len(self._starts))
        else:
            self._perm = None

    def next_batch(self, index: int):
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, len(self._starts))
        sel = np.arange(lo, hi) if self._perm is None else self._perm[lo:hi]
        chunk = self.tokens[self._starts[sel][:, None] + np.arange(self.seq_len + 1)[None, :]]
        return chunk[:, :-1].astype(np.int32), chunk[:, 1:].astype(np.int32)


# Relative to the working directory, as the JAX package's repository path.
TINY_SHAKESPEARE_PATHS = [Path("data/tinyshakespeare/input.txt")]


def load_tiny_shakespeare() -> Optional[bytes]:
    """The Tiny Shakespeare corpus where the repository holds it, else None
    (JAX's loader also looks in the reference's source tree)."""
    for p in TINY_SHAKESPEARE_PATHS:
        if p.exists():
            return p.read_bytes()
    return None
