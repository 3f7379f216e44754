"""Token-shard reader for language-model training (port of
``mila_tpu/data/tokens.py``, numpy only and unchanged in behaviour).

Shard format: llm.c's (magic 20240520, a 256-int32 header, then uint16
tokens) or a raw uint16 / int32 token dump. ``TokenReader`` yields int32
(inputs [B, T], targets [B, T]) next-token windows, rank-strided, gathered
by the native library where it loaded.
"""

from __future__ import annotations

import glob as _glob
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from mila_tpu_torch import native
from mila_tpu_torch.data.loader import DatasetReader

LLMC_TOKENS_MAGIC = 20240520


def read_token_file(path: str | Path) -> np.ndarray:
    """One token shard -> int32 [N] (the native reader where it loaded)."""
    path = Path(path)
    if path.suffix != ".gz":
        fast = native.read_token_file(str(path))
        if fast is not None:
            return fast
    raw = path.read_bytes()
    if len(raw) >= 1024:
        magic, _version = struct.unpack_from("<ii", raw, 0)
        if magic == LLMC_TOKENS_MAGIC:
            (ntok,) = struct.unpack_from("<i", raw, 8)
            return np.frombuffer(raw, dtype=np.uint16, offset=1024, count=ntok).astype(np.int32)
    # A raw dump: int32 when the size and the values allow it, else uint16.
    if len(raw) % 4 == 0:
        as32 = np.frombuffer(raw, dtype=np.int32)
        if len(as32) == 0 or (as32.min() >= 0 and as32.max() < 1_000_000):
            return as32.copy()
    return np.frombuffer(raw, dtype=np.uint16).astype(np.int32)


class TokenReader(DatasetReader):
    """(inputs [B, T], targets [B, T]) int32 next-token batches from one or
    more shards; windows stride by T, rank-strided."""

    def __init__(self, pattern: str | list[str | Path], batch_size: int, seq_len: int, *,
                 shuffle: bool = False, **kw):
        super().__init__(batch_size, **kw)
        if isinstance(pattern, str):
            files = sorted(_glob.glob(pattern))
        else:
            files = [str(p) for p in pattern]
        if not files:
            raise FileNotFoundError(f"no token shards match {pattern!r}")
        self.seq_len = seq_len
        self.tokens = np.concatenate([read_token_file(f) for f in files])
        if len(self.tokens) < seq_len + 1:
            raise ValueError(
                f"corpus too small: {len(self.tokens)} tokens < seq_len+1={seq_len + 1}")
        self.shuffle = shuffle
        n_windows = (len(self.tokens) - 1) // seq_len
        self._starts = (np.arange(n_windows) * seq_len)[self.process_rank:: self.num_processes]
        self._perm: Optional[np.ndarray] = None
        self.reset(0)

    def __len__(self) -> int:
        return len(self._starts)

    def reset(self, epoch: Optional[int] = None) -> None:
        super().reset(epoch)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 104729 * self._epoch)
            self._perm = rng.permutation(len(self._starts))
        else:
            self._perm = None

    def next_batch(self, index: int):
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, len(self._starts))
        sel = np.arange(lo, hi) if self._perm is None else self._perm[lo:hi]
        starts = self._starts[sel]
        fast = native.gather_windows(self.tokens, starts, self.seq_len)
        if fast is not None:
            return fast
        chunk = self.tokens[starts[:, None] + np.arange(self.seq_len + 1)[None, :]]
        return chunk[:, :-1].astype(np.int32), chunk[:, 1:].astype(np.int32)
