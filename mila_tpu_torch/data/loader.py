"""Dataset reader protocol and the in-memory reader (port of
``mila_tpu/data/loader.py``, numpy only and unchanged in behaviour): the
same per-epoch permutation (``default_rng(seed + 7919 * epoch)``), so the
JAX trainer and the port see batches in the same order. Readers yield
numpy host batches; the trainer moves them to its device.
"""

from __future__ import annotations

import abc
from typing import Generic, Iterator, Optional, TypeVar

import numpy as np

Batch = TypeVar("Batch")


class DatasetReader(abc.ABC, Generic[Batch]):
    """Abstract batched iterator.

    ``process_rank``/``num_processes`` stride batches across hosts so each
    rank sees a disjoint stream.
    """

    def __init__(
        self,
        batch_size: int,
        *,
        process_rank: int = 0,
        num_processes: int = 1,
        drop_last: bool = True,
        seed: int = 0,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if not 0 <= process_rank < num_processes:
            raise ValueError(f"bad rank {process_rank}/{num_processes}")
        self.batch_size = batch_size
        self.process_rank = process_rank
        self.num_processes = num_processes
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    @abc.abstractmethod
    def __len__(self) -> int:
        """Number of examples visible to this rank."""

    @abc.abstractmethod
    def next_batch(self, index: int) -> Batch:
        """Return batch ``index`` of the current epoch (numBatches-indexed)."""

    @property
    def num_batches(self) -> int:
        n = len(self)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def reset(self, epoch: Optional[int] = None) -> None:
        """Start a new epoch (reshuffles where supported)."""
        self._epoch = self._epoch + 1 if epoch is None else epoch

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self.next_batch(i)


class ArrayReader(DatasetReader):
    """In-memory (inputs, targets) arrays with per-epoch shuffling — the
    workhorse for MNIST-style datasets."""

    def __init__(
        self,
        inputs: np.ndarray,
        targets: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = True,
        **kw,
    ):
        super().__init__(batch_size, **kw)
        if len(inputs) != len(targets):
            raise ValueError("inputs/targets length mismatch")
        # Rank sharding: contiguous stride split.
        self._inputs = inputs[self.process_rank:: self.num_processes]
        self._targets = targets[self.process_rank:: self.num_processes]
        self.shuffle = shuffle
        self._perm: Optional[np.ndarray] = None
        self.reset(0)

    def __len__(self) -> int:
        return len(self._inputs)

    def reset(self, epoch: Optional[int] = None) -> None:
        super().reset(epoch)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 7919 * self._epoch)
            self._perm = rng.permutation(len(self._inputs))
        else:
            self._perm = None

    def next_batch(self, index: int):
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, len(self._inputs))
        idx = slice(lo, hi) if self._perm is None else self._perm[lo:hi]
        return self._inputs[idx], self._targets[idx]
