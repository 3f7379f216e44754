"""Seed management and seeded random streams (port of
``mila_tpu/utils/rng.py``).

JAX derives independent keys by folding a hash of a name into a key; here
a name derives a fresh ``torch.Generator`` from a parent's seed the same
way. The two frameworks draw different numbers from one seed: parity
between them goes through the parameter bridge, never through equal draws.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Union

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

GeneratorLike = Union[int, torch.Generator]


def generator(seed: GeneratorLike = 0, device="cpu") -> torch.Generator:
    """A generator seeded with ``seed`` (an int), or ``seed`` itself when it
    is one already."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _fold(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def split_named(gen: torch.Generator, *names: str) -> dict[str, torch.Generator]:
    """Named child generators, each a deterministic function of ``gen``'s
    seed and its name (not of call order)."""
    seed = gen.initial_seed()
    return {name: generator(_fold(seed, name), gen.device) for name in names}


class RandomGenerator:
    """The process-wide seed (``mila_tpu_torch.initialize(seed)`` sets it)
    and the generators derived from it. Code that takes a generator should
    be passed one; this serves entry points that need a default stream.
    Its generators live on ``device``, the GPU unless named.
    ``numpy_rng(name)`` draws what JAX's does for the same seed and name."""

    _lock = threading.Lock()
    _seed: int = 0
    _counter: int = 0

    @classmethod
    def set_seed(cls, seed: int) -> None:
        with cls._lock:
            cls._seed = int(seed)
            cls._counter = 0

    @classmethod
    def get_seed(cls) -> int:
        return cls._seed

    @classmethod
    def root_key(cls, device: DeviceLike = None) -> torch.Generator:
        """A generator seeded with the seed itself."""
        return generator(cls._seed, resolve_device(device))

    @classmethod
    def stream(cls, name: str, device: DeviceLike = None) -> torch.Generator:
        """A named stream: the same (seed, name) always gives the same
        generator, whatever the order of calls."""
        return generator(_fold(cls._seed, name), resolve_device(device))

    @classmethod
    def next_key(cls, device: DeviceLike = None) -> torch.Generator:
        """The next generator of the sequential stream (order-dependent)."""
        with cls._lock:
            c = cls._counter
            cls._counter += 1
        return generator(_fold(cls._seed, f"#{c}"), resolve_device(device))

    @classmethod
    def numpy_rng(cls, name: str = "numpy") -> np.random.Generator:
        """A numpy Generator for host-side shuffling, derived from the seed."""
        digest = hashlib.sha256(f"{cls._seed}:{name}".encode()).digest()
        return np.random.default_rng(int.from_bytes(digest[:8], "little"))
