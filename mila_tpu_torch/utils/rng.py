"""Seeded random streams (the part of ``mila_tpu/utils/rng.py`` that module
initialization needs).

JAX derives independent keys by folding a hash of a name into a key; here
a name derives a fresh ``torch.Generator`` from a parent's seed the same
way. The two frameworks draw different numbers from one seed: parity
between them goes through the parameter bridge, never through equal draws.
"""

from __future__ import annotations

import hashlib
from typing import Union

import torch

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
