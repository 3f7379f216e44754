"""mila_tpu_torch: the PyTorch/CUDA port of ``mila_tpu`` for NVIDIA Hopper.

The JAX package ``mila_tpu`` is the reference; every module here mirrors a
counterpart there (``ops/``, ``inference/``, ``kernels/``, ``models/``) and is
held against it by ``tests/test_torch_*.py``. This package imports ``torch``,
numpy and the standard library only.

Entry points (``Llama``, ``InferenceEngine``, ``init_llama_params``,
``quantize_model_params``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without an explicit ``cpu`` they raise.

``initialize(seed)`` is the first call of every example (``examples/``):
it seeds ``utils.rng.RandomGenerator``, sets the log level and registers
the operations.
"""

from __future__ import annotations

from typing import Optional

from mila_tpu_torch.version import __version__, get_api_version

_initialized = False


def initialize(seed: int = 0, log_level: Optional[int] = None) -> None:
    """Seed the framework's random streams, set the log level (when given)
    and fill the ``operations`` registry (importing ``ops``). Devices are
    found when first asked for (``runtime.default_context``)."""
    global _initialized
    from mila_tpu_torch import ops  # noqa: F401 - registers the operations
    from mila_tpu_torch.utils.logging import Logger
    from mila_tpu_torch.utils.rng import RandomGenerator

    if log_level is not None:
        Logger.set_level(log_level)
    RandomGenerator.set_seed(seed)
    _initialized = True
    Logger.debug("mila_tpu_torch {} initialized (seed={})", __version__, seed)


def is_initialized() -> bool:
    return _initialized


def shutdown() -> None:
    """Reset the framework's state; PyTorch owns the devices."""
    global _initialized
    _initialized = False


__all__ = ["__version__", "get_api_version", "initialize", "is_initialized", "shutdown"]
