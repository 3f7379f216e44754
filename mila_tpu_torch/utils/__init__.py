"""Core services (port of ``mila_tpu/utils``): configs, logging, the
registries and seeded random streams."""

from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.logging import Logger, LogLevel, StepLogger
from mila_tpu_torch.utils.registry import Registry
from mila_tpu_torch.utils.rng import RandomGenerator, split_named

__all__ = [
    "BaseConfig",
    "ConfigError",
    "Logger",
    "LogLevel",
    "StepLogger",
    "Registry",
    "RandomGenerator",
    "split_named",
]
