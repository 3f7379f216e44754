"""Logging facade (port of ``mila_tpu/utils/logging.py``): ``LogLevel``,
the class-level ``Logger`` with a pluggable backend and ``{}`` formatting,
and ``StepLogger``, one CSV row per training step.

The default backend is Python's ``logging.Logger`` named
``mila_tpu_torch``, writing to stderr; ``Logger.set_backend`` installs any
callable ``(level, msg)`` instead.
"""

from __future__ import annotations

import enum
import logging as _pylog
import sys
import time
from typing import Any, Callable, Optional, TextIO


class LogLevel(enum.IntEnum):
    """Severity levels, Python's ``logging`` numbers plus TRACE."""

    TRACE = 5
    DEBUG = 10
    INFO = 20
    WARNING = 30
    ERROR = 40
    CRITICAL = 50


_LOGGER_NAME = "mila_tpu_torch"


class Logger:
    """Static logging facade. ``Logger.info("step {}: {:.3f}", i, loss)``
    formats with ``str.format`` only when the level passes."""

    _backend: Optional[Callable[[LogLevel, str], None]] = None
    _py_logger: Optional[_pylog.Logger] = None
    _level: LogLevel = LogLevel.INFO

    @classmethod
    def _get_py_logger(cls) -> _pylog.Logger:
        if cls._py_logger is None:
            lg = _pylog.getLogger(_LOGGER_NAME)
            if not lg.handlers:
                h = _pylog.StreamHandler(sys.stderr)
                h.setFormatter(_pylog.Formatter(
                    "%(asctime)s [%(levelname)s] mila_tpu_torch: %(message)s"))
                lg.addHandler(h)
            lg.setLevel(int(cls._level))
            cls._py_logger = lg
        return cls._py_logger

    @classmethod
    def set_backend(cls, backend: Optional[Callable[[LogLevel, str], None]]) -> None:
        """Install a custom backend (None restores the default)."""
        cls._backend = backend

    @classmethod
    def set_level(cls, level: LogLevel | int) -> None:
        cls._level = LogLevel(int(level))
        if cls._py_logger is not None:
            cls._py_logger.setLevel(int(cls._level))

    @classmethod
    def get_level(cls) -> LogLevel:
        return cls._level

    @classmethod
    def log(cls, level: LogLevel, msg: str, *args: Any) -> None:
        if int(level) < int(cls._level):
            return
        if args:
            msg = msg.format(*args)
        if cls._backend is not None:
            cls._backend(level, msg)
        else:
            cls._get_py_logger().log(int(level), msg)

    @classmethod
    def trace(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.TRACE, msg, *args)

    @classmethod
    def debug(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.DEBUG, msg, *args)

    @classmethod
    def info(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.INFO, msg, *args)

    @classmethod
    def warning(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.WARNING, msg, *args)

    @classmethod
    def error(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.ERROR, msg, *args)

    @classmethod
    def critical(cls, msg: str, *args: Any) -> None:
        cls.log(LogLevel.CRITICAL, msg, *args)


class StepLogger:
    """One CSV row per step: ``time_s,step,<columns>``, the header on first
    use; floats as ``{:.6g}``, a missing column empty. To ``stream``
    (stdout by default) or a file at ``path`` that it owns."""

    def __init__(self, columns: list[str], stream: Optional[TextIO] = None,
                 path: Optional[str] = None):
        if stream is not None and path is not None:
            raise ValueError("pass either stream or path, not both")
        self._own_file = None
        if path is not None:
            self._own_file = open(path, "w")
            stream = self._own_file
        self._stream = stream or sys.stdout
        self._columns = ["time_s", "step", *columns]
        self._t0 = time.monotonic()
        self._wrote_header = False

    def log_step(self, step: int, **values: Any) -> None:
        if not self._wrote_header:
            print(",".join(self._columns), file=self._stream)
            self._wrote_header = True
        row = [f"{time.monotonic() - self._t0:.3f}", str(step)]
        for col in self._columns[2:]:
            v = values.get(col, "")
            row.append(f"{v:.6g}" if isinstance(v, float) else str(v))
        print(",".join(row), file=self._stream, flush=True)

    def close(self) -> None:
        if self._own_file is not None:
            self._own_file.close()
            self._own_file = None

    def __enter__(self) -> "StepLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
