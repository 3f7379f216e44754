"""Profiling helpers (port of ``mila_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, named wall-clock
scopes, and a decorator that labels a function in the profiler.

JAX's ``trace`` writes a TensorBoard profile; this one writes the Chrome
trace JSON of ``torch.profiler`` (CPU, and CUDA where there is a GPU),
which Perfetto and ``chrome://tracing`` open.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Any, Iterator, Optional

import torch

from mila_tpu_torch.utils.logging import Logger


def default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "mila_tpu_torch_trace")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``<log_dir>/mila_tpu_torch.<pid>.
    <ns>.pt.trace.json`` (``log_dir`` defaults to a folder under the
    temporary directory). Yields the profiler."""
    log_dir = log_dir or default_trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"mila_tpu_torch.{os.getpid()}.{time.time_ns()}"
                                     ".pt.trace.json")
        prof.export_chrome_trace(path)
        Logger.info("profile trace written to {}", path)


def _synchronize(sync: Any) -> None:
    """Wait for the CUDA device of ``sync``: a tensor, a device (or its
    name), or a list, tuple or dict of tensors. CPU work is done already."""
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (list, tuple)):
        for s in sync:
            _synchronize(s)
        return
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Named wall-clock scopes with a summary. ``scope(name, sync=x)``
    waits for x's CUDA device before it reads the clock at the end, so the
    scope holds the device work it launched."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def scope(self, name: str, sync: Optional[Any] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t * 1e3:10.2f} ms total  {t / c * 1e3:8.3f} ms/call  x{c}")
        return "\n".join(lines)


def annotate(name: str):
    """Decorator running the function inside ``torch.profiler.record_function
    (name)``, a labelled range in a trace."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)

        return wrapped

    return deco
