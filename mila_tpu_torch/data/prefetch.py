"""Batch prefetch onto the device (port of ``mila_tpu/data/prefetch.py``).

A worker thread runs the reader and stages the next ``depth`` batches on
the device while the current step computes; errors are forwarded to the
consumer and an early stop joins the worker. JAX's ``device_put`` is
asynchronous by itself; here, for a CUDA device, the worker copies each
array into pinned host memory and from there with ``non_blocking=True`` on
a side CUDA stream it owns, then records an event. The consumer's stream
waits on that event before the batch is used, and every tensor of the
batch gets ``record_stream`` on the consumer's stream, so the allocator
does not hand its memory to the worker's next copy while the step still
reads it. (The pinned host block is held by PyTorch's host allocator
until its copy is done.) On the CPU the batches come as tensors and
nothing is pinned. JAX's ``sharding`` is an explicit ``device`` here;
placement over several cards is not ported.

Works with any :class:`DatasetReader` or iterable of batches: arrays,
tensors, or tuples, lists, named tuples and dicts of them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

_SENTINEL = object()


def _map_batch(fn: Callable, batch: Any) -> Any:
    """``fn`` over every array or tensor of a batch, keeping its nesting."""
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map_batch(fn, v) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(fn, v) for v in batch)
    return fn(batch)


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class PrefetchLoader:
    """Yields the batches of ``reader`` on ``device`` (the GPU unless
    named), staged ``depth`` ahead; ``device_put=False`` passes them on as
    they are."""

    def __init__(self, reader: Iterable, *, depth: int = 2, device: DeviceLike = None,
                 device_put: bool = True):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.reader = reader
        self.depth = depth
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None

    def _stage(self, batch, stream):
        """One batch onto the device; (batch, event) where the copy's event
        must be waited on (CUDA), else (batch, None)."""
        if not self.device_put:
            return batch, None
        if stream is None:
            return _map_batch(lambda a: _host_tensor(a).to(self.device), batch), None
        with torch.cuda.stream(stream):
            out = _map_batch(lambda a: _host_tensor(a).pin_memory().to(self.device,
                                                                      non_blocking=True),
                            batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        errors: list[BaseException] = []  # the worker's, raised by the consumer
        cuda = self.device_put and self.device.type == "cuda"

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                stream = torch.cuda.Stream(device=self.device) if cuda else None
                for batch in self.reader:
                    if stop.is_set() or not put(self._stage(batch, stream)):
                        return
            except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
                errors.append(e)
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=worker, name="mila-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if errors:
                        raise errors[0]
                    return
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    _map_batch(lambda x: x.record_stream(consumer), batch)
                yield batch
        finally:
            stop.set()
            t.join()


def prefetch_to_device(reader: Iterable, depth: int = 2,
                       device: DeviceLike = None) -> Iterator[Any]:
    """Functional form: ``for batch in prefetch_to_device(reader): ...``"""
    return iter(PrefetchLoader(reader, depth=depth, device=device))
