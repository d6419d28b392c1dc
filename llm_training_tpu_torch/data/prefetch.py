"""Background host-to-device batch prefetching.

Counterpart of the core of `llm_training_tpu/data/prefetch.py`: a daemon
thread pulls host batches (numpy) from the data stream, computes the
host-side riders the trainer counts (`host_aux_fn`), and places each batch
on the device a few steps ahead, through a queue of depth
`prefetch_batches`; `close()` stops the thread, and an error of the data
stream is raised on the consumer's `next`. `batches` is an iterator or a
factory `Callable[[int], Iterator]` that maps a production offset to an
iterator positioned at that batch, as the JAX trainer passes it.

On CUDA the worker copies each batch into pinned host memory and then to
the device on a stream of its own, and the consumer's stream waits on that
copy's event before the step uses the batch. On the CPU the placement is a
plain copy.

Not here yet: the registry timers (`data/produce`, `data/host_wait`,
`data/retries`), the `retries` of transient data errors with their
backoff, the chaos hook and the watchdog heartbeat (JAX `:53-92`,
`:101-138`). They come with the port's registry and resilience layers
(ROADMAP A.3, A.4). With JAX's defaults (`retries` 0, no chaos) the JAX
prefetcher yields the same batches in the same order as this one.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def to_device(batch: dict, device: torch.device, stream: Any = None) -> dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on `device`; tensors move
    there (and pass through when they are there already). With a CUDA
    `stream`, each array goes through pinned memory and is copied
    asynchronously on that stream."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, torch.Tensor):
            out[key] = value.to(device)
            continue
        host = torch.from_numpy(np.ascontiguousarray(value))
        if stream is not None:
            host = host.pin_memory()
            with torch.cuda.stream(stream):
                out[key] = host.to(device, non_blocking=True)
        else:
            out[key] = host.to(device)
    return out


class DevicePrefetcher:
    """Yields `(device_batch, aux)` pairs, the batch already on `device`
    and `aux = host_aux_fn(host_batch)` (None without a function)."""

    def __init__(
        self,
        batches: Iterator[dict] | Callable[[int], Iterator[dict]],
        device: torch.device | str,
        depth: int = 2,
        host_aux_fn: Callable[[dict], Any] | None = None,
    ):
        if callable(batches) and not hasattr(batches, "__next__"):
            batches = batches(0)
        self._batches = iter(batches)
        self._device = torch.device(device)
        self._host_aux_fn = host_aux_fn
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        # written by the worker only, read by the consumer after the
        # sentinel that the same worker enqueues later
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetcher")
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless stopped; False once `close()` was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for batch in self._batches:
                aux = self._host_aux_fn(batch) if self._host_aux_fn else None
                placed = to_device(batch, self._device, self._stream)
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                if not self._put((placed, ready, aux)):
                    return
        except BaseException as e:  # raised on the consumer's thread
            self._error = e
        finally:
            self._put(_SENTINEL)

    def close(self) -> None:
        """Stop the worker and wait for it to end."""
        self._stop.set()
        while True:  # unblock a worker parked on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=60)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set() or self._finished:
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        placed, ready, aux = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for tensor in placed.values():
                tensor.record_stream(consumer)
        return placed, aux
