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

Resilience and telemetry, as JAX's: transient data-source errors
(`OSError` and its kind, `resilience/retry.py`) are retried `retries` times
with exponential backoff from `retry_backoff_s` before they surface, each
retry counted in the registry's `data/retries`; with a factory a retry
rebuilds the stream at the batch being retried, so a generator closed by
its error retries for real. The chaos hook (`chaos_point("data", n)`)
sits before each pull. The registry's `data/produce` timer holds each
successful production (pull, riders, placement) and `data/host_wait` the
consumer's waits on the queue; an optional `heartbeat` is called after
each production (the hang watchdog's `prefetcher` beat). An error the
retries do not absorb is raised on the consumer's `next`, never swallowed
on the worker's thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from llm_training_tpu_torch.resilience.chaos import chaos_point
from llm_training_tpu_torch.resilience.retry import RetryPolicy, retry_call
from llm_training_tpu_torch.telemetry.registry import get_registry

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
        registry: Any | None = None,
        retries: int = 0,
        retry_backoff_s: float = 0.5,
        heartbeat: Callable[[], None] | None = None,
    ):
        if callable(batches) and not hasattr(batches, "__next__"):
            self._factory: Callable[[int], Iterator[dict]] | None = batches
            self._batches = iter(batches(0))
        else:
            self._factory = None
            self._batches = iter(batches)
        self._stream_dirty = False  # an error may have closed the generator
        self._device = torch.device(device)
        self._host_aux_fn = host_aux_fn
        self._heartbeat = heartbeat
        self._retry_policy = RetryPolicy(max_retries=retries, backoff_base_s=retry_backoff_s)
        self._produced = 0  # production index (the chaos site and the retry label)
        self._last_error: BaseException | None = None
        self._last_pull_s = 0.0  # the successful pull time of the newest batch
        registry = registry if registry is not None else get_registry()
        self._produce_timer = registry.timer("data/produce")
        self._wait_timer = registry.timer("data/host_wait")
        self._retry_counter = registry.counter("data/retries")
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

    def _produce_one(self, attempt: int) -> dict:
        """One data-source pull. The chaos hook sits before the pull, so an
        injected fault leaves the source untouched. After an error a
        factory rebuilds the stream at the batch being retried; a plain
        iterator closed by its error ends with the original error once the
        retries are spent, never as a clean end of the stream."""
        if self._stream_dirty and self._factory is not None:
            self._batches = iter(self._factory(self._produced))
            self._stream_dirty = False
        t0 = time.perf_counter()
        try:
            chaos_point("data", step=self._produced)
            batch = next(self._batches)
        except StopIteration:
            if attempt > 0 and self._last_error is not None:
                raise self._last_error
            raise
        except Exception as e:
            self._last_error = e
            self._stream_dirty = True
            raise
        self._last_error = None
        self._stream_dirty = False
        # the successful attempt's pull only: failed attempts and backoff
        # show as data/retries
        self._last_pull_s = time.perf_counter() - t0
        return batch

    def _worker(self) -> None:
        try:
            while True:
                try:
                    batch = retry_call(self._produce_one, self._retry_policy,
                                       label=f"data source (batch {self._produced})",
                                       counter=self._retry_counter)
                except StopIteration:
                    break
                self._produced += 1
                t0 = time.perf_counter()
                aux = self._host_aux_fn(batch) if self._host_aux_fn else None
                placed = to_device(batch, self._device, self._stream)
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                self._produce_timer.add(self._last_pull_s + time.perf_counter() - t0)
                if self._heartbeat is not None:
                    self._heartbeat()
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
        with self._wait_timer.time():
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
