"""Thread-safe per-host metric registry: counters, gauges, timers.

Counterpart of `llm_training_tpu/telemetry/registry.py` (standard library
only). The trainer owns one registry per fit; producer threads (the device
prefetcher) record into it concurrently with the step loop, and its
`snapshot()` is merged into the metrics dict on log steps, so the JSONL
logger persists it. A module-level *current* registry lets components
constructed apart from the trainer find the active run's registry without
plumbing.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator


class Counter:
    """Monotonic accumulator (events, bytes, items)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0  # guarded by: _lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (HBM bytes, compile seconds)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value: float | None = None  # guarded by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float | None:
        with self._lock:
            return self._value


class Timer:
    """Accumulated duration + invocation count; use as a context manager."""

    __slots__ = ("_lock", "total_s", "count", "_clock")

    def __init__(self, lock: threading.RLock, clock=time.perf_counter):
        self._lock = lock
        self._clock = clock
        self.total_s = 0.0  # guarded by: _lock
        self.count = 0  # guarded by: _lock

    def add(self, seconds: float) -> None:
        with self._lock:
            self.total_s += seconds
            self.count += 1

    @contextmanager
    def time(self) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(self._clock() - t0)


class TelemetryRegistry:
    """Create-on-access metric registry. All mutation goes through one RLock,
    so any thread may record; `snapshot()` flattens everything into a
    `{name: float}` dict (timers emit `<name>_s` and `<name>_n`)."""

    def __init__(self, clock=time.perf_counter):
        self._lock = threading.RLock()
        self._clock = clock
        self._counters: dict[str, Counter] = {}  # guarded by: _lock
        self._gauges: dict[str, Gauge] = {}  # guarded by: _lock
        self._timers: dict[str, Timer] = {}  # guarded by: _lock

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(self._lock))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(self._lock))

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer(self._lock, self._clock))

    def snapshot(self) -> dict[str, float]:
        """Every metric as `{name: float}` under ONE lock hold, so a reader
        landing mid-write never observes a torn metric (a Timer's `_s`/`_n`
        pair moves together); a gauge never set is left out."""
        with self._lock:
            values: dict[str, float] = {}
            for name, counter in self._counters.items():
                values[name] = counter._value
            for name, gauge in self._gauges.items():
                if gauge._value is not None:
                    values[name] = gauge._value
            for name, timer in self._timers.items():
                values[name + "_s"] = timer.total_s
                values[name + "_n"] = float(timer.count)
            return values


# ---------------------------------------------------------------- current
# A plain module global (not a contextvar): worker threads spawned inside a
# fit must see the fit's registry, and new threads do not inherit contextvars.
_default_registry = TelemetryRegistry()
_current_registry = _default_registry  # guarded by: _current_lock
_current_lock = threading.Lock()


def get_registry() -> TelemetryRegistry:
    """The active run's registry (a process-default one outside any fit)."""
    return _current_registry


def set_registry(registry: TelemetryRegistry) -> TelemetryRegistry:
    """Install `registry` as current; returns the previous one (restore it
    in a finally)."""
    global _current_registry
    with _current_lock:
        previous = _current_registry
        _current_registry = registry
        return previous
