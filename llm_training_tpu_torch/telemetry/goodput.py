"""Goodput ledger: classify fit wall time into phases.

Counterpart of `llm_training_tpu/telemetry/goodput.py` (standard library
only, copied). Every second between `start()` and now is attributed to
exactly one of {compile, data_wait, step_compute, checkpoint_save,
validation, other}: the trainer brackets each activity with
`measure(phase)` and `other` is the unexplained remainder (setup,
host-side bookkeeping), so the phases always sum to the total by
construction. Goodput is the step-compute share of the total.

What the phases hold in the port:

- `compile` has no XLA compile to hold. It holds what stands in for it:
  the kernels' build and load at their first launch
  (`ops/kernels/build.py`: nvcc over `csrc/`, then the library's load) and
  the warm-up of a segment's first micro-step (the allocator's first
  requests, cuBLAS handles), which the trainer bills to `compile`;
- `step_compute` bills device time where the host blocks on it. PyTorch
  launches asynchronously, so the brackets around a micro-step hold its
  launches (and any sync inside it, such as the clip's norm check), and the
  log steps' `.item()` of the metrics holds the device time queued behind
  them, as JAX's `device_get` does;
- `data_wait` is the host blocking on the batch stream (the prefetcher's
  queue).

The clock is injectable so phase classification is unit-testable without
real sleeps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

PHASES = ("compile", "data_wait", "step_compute", "checkpoint_save", "validation")


class GoodputLedger:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: float | None = None  # guarded by: _lock
        self._phase_s: dict[str, float] = {p: 0.0 for p in PHASES}  # guarded by: _lock
        # stack of currently-open measure() phases: the hang watchdog reads
        # the innermost one to say what the loop was stuck inside
        self._open: list[str] = []  # guarded by: _lock
        # cost basis (elastic accounting): the chip count this segment runs
        # on and its $/chip-hour; None keeps summary() to the phases
        self._chip_count: int | None = None  # guarded by: _lock
        self._price_per_chip_hour: float | None = None  # guarded by: _lock

    def set_cost_basis(self, chip_count: int | None = None,
                       price_per_chip_hour: float | None = None) -> None:
        """Tag this ledger segment with its topology cost: `chip_count`
        adds chip-hour gauges to summary(); a price also adds cost_dollars
        and goodput_per_dollar (productive chip-hours bought per dollar).
        The trainer calls this once per fit with its device count."""
        with self._lock:
            self._chip_count = int(chip_count) if chip_count else None
            self._price_per_chip_hour = (
                float(price_per_chip_hour) if price_per_chip_hour else None
            )

    def start(self) -> None:
        """Begin (or restart) accounting; zeroes all phases."""
        with self._lock:
            self._t0 = self._clock()
            self._phase_s = {p: 0.0 for p in PHASES}

    def note(self, phase: str, seconds: float) -> None:
        """Attribute externally measured seconds to a phase."""
        if phase not in self._phase_s:
            raise KeyError(f"unknown goodput phase {phase!r}; expected one of {PHASES}")
        with self._lock:
            self._phase_s[phase] += seconds

    @contextmanager
    def measure(self, phase: str) -> Iterator[None]:
        """Time the enclosed block into `phase`."""
        t0 = self._clock()
        with self._lock:
            self._open.append(phase)
        try:
            yield
        finally:
            with self._lock:
                for i in range(len(self._open) - 1, -1, -1):
                    if self._open[i] == phase:
                        del self._open[i]
                        break
            self.note(phase, self._clock() - t0)

    @property
    def current_phase(self) -> str | None:
        """The innermost phase currently being measured (None outside any
        bracket) — a hang dump's 'what was the loop doing' line."""
        with self._lock:
            return self._open[-1] if self._open else None

    def summary(self) -> dict[str, float]:
        """`goodput/<phase>_s` for every phase (incl. the `other` remainder),
        `goodput/total_s`, and `goodput/goodput_pct`. Phases sum to total
        exactly."""
        with self._lock:
            total = 0.0 if self._t0 is None else self._clock() - self._t0
            tracked = sum(self._phase_s.values())
            out = {f"goodput/{p}_s": s for p, s in self._phase_s.items()}
            out["goodput/other_s"] = max(0.0, total - tracked)
            out["goodput/total_s"] = total
            out["goodput/goodput_pct"] = (
                100.0 * self._phase_s["step_compute"] / total if total > 0 else 0.0
            )
            if self._chip_count:
                chips = self._chip_count
                out["goodput/chip_count"] = float(chips)
                out["goodput/chip_hours"] = total * chips / 3600.0
                out["goodput/productive_chip_hours"] = (
                    self._phase_s["step_compute"] * chips / 3600.0
                )
                if self._price_per_chip_hour:
                    out["goodput/price_per_chip_hour"] = self._price_per_chip_hour
                    cost = out["goodput/chip_hours"] * self._price_per_chip_hour
                    out["goodput/cost_dollars"] = cost
                    # weights each segment by what it cost when aggregated
                    out["goodput/goodput_per_dollar"] = (
                        out["goodput/productive_chip_hours"] / cost if cost > 0 else 0.0
                    )
            return out
