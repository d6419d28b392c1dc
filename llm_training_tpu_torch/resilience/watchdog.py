"""Hang watchdog: turn silent stalls into diagnosable failures.

Counterpart of `llm_training_tpu/resilience/watchdog.py` (standard library
only). A wedged collective (one host lost, a deadlocked barrier, a stuck storage
mount) leaves a TPU-pod job consuming accelerator-hours while making zero
progress and printing nothing — the worst failure mode there is. The
watchdog is a daemon thread fed heartbeats by the train loop (and,
separately, the prefetcher worker); when the *train-loop* beat goes stale
past `timeout_s` it writes a `hang-dump-*.txt` into the run dir with every
Python thread's stack, the goodput ledger's currently-open phase (the
activity the loop is stuck inside), and per-source beat ages — then, with
`action="abort"`, kills the process so a supervisor can relaunch instead of
burning the reservation. Progress re-arms it, so a one-off dump per stall.

JAX's dump also writes the trace ring's flight dump and arms a device
profile under the same tag; the tracer and the profile trigger are not
ported yet (ROADMAP A.7).
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
import time
import traceback
from pathlib import Path

logger = logging.getLogger(__name__)


class HangWatchdog:
    def __init__(
        self,
        timeout_s: float,
        run_dir: str | Path | None = None,
        ledger=None,
        registry=None,
        action: str = "dump",
        poll_interval_s: float | None = None,
        clock=time.monotonic,
        primary_source: str = "train_loop",
    ):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout_s must be > 0, got {timeout_s}")
        if action not in ("dump", "abort"):
            raise ValueError(f"watchdog action must be dump|abort, got {action!r}")
        self.timeout_s = timeout_s
        self.run_dir = Path(run_dir) if run_dir else None
        self.action = action
        # the beat source that arms/disarms the timeout: "train_loop" for a
        # fit, "engine_step" for the serving tier (docs/serving.md) — other
        # sources stay context-only in the dump
        self.primary_source = primary_source
        self._ledger = ledger
        self._registry = registry
        self._clock = clock
        self._poll_s = poll_interval_s or min(max(timeout_s / 4.0, 0.05), 5.0)
        self._beats: dict[str, float] = {}  # guarded by: _lock
        self._steps: dict[str, int] = {}  # guarded by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._dumped = False  # re-armed by the next beat; guarded by: _lock
        self._thread: threading.Thread | None = None  # guarded by: _lock
        self.dump_paths: list[Path] = []  # guarded by: _lock

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "HangWatchdog":
        self.beat(self.primary_source)
        thread = threading.Thread(
            target=self._run, name="hang-watchdog", daemon=True
        )
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # swap under the lock, join outside it: joining while holding the
        # lock would deadlock against a poll thread blocked on beat()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def beat(self, source: str | None = None, step: int | None = None) -> None:
        """Record progress. Only the `primary_source` beat (default
        `train_loop`) arms/disarms the timeout; other sources (prefetcher)
        are context in the dump."""
        if source is None:
            source = self.primary_source
        with self._lock:
            self._beats[source] = self._clock()
            if step is not None:
                self._steps[source] = step
            if source == self.primary_source:
                self._dumped = False

    # ------------------------------------------------------------ polling

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            self._poll_once()

    def _poll_once(self) -> bool:
        """One staleness check; returns True when a dump fired. The check
        and the `_dumped` commit happen in ONE critical section: with two
        separate acquisitions (the original shape), a beat() landing
        between them was clobbered and a now-healthy process could still
        be dumped — and with action='abort', killed
        (tests/test_interleave.py pins the window)."""
        with self._lock:
            last = self._beats.get(self.primary_source)
            if last is None or self._dumped:
                return False
            stalled = self._clock() - last
            if stalled < self.timeout_s:
                return False
            self._dumped = True
        try:
            self.dump(stalled)
        except Exception:  # the watchdog must never kill a healthy run
            logger.exception("hang-dump failed")
        if self.action == "abort":
            logger.critical(
                "watchdog: no %s progress for %.1fs — aborting "
                "so the supervisor can relaunch",
                self.primary_source, stalled,
            )
            os.kill(os.getpid(), signal.SIGABRT)
        return True

    # ------------------------------------------------------------ dumping

    def dump(self, stalled_s: float) -> Path | None:
        """Write the diagnostic dump; returns its path (None when the run
        has no artifact directory — then the dump goes to the log)."""
        content = self._render(stalled_s)
        if self._registry is not None:
            self._registry.counter("resilience/watchdog_dumps").inc()
        if self.run_dir is None:
            logger.error("watchdog stall (no run dir for the dump):\n%s", content)
            return None
        self.run_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = self.run_dir / f"hang-dump-{stamp}.txt"
        path.write_text(content)
        with self._lock:
            # dump() fires on the poll thread while tests/smokes poll
            # dump_paths from the main thread — list append is atomic, but
            # the guarded-by contract keeps every mutation accountable
            self.dump_paths.append(path)
        logger.error(
            "watchdog: no %s progress for %.1fs — thread stacks "
            "dumped to %s", self.primary_source, stalled_s, path,
        )
        return path

    def _render(self, stalled_s: float) -> str:
        now = self._clock()
        with self._lock:
            beats = dict(self._beats)
            steps = dict(self._steps)
        lines = [
            f"HANG DUMP — no {self.primary_source} heartbeat for "
            f"{stalled_s:.1f}s (timeout {self.timeout_s:.1f}s)",
            f"wall time: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        ]
        phase = getattr(self._ledger, "current_phase", None)
        lines.append(f"goodput phase open at stall: {phase or '<none>'}")
        for source, t in sorted(beats.items()):
            step = steps.get(source)
            lines.append(
                f"last beat [{source}]: {now - t:.1f}s ago"
                + (f" (step {step})" if step is not None else "")
            )
        lines.append("")
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            lines.append(f"--- thread {names.get(tid, '?')} (id {tid}) ---")
            lines.extend(
                line.rstrip("\n") for line in traceback.format_stack(frame)
            )
            lines.append("")
        return "\n".join(lines)
