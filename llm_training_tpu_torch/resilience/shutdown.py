"""Preemption-safe graceful shutdown.

Counterpart of `llm_training_tpu/resilience/shutdown.py` (standard
library only). A scheduler evicts a job by delivering SIGTERM, waiting out
a grace window, then killing it. `GracefulShutdown` turns the signal into
a clean, *resumable* exit: the handler only sets a flag, the trainer checks
it at the next optimizer-step boundary, commits an emergency checkpoint
(waiting out the async-save barrier), and raises `PreemptionInterrupt`,
which the CLI maps to `RESUMABLE_EXIT_CODE` so a supervisor can tell
"relaunch me" from a real failure.

Handlers are installed from the main thread only (`signal.signal` raises
elsewhere; a fit driven from another thread runs without them). The port's
fit is one process: JAX's broadcast of process 0's flag across hosts waits
for the port's mesh (ROADMAP A.9), and `should_stop` reads the local flag.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

logger = logging.getLogger(__name__)

# BSD EX_TEMPFAIL: "temporary failure, retry later" — the supervisor
# contract for "emergency checkpoint committed, relaunch to resume"
RESUMABLE_EXIT_CODE = 75


class PreemptionInterrupt(RuntimeError):
    """Raised by Trainer.fit after the emergency checkpoint is committed;
    the run is resumable from the step it carries."""

    def __init__(self, step: int | None, message: str):
        super().__init__(message)
        self.step = step


class GracefulShutdown:
    """Installs SIGTERM/SIGINT handlers that request a checkpoint-then-exit
    at the next step boundary. A second signal restores the previous
    handlers and re-raises, so a stuck save can still be interrupted."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._requested = threading.Event()
        self._signum: int | None = None
        self._previous: dict[int, object] = {}
        self.installed = False

    # ------------------------------------------------------------ handlers

    def install(self) -> "GracefulShutdown":
        try:
            for signum in self.SIGNALS:
                self._previous[signum] = signal.signal(signum, self._handler)
            self.installed = True
        except ValueError:
            # signal.signal only works in the main thread — a fit driven
            # from a worker thread runs without preemption handling
            self._previous.clear()
            logger.warning(
                "not in the main thread: preemption signal handlers "
                "unavailable for this fit"
            )
        return self

    def uninstall(self) -> None:
        for signum, previous in self._previous.items():
            try:
                signal.signal(signum, previous)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False

    def _handler(self, signum, frame) -> None:
        # NO logging in here: the handler runs on whatever frame the signal
        # interrupted — if that frame was inside a buffered-stream write
        # (the per-step log line), logger.* would re-enter the stream and
        # CPython raises "reentrant call inside BufferedWriter" INTO the
        # train loop, aborting the fit without the grace path. os.write to
        # stderr is safe; the full warning is logged at the step boundary.
        if self._requested.is_set():
            self.uninstall()
            os.write(
                2,
                b"second signal during graceful shutdown - restoring "
                b"default handlers and re-raising\n",
            )
            signal.raise_signal(signum)
            return
        self._signum = signum
        self._requested.set()
        os.write(
            2,
            (
                f"received {signal.Signals(signum).name}: emergency "
                f"checkpoint at the next step boundary, then resumable "
                f"exit (code {RESUMABLE_EXIT_CODE})\n"
            ).encode(),
        )

    # ------------------------------------------------------------ queries

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self) -> None:
        """Programmatic trigger (tests, in-process supervisors)."""
        self._requested.set()

    @property
    def reason(self) -> str:
        if self._signum is None:
            return "shutdown requested"
        return signal.Signals(self._signum).name

    def should_stop(self, step: int, sync_every: int = 1) -> bool:
        """Boundary check the trainer calls once per optimizer step: the
        local flag (one process; `sync_every` is JAX's multihost broadcast
        cadence, kept for its signature)."""
        return self._requested.is_set()
