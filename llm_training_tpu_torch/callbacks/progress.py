"""Resume-aware single-line training progress display.

Counterpart of `llm_training_tpu/callbacks/progress.py` (standard library
only; a dataclass config): a dependency-free `\r` status line with
step/total, percent, steps/s, tokens/s, the latest log step's loss and an
ETA from the steps completed *this run* -- the resume offset is excluded
from the rate so the ETA stays honest after a restore.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass


@dataclass
class ProgressBarConfig:
    # minimum seconds between redraws (the step loop can run >10/s; drawing
    # every step would dominate the host thread)
    refresh_rate: float = 0.5
    # auto-disable when stdout is not a TTY (log files, CI); force with True
    force: bool = False

    def __post_init__(self):
        if not self.refresh_rate > 0:
            raise ValueError(f"refresh_rate must be > 0, got {self.refresh_rate}")


def _fmt_duration(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


class ProgressBar:
    def __init__(self, config: ProgressBarConfig | None = None):
        self.config = config or ProgressBarConfig()
        self._stream = sys.stdout
        self._enabled = False
        self._start_step = 0
        self._start_time = 0.0
        self._start_tokens = 0
        self._last_draw = 0.0
        self._last_loss: float | None = None
        self._drew = False

    def on_fit_start(self, trainer, objective, datamodule, start_step) -> None:
        # the bar is terminal furniture, not log content: write to the
        # process's ORIGINAL stdout so OutputRedirection's tee never records
        # the \r redraws into the persistent run log. force=True keeps the
        # current sys.stdout so tests (and piped verifies) can capture it.
        self._stream = (
            sys.stdout
            if self.config.force or sys.__stdout__ is None
            else sys.__stdout__
        )
        self._enabled = self.config.force or self._stream.isatty()
        self._start_step = start_step  # resume offset: rate counts this run only
        self._start_time = time.perf_counter()
        self._start_tokens = trainer.counters.get("consumed_tokens", 0)
        self._last_draw = 0.0
        self._drew = False

    def on_train_step(self, trainer, step) -> None:
        if not self._enabled:
            return
        now = time.perf_counter()
        if now - self._last_draw < self.config.refresh_rate:
            return
        self._last_draw = now
        total = trainer.config.max_steps
        done_this_run = step - self._start_step
        elapsed = now - self._start_time
        rate = done_this_run / elapsed if elapsed > 0 else 0.0
        tokens = trainer.counters.get("consumed_tokens", 0) - self._start_tokens
        tok_rate = tokens / elapsed if elapsed > 0 else 0.0
        eta = (total - step) / rate if rate > 0 else float("inf")
        parts = [
            f"step {step}/{total} ({100.0 * step / total:.0f}%)",
            f"{rate:.2f} it/s",
            f"{tok_rate:,.0f} tok/s",
        ]
        if self._last_loss is not None:
            parts.append(f"loss {self._last_loss:.4f}")
        if eta != float("inf"):
            parts.append(f"ETA {_fmt_duration(eta)}")
        line = " | ".join(parts)
        self._stream.write("\r\x1b[2K" + line)
        self._stream.flush()
        self._drew = True

    def on_step_end(self, trainer, step, metrics) -> None:
        try:
            self._last_loss = float(metrics.get("loss"))
        except (TypeError, ValueError):
            pass

    def on_fit_end(self, trainer, state) -> None:
        if self._drew:
            self._stream.write("\n")
            self._stream.flush()
            self._drew = False

    def teardown(self) -> None:
        # restore the terminal even when fit raises mid-run
        self.on_fit_end(None, None)
