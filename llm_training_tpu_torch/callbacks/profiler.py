"""Trace capture over a step window, with `torch.profiler`.

Counterpart of `llm_training_tpu/callbacks/profiler.py`: JAX's step window
[start_step, start_step + num_steps), clamped to the fit's last step, over
`torch.profiler` with the CPU activity and, on a CUDA fit, the CUDA one.
The trace is written as a Chrome trace (`trace.json`, readable by Perfetto
and `chrome://tracing`) into `trace_dir`: by default
`<run_dir>/profile-window-<start>`, the run directory of the fit's logger
or checkpointer (`telemetry.anomaly.resolve_run_dir`), else
`runs/profile`. `teardown` stops a trace that is still open, so a fit that
raises inside the window leaves no profiler running.

Inside a fit the window goes to the fit's `ProfileTrigger`
(`telemetry/profiling.py`), as JAX's does: the trainer reads
`profile_window()` at fit start, schedules it on the trigger and marks the
callback `_absorbed`, so one owner starts and stops `torch.profiler` and a
capture an SLO breach fires never nests inside the window's. The callback
owns its capture only where no trigger exists (outside a trainer's fit).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import torch

from llm_training_tpu_torch.telemetry.anomaly import resolve_run_dir

logger = logging.getLogger(__name__)

# the fallback when the fit has no run directory
DEFAULT_TRACE_DIR = "runs/profile"


@dataclass
class ProfilerCallbackConfig:
    # None = inside the run directory (DEFAULT_TRACE_DIR without one)
    trace_dir: str | None = None
    start_step: int = 5  # past the kernels' build and the warm-up
    num_steps: int = 3


class ProfilerCallback:
    def __init__(self, config: ProfilerCallbackConfig | None = None):
        self.config = config or ProfilerCallbackConfig()
        self._profiler: torch.profiler.profile | None = None
        self._stop_step: int | None = None
        self.trace_path: Path | None = None
        # set by the trainer when the window was handed to its ProfileTrigger
        self._absorbed = False

    def profile_window(self) -> tuple[int, int, str | None]:
        """The configured capture window, for a ProfileTrigger to adopt."""
        cfg = self.config
        return cfg.start_step, cfg.num_steps, cfg.trace_dir

    def on_train_step(self, trainer, step) -> None:
        if self._absorbed:
            return
        cfg = self.config
        if self._profiler is None and cfg.start_step <= step < cfg.start_step + cfg.num_steps:
            # the stop boundary clamped to the fit's last step, so the trace
            # stops inside the loop
            stop_step = cfg.start_step + cfg.num_steps
            max_steps = getattr(getattr(trainer, "config", None), "max_steps", None)
            if max_steps is not None:
                stop_step = min(stop_step, max_steps)
            if step >= stop_step:
                logger.warning("profiler window [%d, %d) truncated to nothing at step %d; "
                               "not tracing", cfg.start_step, cfg.start_step + cfg.num_steps, step)
                return
            if cfg.trace_dir is None:
                run_dir = resolve_run_dir(trainer)
                cfg.trace_dir = str(run_dir / f"profile-window-{cfg.start_step}"
                                    if run_dir is not None else DEFAULT_TRACE_DIR)
            self._stop_step = stop_step
            activities = [torch.profiler.ProfilerActivity.CPU]
            device = getattr(trainer, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            logger.info("profiler trace started at step %d -> %s", step, cfg.trace_dir)
        elif self._profiler is not None and self._stop_step is not None and step >= self._stop_step:
            self._stop()
            logger.info("profiler trace stopped at step %d -> %s", step, self.trace_path)

    def _stop(self) -> None:
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        directory = Path(self.config.trace_dir)
        directory.mkdir(parents=True, exist_ok=True)
        self.trace_path = directory / "trace.json"
        profiler.export_chrome_trace(str(self.trace_path))

    def on_fit_end(self, trainer, state) -> None:
        self.teardown()

    def teardown(self) -> None:
        if self._profiler is not None:
            self._stop()
