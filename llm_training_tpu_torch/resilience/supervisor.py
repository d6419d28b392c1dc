"""Crash-restart supervisor: the recovery layer for deaths no in-process
code can survive.

Counterpart of `llm_training_tpu/resilience/supervisor.py` (a dataclass
where JAX's config is a pydantic model). The `supervise` command runs
`fit` as a child process (`python -m llm_training_tpu_torch fit ...`) and
relaunches it:

- **exit 0**: run complete, the supervisor exits 0;
- **exit 75** (`RESUMABLE_EXIT_CODE`): preempted after committing an
  emergency checkpoint; relaunch the same command, which resumes;
- **negative returncode** (the child died on a signal: SIGKILL -9,
  SIGSEGV -11, the watchdog's SIGABRT -6): a hard death; relaunch, and the
  restore ladder skips anything the death left broken;
- **any other exit** (76/77/78, the recovery-escalation codes, among
  them): a real failure a blind relaunch would reproduce; give up and
  propagate the child's code.

Restarts are budgeted (`max_restarts`) with exponential backoff that
resets after a healthy child, the environment passes through to every
child, and every lifecycle event appends to `supervisor.jsonl`. Every
child gets `LLMT_SUPERVISOR_ATTEMPT` (1-based) and `LLMT_SUPERVISOR_LOG`,
so each fit segment appends its own `segment_topology` event.

With `min_devices` set, each relaunch first probes the visible CUDA device
count in a subprocess and waits with backoff while the pool is below the
minimum. The supervisor itself never initializes CUDA: it must not hold
the card its child needs. Supervising `serve` waits for the request
journal (ROADMAP A.7).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

from llm_training_tpu_torch.resilience.elastic import ATTEMPT_ENV, SUPERVISOR_LOG_ENV
from llm_training_tpu_torch.resilience.shutdown import RESUMABLE_EXIT_CODE

logger = logging.getLogger(__name__)


@dataclass
class SupervisorConfig:
    # restarts (not launches) before giving up and propagating the child's
    # last exit code
    max_restarts: int = 10
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 300.0
    # a child that ran at least this long before dying resets the backoff
    # (the next death is a fresh incident, not a crash loop)
    healthy_runtime_s: float = 600.0
    # exit codes that mean "relaunch me" (75 = preempted-but-resumable)
    restart_codes: tuple[int, ...] = (RESUMABLE_EXIT_CODE,)
    # relaunch on signal deaths (SIGKILL/OOM, SIGSEGV, watchdog SIGABRT)
    restart_on_signals: bool = True
    # supervisor.jsonl event log (None = no log file; events still go to
    # the logger)
    log_path: str | None = None
    # capacity gating: before each RELAUNCH, probe the visible device count
    # (in a subprocess) and wait while it is below min_devices; give up
    # after probe_max_wait_s. None relaunches blind
    min_devices: int | None = None
    probe_backoff_s: float = 5.0
    probe_max_wait_s: float = 300.0

    def __post_init__(self):
        self.restart_codes = tuple(int(c) for c in self.restart_codes)
        checks = (
            (self.max_restarts >= 0, "max_restarts must be >= 0"),
            (self.backoff_base_s >= 0, "backoff_base_s must be >= 0"),
            (self.backoff_factor >= 1, "backoff_factor must be >= 1"),
            (self.backoff_max_s >= 0, "backoff_max_s must be >= 0"),
            (self.healthy_runtime_s >= 0, "healthy_runtime_s must be >= 0"),
            (self.min_devices is None or self.min_devices >= 1, "min_devices must be >= 1"),
            (self.probe_backoff_s >= 0, "probe_backoff_s must be >= 0"),
            (self.probe_max_wait_s >= 0, "probe_max_wait_s must be >= 0"),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(f"supervisor: {message}")


def _signal_name(returncode: int) -> str | None:
    if returncode >= 0:
        return None
    try:
        return signal.Signals(-returncode).name
    except ValueError:
        return f"signal {-returncode}"


def _exit_code(rc: int) -> int:
    """A subprocess returncode as a propagatable exit code: signal deaths
    (negative) become the shell convention 128+signum."""
    return 128 - rc if rc < 0 else rc


class Supervisor:
    """Runs `argv` as a child process under the restart policy above.

    `env` overlays the inherited environment; `sleep`, `run_child`,
    `clock` and `probe` are injection points for tests."""

    def __init__(
        self,
        argv: Sequence[str],
        config: SupervisorConfig | None = None,
        env: dict[str, str] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        run_child: Callable[[list[str]], int] | None = None,
        clock: Callable[[], float] = time.monotonic,
        relaunch_argv: Sequence[str] | None = None,
        probe: Callable[[], int | None] | None = None,
    ):
        self.argv = list(argv)
        # relaunches may need another command than the first launch (an
        # explicit --ckpt-path must not rewind every restart)
        self.relaunch_argv = list(relaunch_argv) if relaunch_argv else self.argv
        self.config = config or SupervisorConfig()
        self.env = {**os.environ, **(env or {})}
        # the children's segment_topology events land in THIS supervisor's
        # log: an inherited value must not win, nor survive a disabled log
        if self.config.log_path:
            self.env[SUPERVISOR_LOG_ENV] = str(Path(self.config.log_path).absolute())
        else:
            self.env.pop(SUPERVISOR_LOG_ENV, None)
        self._sleep = sleep
        self._clock = clock
        self._run_child = run_child or self._spawn
        self._probe = probe or self._probe_devices
        self.restarts = 0
        self.events: list[dict] = []  # in-memory mirror of supervisor.jsonl

    # ------------------------------------------------------------ plumbing

    def _spawn(self, argv: list[str]) -> int:
        return subprocess.call(argv, env=self.env)

    def _probe_devices(self) -> int | None:
        """Visible device count as the NEXT child would see it (the probe
        inherits the child env, so the chaos device schedule applies).
        None = unknowable (a broken probe), which the capacity gate treats
        as 'proceed'."""
        code = ("from llm_training_tpu_torch.resilience.elastic import "
                "visible_device_count; print(visible_device_count())")
        # a hung probe must not stall the relaunch past the capacity wait
        timeout_s = min(300.0, max(5.0, self.config.probe_max_wait_s))
        try:
            out = subprocess.run([sys.executable, "-c", code], env=self.env,
                                 capture_output=True, text=True, timeout=timeout_s)
            if out.returncode != 0:
                logger.warning("device probe failed (rc %d): %s", out.returncode,
                               out.stderr.strip()[-500:])
                return None
            return int(out.stdout.strip().splitlines()[-1])
        except (OSError, subprocess.TimeoutExpired, ValueError, IndexError) as e:
            logger.warning("device probe failed: %s", e)
            return None

    def _await_capacity(self, next_attempt: int) -> tuple[bool, int | None]:
        """Block (with backoff) until the visible device count reaches
        min_devices, the probe proves unknowable, or probe_max_wait_s runs
        out. Returns (proceed, last_count)."""
        cfg = self.config
        self.env[ATTEMPT_ENV] = str(next_attempt)
        deadline = self._clock() + cfg.probe_max_wait_s
        while True:
            count = self._probe()
            self._log("probe", attempt=next_attempt, devices=count,
                      min_devices=cfg.min_devices)
            if count is None or count >= cfg.min_devices:
                return True, count
            if self._clock() >= deadline:
                return False, count
            self._log("capacity_wait", devices=count, min_devices=cfg.min_devices,
                      backoff_s=cfg.probe_backoff_s)
            if cfg.probe_backoff_s > 0:
                self._sleep(cfg.probe_backoff_s)

    def _log(self, event: str, **fields: Any) -> None:
        record = {"ts": time.time(), "event": event, **fields}
        self.events.append(record)
        logger.info("supervisor: %s %s", event, fields)
        if self.config.log_path:
            try:
                path = Path(self.config.log_path)
                path.parent.mkdir(parents=True, exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            except OSError:
                logger.exception("supervisor: could not append %s", event)

    def _should_restart(self, rc: int) -> tuple[bool, str]:
        if rc in self.config.restart_codes:
            return True, f"resumable exit {rc}"
        name = _signal_name(rc)
        if name is not None and self.config.restart_on_signals:
            return True, f"hard death ({name})"
        if name is not None:
            return False, f"hard death ({name}), restart_on_signals off"
        return False, f"non-resumable exit {rc}"

    # ------------------------------------------------------------ main loop

    def run(self) -> int:
        cfg = self.config
        consecutive = 0  # backoff exponent; healthy runtimes reset it
        attempt = 0
        while True:
            attempt += 1
            argv = self.argv if attempt == 1 else self.relaunch_argv
            self.env[ATTEMPT_ENV] = str(attempt)
            self._log("launch", attempt=attempt, argv=argv)
            t0 = self._clock()
            rc = self._run_child(argv)
            runtime_s = self._clock() - t0
            self._log("exit", attempt=attempt, rc=rc, signal=_signal_name(rc),
                      runtime_s=round(runtime_s, 3))
            if rc == 0:
                self._log("complete", attempts=attempt, restarts=self.restarts)
                return 0
            restart, reason = self._should_restart(rc)
            if not restart:
                self._log("giveup", rc=rc, reason=reason)
                return _exit_code(rc)
            if self.restarts >= cfg.max_restarts:
                self._log("giveup", rc=rc,
                          reason=f"restart budget exhausted ({cfg.max_restarts})")
                return _exit_code(rc)
            if runtime_s >= cfg.healthy_runtime_s:
                consecutive = 0
            delay = min(cfg.backoff_base_s * (cfg.backoff_factor ** consecutive),
                        cfg.backoff_max_s)
            consecutive += 1
            self.restarts += 1
            self._log("restart", attempt=attempt + 1, reason=reason,
                      backoff_s=round(delay, 3), restarts=self.restarts)
            if delay > 0:
                self._sleep(delay)
            if cfg.min_devices:
                proceed, count = self._await_capacity(attempt + 1)
                if not proceed:
                    self._log("giveup", rc=rc, reason=(
                        f"insufficient devices ({count} < min_devices "
                        f"{cfg.min_devices}) after {cfg.probe_max_wait_s}s of waiting"))
                    return _exit_code(rc)


def build_fit_argv(
    config_path: str,
    overrides: Sequence[str] = (),
    ckpt_path: str | None = None,
) -> list[str]:
    """The child `fit` command: this interpreter, this package, the same
    config and overrides. `ckpt_path` (first launch only: pass it to the
    Supervisor's `argv`, not `relaunch_argv`) pins an explicit resume step;
    relaunches restore the newest checkpoint."""
    argv = [sys.executable, "-m", "llm_training_tpu_torch", "fit", "--config", config_path]
    if ckpt_path:
        argv += ["--ckpt-path", str(ckpt_path)]
    argv += list(overrides)
    return argv

