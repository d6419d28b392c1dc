"""Resilience around `fit`: preemption, retries, the hang watchdog,
rollback-and-skip recovery and fault injection.

Counterpart of the part of `llm_training_tpu/resilience/` that the
trainer's fit runs:

- **Preemption handling** (`shutdown.py`): SIGTERM/SIGINT -> emergency
  checkpoint at the next step boundary -> `PreemptionInterrupt` ->
  `RESUMABLE_EXIT_CODE` (75) from the CLI.
- **Retries** (`retry.py` + the prefetcher): exponential-backoff retries of
  transient data-source errors, counted in `data/retries`.
- **Hang watchdog** (`watchdog.py`): a heartbeat-fed daemon that dumps
  every thread's stack and the open goodput phase when the train loop
  stops making progress, optionally aborting.
- **In-process recovery** (`recovery.py`): NanGuard divergence -> rollback
  to the last committed checkpoint without exiting, skip the poisoned data
  window, optional LR cooldown, escalate when the budget runs out
  (`RecoveryExhaustedError` -> exit 76; a guard's own raise exits 77 for a
  spike and 78 for a non-finite loss).
- **Fault injection** (`chaos.py`): the triggers of the sites above.

Not ported yet: checkpoint durability, the supervisor, elastic resume and
the rest of the chaos triggers (ROADMAP A.4); `ResilienceConfig.elastic`
raises `NotImplementedError` when set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from llm_training_tpu_torch.resilience.chaos import (
    Chaos,
    ChaosConfig,
    ChaosError,
    chaos_point,
    config_from_env,
    get_chaos,
    install_chaos,
    uninstall_chaos,
)
from llm_training_tpu_torch.resilience.recovery import (
    LOSS_SPIKE_EXIT_CODE,
    NON_FINITE_EXIT_CODE,
    RECOVERY_EXHAUSTED_EXIT_CODE,
    DataSkipList,
    RecoveryConfig,
    RecoveryExhaustedError,
    RecoveryManager,
    cooldown_schedule,
)
from llm_training_tpu_torch.resilience.retry import (
    TRANSIENT_EXCEPTIONS,
    RetryPolicy,
    is_transient,
    retry_call,
)
from llm_training_tpu_torch.resilience.shutdown import (
    RESUMABLE_EXIT_CODE,
    GracefulShutdown,
    PreemptionInterrupt,
)
from llm_training_tpu_torch.resilience.watchdog import HangWatchdog


@dataclass
class ResilienceConfig:
    """Trainer-level knobs (`trainer.resilience.*`), with JAX's defaults
    and validation."""

    # install SIGTERM/SIGINT handlers for the duration of fit (main thread
    # only; unavailable elsewhere)
    handle_signals: bool = True
    # no-progress timeout before the watchdog dumps thread stacks;
    # None/0 disables the watchdog. Size it well above the slowest healthy
    # step + checkpoint save
    watchdog_timeout_s: float | None = None
    # dump = write the hang dump and keep waiting; abort = dump then SIGABRT
    watchdog_action: str = "dump"
    # JAX's multihost cadence of the preemption-flag broadcast; the port's
    # fit is one process and reads its own flag every step
    preemption_sync_every_n_steps: int = 1
    # transient data-source errors retried by the prefetcher before
    # surfacing; 0 fails fast
    data_retries: int = 0
    data_retry_backoff_s: float = 0.5
    # in-process rollback-and-skip recovery; None (default) fails fast, the
    # data stream byte-identical to a recovery-less run
    recovery: RecoveryConfig | None = None
    # elastic resume: not ported yet (ROADMAP A.4)
    elastic: Any = None
    # fault injection (off unless a trigger is set); LLMT_CHAOS_* env vars
    # overlay it at fit start
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def __post_init__(self):
        if self.elastic is not None:
            raise NotImplementedError(
                "resilience.elastic is not ported yet (ROADMAP A.4): the port's fit runs "
                "on the mesh its config names"
            )
        if self.watchdog_action not in ("dump", "abort"):
            raise ValueError(f"watchdog_action must be dump or abort, got {self.watchdog_action!r}")
        checks = (
            (self.preemption_sync_every_n_steps >= 1, "preemption_sync_every_n_steps must be >= 1"),
            (self.data_retries >= 0, "data_retries must be >= 0"),
            (self.data_retry_backoff_s >= 0, "data_retry_backoff_s must be >= 0"),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(f"resilience: {message}")


__all__ = [
    "LOSS_SPIKE_EXIT_CODE",
    "NON_FINITE_EXIT_CODE",
    "RECOVERY_EXHAUSTED_EXIT_CODE",
    "RESUMABLE_EXIT_CODE",
    "TRANSIENT_EXCEPTIONS",
    "Chaos",
    "ChaosConfig",
    "ChaosError",
    "DataSkipList",
    "GracefulShutdown",
    "HangWatchdog",
    "PreemptionInterrupt",
    "RecoveryConfig",
    "RecoveryExhaustedError",
    "RecoveryManager",
    "ResilienceConfig",
    "RetryPolicy",
    "chaos_point",
    "config_from_env",
    "cooldown_schedule",
    "get_chaos",
    "install_chaos",
    "is_transient",
    "retry_call",
    "uninstall_chaos",
]
