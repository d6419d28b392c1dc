"""Resilience around `fit`: preemption, retries, the hang watchdog,
rollback-and-skip recovery, checkpoint durability, crash-restart
supervision, elastic planning and fault injection.

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
- **Crash-restart supervision** (`supervisor.py` + the `supervise`
  command): relaunch `fit` on exit 75 and on hard deaths (SIGKILL/OOM,
  segfault, the watchdog's SIGABRT) with a restart budget, exponential
  backoff and a `supervisor.jsonl` event log.
- **Elastic planning** (`elastic.py`): the topology planner, the data
  continuity check at resume, each segment's `segment_topology` event and
  the goodput ledger's cost basis; the planner runs over the live world
  (the process group's ranks) and a resume onto other degrees reshards
  through DCP.
- **Checkpoint durability** (`durability.py`): sha256 integrity manifests
  beside every committed step, verify-before-restore, an async mirror
  daemon with retention GC and a scrubber, `.stale/` staging of forced
  saves, and the `ckpt` command.
- **Fault injection** (`chaos.py`): the triggers of the sites above, of
  the serving tier and of the router.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
from llm_training_tpu_torch.resilience.durability import (
    MirrorDaemon,
    VerifyResult,
    build_manifest,
    committed_steps,
    corrupt_step,
    mirror_step,
    retention_victims,
    verify_step,
    write_manifest,
)
from llm_training_tpu_torch.resilience.elastic import (
    ElasticConfig,
    ElasticTopologyError,
    TopologyPlan,
    chaos_device_limit,
    check_data_continuity,
    log_segment_topology,
    plan_topology,
    resolve_chip_price,
    segment_attempt,
    visible_device_count,
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
from llm_training_tpu_torch.resilience.supervisor import (
    Supervisor,
    SupervisorConfig,
    build_fit_argv,
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
    # elastic planning: with this block set, fit plans its topology against
    # the live world (the process group's ranks; a plan that leaves ranks
    # idle raises). None (default) = the config's mesh as it is
    elastic: ElasticConfig | None = None
    # fault injection (off unless a trigger is set); LLMT_CHAOS_* env vars
    # overlay it at fit start
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def __post_init__(self):
        if isinstance(self.elastic, dict):
            self.elastic = ElasticConfig(**self.elastic)
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
    "ElasticConfig",
    "ElasticTopologyError",
    "GracefulShutdown",
    "HangWatchdog",
    "MirrorDaemon",
    "PreemptionInterrupt",
    "RecoveryConfig",
    "RecoveryExhaustedError",
    "RecoveryManager",
    "ResilienceConfig",
    "RetryPolicy",
    "Supervisor",
    "SupervisorConfig",
    "TopologyPlan",
    "VerifyResult",
    "build_fit_argv",
    "build_manifest",
    "chaos_device_limit",
    "chaos_point",
    "check_data_continuity",
    "committed_steps",
    "config_from_env",
    "cooldown_schedule",
    "corrupt_step",
    "get_chaos",
    "install_chaos",
    "is_transient",
    "log_segment_topology",
    "mirror_step",
    "plan_topology",
    "resolve_chip_price",
    "retention_victims",
    "retry_call",
    "segment_attempt",
    "uninstall_chaos",
    "verify_step",
    "visible_device_count",
    "write_manifest",
]
