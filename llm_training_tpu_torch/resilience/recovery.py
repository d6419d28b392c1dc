"""In-process rollback-and-skip recovery: self-healing training.

Counterpart of `llm_training_tpu/resilience/recovery.py` (dataclasses
where JAX's configs are pydantic models; the LR cooldown a plain function
of the schedule's count). A detected divergence (NanGuard's
`NonFiniteLossError` or `LossSpikeError`) rewinds to a good checkpoint,
skips the offending data window and continues, without leaving the
process. Three pieces, wired through `Trainer._fit_inner`:

- **`RecoveryConfig`** (`trainer.resilience.recovery`): the rollback budget
  (`max_rollbacks`), the data window skipped per rollback
  (`skip_window_steps`), an optional temporary LR cooldown
  (`lr_cooldown_factor` / `lr_cooldown_steps`), the same-step escalation
  threshold (`escalate_after`), preset `skip_windows` and the replacement
  `reserve_batches`. Unset (the default) builds none of this.

- **`DataSkipList`**: the poisoned micro-step windows. The deterministic
  `(seed, step)` stream (`data/base.py`) consults it: the LAST `reserve`
  batches of every epoch permutation are held out as a replacement pool,
  and a skipped step draws its batch from that pool (the j-th skipped step
  of an epoch takes the j-th reserved batch). The stream stays a pure
  function of `(seed, step, windows, reserve)`; the windows and reserve
  persist in checkpoint metadata, so a resume replays the same skips.

- **`RecoveryManager`**: detect -> rollback -> skip -> cooldown ->
  escalate. Budget exhaustion (or `escalate_after` consecutive failures at
  the same optimizer step) raises `RecoveryExhaustedError`, which the CLI
  maps to `RECOVERY_EXHAUSTED_EXIT_CODE`.

The cooldown multiplies the base schedule by `lr_cooldown_factor` for
`lr_cooldown_steps` optimizer steps after the rollback point; only the
schedule is re-wrapped, never the optimizer state.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Sequence

logger = logging.getLogger(__name__)

# CLI exit-code contract (docs/resilience.md#exit-codes), alongside
# shutdown.RESUMABLE_EXIT_CODE (75): a supervisor relaunches on 75 (and on
# hard deaths); the codes below mean "a human or a config change is needed"
# — blind relaunch would reproduce the failure.
RECOVERY_EXHAUSTED_EXIT_CODE = 76
LOSS_SPIKE_EXIT_CODE = 77
NON_FINITE_EXIT_CODE = 78


class RecoveryExhaustedError(RuntimeError):
    """The rollback budget is spent (or the same step kept failing):
    in-process recovery gives up and escalates to fail-fast."""

    def __init__(self, message: str, step: int | None = None):
        super().__init__(message)
        self.step = step


@dataclass
class RecoveryConfig:
    """`trainer.resilience.recovery.*` -- unset disables in-process recovery
    entirely (and keeps the data stream byte-identical to a recovery-less
    run). JAX's defaults and bounds."""

    # total rollbacks this fit may take before escalating to fail-fast
    max_rollbacks: int = 3
    # micro-steps of data skipped per rollback: the window ENDS at the
    # failing step and is clamped to start no earlier than the restored
    # checkpoint
    skip_window_steps: int = 1
    # temporary LR cooldown after a rollback: the schedule times
    # `lr_cooldown_factor` for `lr_cooldown_steps` optimizer steps from the
    # restored step; 0 steps (default) disables it
    lr_cooldown_factor: float = 0.5
    lr_cooldown_steps: int = 0
    # consecutive failures at the SAME optimizer step before escalating
    escalate_after: int = 2
    # pre-registered skip windows [(start_micro_step, length), ...]: how a
    # clean run reproduces a healed run's data order exactly
    skip_windows: tuple[tuple[int, int], ...] = ()
    # replacement batches reserved from the tail of EVERY epoch
    # permutation; the default derives from the stable knobs above
    reserve_batches: int | None = None

    def __post_init__(self):
        self.skip_windows = tuple((int(s), int(n)) for s, n in self.skip_windows)
        checks = (
            (self.max_rollbacks >= 1, "max_rollbacks must be >= 1"),
            (self.skip_window_steps >= 1, "skip_window_steps must be >= 1"),
            (0 < self.lr_cooldown_factor <= 1, "lr_cooldown_factor must be in (0, 1]"),
            (self.lr_cooldown_steps >= 0, "lr_cooldown_steps must be >= 0"),
            (self.escalate_after >= 1, "escalate_after must be >= 1"),
            (self.reserve_batches is None or self.reserve_batches >= 1,
             "reserve_batches must be >= 1"),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(f"recovery: {message} ({self})")

    def resolved_reserve(self) -> int:
        if self.reserve_batches is not None:
            return self.reserve_batches
        return self.max_rollbacks * self.skip_window_steps


class DataSkipList:
    """Poisoned micro-step windows + the per-epoch replacement reserve.

    `is_skipped(step)` / `replacement_ordinal(step, epoch_start)` are pure
    functions of (windows, step), so the data stream they steer is exactly
    reproducible from persisted metadata (`to_metadata`/`from_metadata`).
    """

    def __init__(
        self, windows: Sequence[Sequence[int]] = (), reserve: int = 0
    ):
        self.reserve = int(reserve)
        self.windows: list[tuple[int, int]] = []
        self._steps: set[int] = set()
        self._wrap_warned = False
        for start, length in windows:
            self.add_window(int(start), int(length))

    def add_window(self, start: int, length: int) -> None:
        if length <= 0:
            return
        window = (int(start), int(length))
        if window in self.windows:
            # a repeat failure at the same step re-registers the same
            # window; duplicating it would inflate the metadata/telemetry
            # without changing the skipped-step set
            return
        self.windows.append(window)
        self._steps.update(range(window[0], window[0] + window[1]))

    def is_skipped(self, step: int) -> bool:
        return step in self._steps

    def replacement_ordinal(self, step: int, epoch_start: int) -> int:
        """How many steps of [epoch_start, step) are skipped — the index of
        `step`'s replacement batch within the epoch's reserved pool."""
        return sum(1 for s in self._steps if epoch_start <= s < step)

    def replacement_row(self, step: int, epoch_start: int, pool):
        """The reserved batch replacing skipped `step` (pool = the epoch's
        reserved index rows), or None with no pool at all (the skip cannot
        be honored — the caller serves the original batch). More skips per
        epoch than the reserve wraps deterministically (with one warning) —
        a duplicate batch beats killing a run the budget says should
        continue."""
        if len(pool) == 0:
            if not self._wrap_warned:
                self._wrap_warned = True
                logger.warning(
                    "skip list has windows but no reserved replacement pool "
                    "(reserve=0); skipped steps serve their original batches"
                )
            return None
        ordinal = self.replacement_ordinal(step, epoch_start)
        if ordinal >= len(pool) and not self._wrap_warned:
            self._wrap_warned = True
            logger.warning(
                "skip list needs %d replacement batches this epoch but only "
                "%d are reserved — wrapping (duplicate batches); raise "
                "recovery.reserve_batches",
                ordinal + 1, len(pool),
            )
        return pool[ordinal % len(pool)]

    @property
    def skipped_steps(self) -> int:
        return len(self._steps)

    def to_metadata(self) -> dict:
        return {
            "windows": [list(w) for w in self.windows],
            "reserve": self.reserve,
        }

    @classmethod
    def from_metadata(cls, data: dict | None) -> "DataSkipList | None":
        if not data:
            return None
        return cls(windows=data.get("windows", ()), reserve=data.get("reserve", 0))


def cooldown_schedule(
    base: Callable[[int], float], windows: Sequence[tuple[int, int, float]]
) -> Callable[[int], float]:
    """Optimizer-state-preserving LR cooldown: `base(count)` scaled by each
    window's factor while `start <= count < start + steps`. A pure function
    of the schedule's count, so it expires on its own."""
    spans = tuple((int(s), int(n), float(f)) for s, n, f in windows)

    def cooled(count: int) -> float:
        scale = 1.0
        for start, steps, factor in spans:
            if start <= count < start + steps:
                scale *= factor
        return base(count) * scale

    return cooled


class RollbackPlan:
    """What one accepted rollback does (returned by `RecoveryManager.
    on_failure`); the trainer executes it: restore, then register the skip
    window and cooldown against the restored step."""

    def __init__(self, rollback_index: int, failed_step: int):
        self.rollback_index = rollback_index  # 1-based
        self.failed_step = failed_step


class RecoveryManager:
    """detect → rollback → skip → cooldown → escalate, with telemetry.

    Owns the `DataSkipList` and the cooldown-window list; both persist via
    `metadata()` into checkpoint metadata so a preempted-and-relaunched run
    replays identical skips and LR (the rollback *budget* is per-process —
    a supervisor relaunch starts a fresh budget)."""

    def __init__(
        self,
        config: RecoveryConfig,
        registry: Any | None = None,
        metadata: dict | None = None,
    ):
        self.config = config
        self._registry = registry
        self.rollbacks = 0
        self._last_failed_step: int | None = None
        self._same_step_failures = 0
        self.cooldowns: list[tuple[int, int, float]] = []
        restored = DataSkipList.from_metadata((metadata or {}).get("skip_list"))
        if restored is not None:
            self.skip_list = restored
            # config-preset windows merge in (idempotent across resumes:
            # add_window dedups exact repeats)
            for window in config.skip_windows:
                self.skip_list.add_window(*window)
        else:
            self.skip_list = DataSkipList(
                windows=config.skip_windows, reserve=config.resolved_reserve()
            )
        for start, steps, factor in (metadata or {}).get("cooldowns", ()):
            self.cooldowns.append((int(start), int(steps), float(factor)))
        self._publish()

    # ------------------------------------------------------------ telemetry

    def _publish(self) -> None:
        if self._registry is None:
            return
        self._registry.gauge("resilience/skip_windows").set(
            len(self.skip_list.windows)
        )
        self._registry.gauge("resilience/skipped_steps").set(
            self.skip_list.skipped_steps
        )

    def _count(self, name: str) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc()

    # ------------------------------------------------------------ decisions

    def on_failure(self, failure: BaseException, failed_step: int) -> RollbackPlan:
        """Accept one rollback, or raise `RecoveryExhaustedError` when the
        budget is spent / the same step keeps failing. `failed_step` is the
        optimizer step the guard tripped on."""
        if failed_step == self._last_failed_step:
            self._same_step_failures += 1
        else:
            self._last_failed_step = failed_step
            self._same_step_failures = 1
        if self._same_step_failures > self.config.escalate_after:
            self._count("resilience/recovery_escalations")
            raise RecoveryExhaustedError(
                f"recovery escalating: step {failed_step} failed "
                f"{self._same_step_failures} consecutive times "
                f"(escalate_after={self.config.escalate_after}) — skipping "
                f"data is not curing this failure: {failure}",
                step=failed_step,
            ) from failure
        if self.rollbacks >= self.config.max_rollbacks:
            self._count("resilience/recovery_escalations")
            raise RecoveryExhaustedError(
                f"recovery budget exhausted: {self.rollbacks} rollbacks "
                f"already taken (max_rollbacks="
                f"{self.config.max_rollbacks}); latest failure at step "
                f"{failed_step}: {failure}",
                step=failed_step,
            ) from failure
        self.rollbacks += 1
        self._count("resilience/rollbacks")
        return RollbackPlan(self.rollbacks, failed_step)

    def register_skip(self, failed_micro_end: int, floor_micro: int) -> tuple[int, int]:
        """Register the poisoned window: `skip_window_steps` micro-steps
        ending at `failed_micro_end` (exclusive), clamped to start no
        earlier than the restored micro-step. Returns (start, length)."""
        start = max(failed_micro_end - self.config.skip_window_steps, floor_micro, 0)
        length = failed_micro_end - start
        if length > 0:
            self.skip_list.add_window(start, length)
            self._publish()
        return start, length

    def register_cooldown(self, restored_opt_step: int) -> bool:
        """Arm an LR cooldown at the restored optimizer step; False when
        cooldowns are disabled (lr_cooldown_steps == 0)."""
        if self.config.lr_cooldown_steps <= 0:
            return False
        self.cooldowns.append(
            (
                int(restored_opt_step),
                self.config.lr_cooldown_steps,
                self.config.lr_cooldown_factor,
            )
        )
        self._count("resilience/lr_cooldowns")
        return True

    def schedule_transform(self) -> Callable | None:
        """The schedule wrapper for `build_optimizer`, or None when no
        cooldown window exists (the base schedule is used untouched)."""
        if not self.cooldowns:
            return None
        windows = tuple(self.cooldowns)
        return lambda base: cooldown_schedule(base, windows)

    def metadata(self) -> dict:
        return {
            "skip_list": self.skip_list.to_metadata(),
            "cooldowns": [list(c) for c in self.cooldowns],
            "rollbacks": self.rollbacks,
        }
