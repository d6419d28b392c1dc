"""Run-health guard: stop or raise on a non-finite OR spiking
loss/grad_norm, with NaN provenance and anomaly dumps.

Counterpart of `llm_training_tpu/callbacks/nan_guard.py` (a dataclass
config where JAX's is a pydantic model). Checks run on log steps, on the
host metrics the trainer already fetched: a non-finite loss or grad norm
counts in the `nan_guard/non_finite_steps` registry counter and, past
`patience`, raises `NonFiniteLossError` (or stops the fit without its
final save); an EMA z-score detector (`telemetry/anomaly.EmaZScore`)
catches upward spikes while everything is still finite
(`nan_guard/spike_steps`, `LossSpikeError`). Both name the offending layer
groups from the trainer's most recent health step (`trainer.last_health`)
and write `anomaly-<step>.json` into the run directory. The guard's
trackers ride the checkpoint (`state_dict` / `load_state_dict`), and
`on_rollback` clears its streaks when in-process recovery rewinds."""

from __future__ import annotations

import logging
import math

from dataclasses import dataclass

from llm_training_tpu_torch.telemetry import anomaly as _anomaly

logger = logging.getLogger(__name__)


@dataclass
class NanGuardConfig:
    # consecutive non-finite log-steps tolerated before aborting; 0 = abort
    # on the first one
    patience: int = 0
    # raise (crash the run, let the scheduler restart from the checkpoint)
    # vs stop (end the fit cleanly)
    action: str = "raise"
    # spike guard: z-score threshold on loss/grad_norm vs their EMA
    # mean/std, upward excursions only; None (default) disables it
    spike_zscore: float | None = None
    # log-steps of EMA warmup before the z-score arms
    spike_warmup_steps: int = 20
    spike_ema_beta: float = 0.98
    # consecutive spiking log-steps tolerated before acting
    spike_patience: int = 0
    # write anomaly-<step>.json into the run dir on abort (skipped when the
    # run has no artifact directory)
    dump_anomalies: bool = True

    def __post_init__(self):
        checks = (
            (self.patience >= 0, "patience must be >= 0"),
            (self.action in ("raise", "stop"), "action must be raise or stop"),
            (self.spike_zscore is None or self.spike_zscore > 0, "spike_zscore must be > 0"),
            (self.spike_warmup_steps >= 2, "spike_warmup_steps must be >= 2"),
            (0 < self.spike_ema_beta < 1, "spike_ema_beta must be in (0, 1)"),
            (self.spike_patience >= 0, "spike_patience must be >= 0"),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(f"NanGuardConfig: {message} ({self})")


class NonFiniteLossError(RuntimeError):
    pass


class LossSpikeError(RuntimeError):
    pass


class NanGuard:
    def __init__(self, config: NanGuardConfig | None = None):
        self.config = config or NanGuardConfig()
        self.non_finite_steps = 0  # total, the skipped-steps metric analogue
        self.spike_steps = 0
        self._streak = 0
        self._spike_streak = 0
        self._detectors: dict[str, _anomaly.EmaZScore] = {}
        if self.config.spike_zscore:
            self._detectors = {
                name: _anomaly.EmaZScore(
                    beta=self.config.spike_ema_beta,
                    warmup=self.config.spike_warmup_steps,
                )
                for name in ("loss", "grad_norm")
            }

    def on_step_end(self, trainer, step, metrics) -> None:
        loss = float(metrics.get("loss", 0.0))
        grad_norm = float(metrics.get("grad_norm", 0.0))
        if math.isfinite(loss) and math.isfinite(grad_norm):
            self._streak = 0
            self._check_spikes(
                trainer, step, {"loss": loss, "grad_norm": grad_norm}, metrics
            )
            return
        self.non_finite_steps += 1
        self._streak += 1
        self._count(trainer, "nan_guard/non_finite_steps")
        offending = _anomaly.offending_layers(getattr(trainer, "last_health", None))
        logger.warning(
            "non-finite training signal at step %d (loss=%s grad_norm=%s), "
            "streak %d%s",
            step, loss, grad_norm, self._streak,
            f"; non-finite grad layers: {', '.join(offending)}" if offending else "",
        )
        if self._streak > self.config.patience:
            dump = self._dump(trainer, step, "non_finite", metrics, offending)
            message = (
                f"training diverged: non-finite loss/grad_norm for "
                f"{self._streak} consecutive log steps (step {step})"
            )
            if offending:
                message += (
                    "; first non-finite gradient layer(s): " + ", ".join(offending)
                )
            if dump is not None:
                message += f" [anomaly dump: {dump}]"
            if self.config.action == "raise":
                raise NonFiniteLossError(message)
            logger.error("%s — stopping", message)
            trainer.should_stop = True
            # the diverged state must not become the newest checkpoint: a
            # resume would restart from NaN weights
            trainer.abort_final_save = True

    # ------------------------------------------------------------ spikes

    def _check_spikes(self, trainer, step, values, metrics) -> None:
        if not self._detectors:
            return
        spiking: list[tuple[str, float]] = []
        for name, detector in self._detectors.items():
            z = detector.score(values[name])
            if z is not None and z > self.config.spike_zscore:
                # the excursion is NOT folded into the EMA — the tracker
                # models the healthy process, so a sustained spike keeps
                # scoring against the pre-spike statistics
                spiking.append((name, z))
            else:
                detector.update(values[name])
        if not spiking:
            self._spike_streak = 0
            return
        self.spike_steps += 1
        self._spike_streak += 1
        self._count(trainer, "nan_guard/spike_steps")
        described = ", ".join(f"{name} z={z:.1f}" for name, z in spiking)
        suspects = _anomaly.top_layers(getattr(trainer, "last_health", None))
        logger.warning(
            "loss-spike signal at step %d (%s), streak %d%s",
            step, described, self._spike_streak,
            f"; fastest-moving layers: {', '.join(suspects)}" if suspects else "",
        )
        if self._spike_streak > self.config.spike_patience:
            dump = self._dump(
                trainer, step, "spike", metrics, suspects,
                extra={"zscores": {name: z for name, z in spiking}},
            )
            message = (
                f"training spiked: {described} exceeded spike_zscore="
                f"{self.config.spike_zscore} for {self._spike_streak} "
                f"consecutive log steps (step {step})"
            )
            if suspects:
                message += "; fastest-moving layer(s): " + ", ".join(suspects)
            if dump is not None:
                message += f" [anomaly dump: {dump}]"
            if self.config.action == "raise":
                raise LossSpikeError(message)
            logger.error("%s — stopping", message)
            trainer.should_stop = True
            # unlike the NaN path, the weights are still finite — the final
            # checkpoint stays useful for post-mortem / rewind, so the save
            # is NOT aborted

    # ------------------------------------------------------------ state

    def state_dict(self) -> dict:
        """JSON-serializable guard state, persisted in checkpoint metadata
        (the trainer gathers every callback's `state_dict` on save). The
        EMA trackers matter most: without them the spike detector restarts
        its warmup window blind right after every resume — the moment
        spikes are most likely."""
        return {
            "non_finite_steps": self.non_finite_steps,
            "spike_steps": self.spike_steps,
            "streak": self._streak,
            "spike_streak": self._spike_streak,
            "detectors": {
                name: {"count": d.count, "mean": d.mean, "var": d.var}
                for name, d in self._detectors.items()
            },
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore from checkpoint metadata. Detector hyperparameters
        (beta/warmup) come from THIS run's config — only the tracked
        statistics are restored, and only for detectors this config builds
        (a run that disabled spike detection ignores persisted trackers)."""
        self.non_finite_steps = int(state.get("non_finite_steps", 0))
        self.spike_steps = int(state.get("spike_steps", 0))
        self._streak = int(state.get("streak", 0))
        self._spike_streak = int(state.get("spike_streak", 0))
        for name, data in (state.get("detectors") or {}).items():
            detector = self._detectors.get(name)
            if detector is None:
                continue
            detector.count = int(data.get("count", 0))
            detector.mean = float(data.get("mean", 0.0))
            detector.var = float(data.get("var", 0.0))

    def on_rollback(self, trainer, step: int) -> None:
        """In-process recovery rewound to `step`: clear the failure streaks
        (the diverged window is being discarded) but keep the EMA trackers
        and lifetime totals — they model the healthy process and the run's
        history, not the excursion."""
        self._streak = 0
        self._spike_streak = 0

    # ------------------------------------------------------------ plumbing

    @staticmethod
    def _count(trainer, name: str) -> None:
        registry = getattr(trainer, "telemetry", None)
        if registry is not None:
            registry.counter(name).inc()

    def _dump(self, trainer, step, reason, metrics, offending, extra=None):
        if not self.config.dump_anomalies:
            return None
        run_dir = _anomaly.resolve_run_dir(trainer)
        if run_dir is None:
            logger.info(
                "no run directory (logger/checkpointer) — skipping the "
                "anomaly dump for step %d", step,
            )
            return None
        return _anomaly.dump_anomaly(
            run_dir, step, reason, metrics,
            offending=offending,
            health=getattr(trainer, "last_health", None),
            extra=extra,
        )
