"""Host-side anomaly detection and provenance dumps.

Counterpart of `llm_training_tpu/telemetry/anomaly.py` (standard library
only, copied). Two pieces, both consumed by `callbacks.NanGuard` (the run-health guard):

- `EmaZScore`: an exponential-moving-average mean/variance tracker that
  scores each new loss / grad-norm sample in standard deviations. It turns
  the NaN guard into a general *spike* guard — a loss that jumps 8 sigma is
  a divergence precursor worth stopping on long before anything goes
  non-finite (arXiv 2204.06514 §5 stops-and-rewinds on exactly this
  signal). A warmup sample count gates scoring so early-training noise
  never false-positives, and spiking samples are NOT folded into the EMA
  (the tracker models the healthy process, not the excursion).

- anomaly dumps: on a non-finite or spiking step the guard writes
  `anomaly-<step>.json` into the run directory — the offending metric
  snapshot, the per-layer health gauges from the trainer's most recent
  health step (`trainer.last_health`), and the offending layer paths —
  so post-mortem starts from a file instead of a scrollback hunt. The
  trace ring's flight dump lands beside it, and a device profile is armed
  under the same tag, as JAX's dump does.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path

logger = logging.getLogger(__name__)


class EmaZScore:
    """EMA mean/variance with z-scoring, for host-side scalar streams.

    `score(x)` returns the SIGNED z-score (x - mean) / std — positive means
    above the tracked mean (None until `warmup` samples have been folded
    in). Spike guards trip on positive z only: a sharp loss IMPROVEMENT
    (LR drop, curriculum boundary) is a large negative z and must never
    abort a converging run. `update(x)` folds a sample in (non-finite
    samples are ignored — the non-finite path has its own guard). The
    variance uses the standard EMA recurrence (West); the std is floored
    at 1% of |mean| so a plateaued loss does not z-score numeric jitter to
    infinity.
    """

    def __init__(self, beta: float = 0.98, warmup: int = 20):
        if not 0.0 < beta < 1.0:
            raise ValueError(f"beta must be in (0, 1), got {beta}")
        self.beta = beta
        self.warmup = warmup
        self.count = 0
        self.mean = 0.0
        self.var = 0.0

    def score(self, value: float) -> float | None:
        if self.count < self.warmup:
            return None
        if not math.isfinite(value):
            return math.inf
        # debias the EMA variance (it starts at 0, so the raw recurrence
        # underestimates early and would inflate z right after warmup)
        correction = 1.0 - self.beta ** max(self.count - 1, 1)
        var = self.var / correction
        std = max(math.sqrt(max(var, 0.0)), 0.01 * abs(self.mean), 1e-12)
        return (value - self.mean) / std

    def update(self, value: float) -> None:
        if not math.isfinite(value):
            return
        self.count += 1
        if self.count == 1:
            self.mean = value
            self.var = 0.0
            return
        delta = value - self.mean
        self.mean += (1.0 - self.beta) * delta
        self.var = self.beta * (self.var + (1.0 - self.beta) * delta * delta)


def offending_layers(health: dict | None, limit: int = 5) -> list[str]:
    """Layer groups whose gradients went non-finite in the most recent
    health snapshot — the NaN provenance list. Ordered as emitted (layer
    order), truncated to `limit` with a '... (+N more)' tail entry."""
    if not health:
        return []
    bad = [
        key.split("/", 2)[2]
        for key, value in health.items()
        if key.startswith("health/grad_norm/") and not math.isfinite(value)
    ]
    if len(bad) > limit:
        bad = bad[:limit] + [f"... (+{len(bad) - limit} more)"]
    return bad


def top_layers(
    health: dict | None, metric: str = "update_ratio", k: int = 3
) -> list[str]:
    """The k layer groups ranked worst by `health/<metric>/` — the spike
    provenance list (a spiking step's grads are finite; the suspects are
    the groups moving fastest relative to their weights)."""
    if not health:
        return []
    prefix = f"health/{metric}/"
    ranked = sorted(
        (
            (value, key[len(prefix):])
            for key, value in health.items()
            if key.startswith(prefix) and math.isfinite(value)
        ),
        reverse=True,
    )
    return [name for _, name in ranked[:k]]


def resolve_run_dir(trainer) -> Path | None:
    """Where anomaly dumps land: the first logger callback exposing a
    `run_dir` (JsonlLogger), else the checkpoint directory, else None —
    a guard with no run artifacts skips the dump rather than littering
    the working directory."""
    for cb in getattr(trainer, "callbacks", None) or []:
        run_dir = getattr(cb, "run_dir", None)
        if run_dir:
            return Path(run_dir)
    directory = getattr(getattr(trainer, "checkpointer", None), "directory", None)
    if directory:
        return Path(str(directory))
    return None


def _primary_host() -> bool:
    """Run-directory artifacts are written by process 0 only."""
    try:
        import torch.distributed as dist

        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    except Exception:
        return True


def _jsonable(value):
    try:
        f = float(value)
    except (TypeError, ValueError):
        return str(value)
    # json.dump rejects inf/nan by default; keep the record readable
    return f if math.isfinite(f) else str(f)


def dump_anomaly(
    run_dir: Path,
    step: int,
    reason: str,
    metrics: dict,
    offending: list[str] | None = None,
    health: dict | None = None,
    extra: dict | None = None,
) -> Path | None:
    """Write `anomaly-<step>.json` (process 0 only). Returns the path, or
    None when skipped/failed — the guard's abort must never be masked by a
    dump error."""
    if not _primary_host():
        return None
    try:
        run_dir = Path(run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        path = run_dir / f"anomaly-{step}.json"
        payload = {
            "step": int(step),
            "reason": reason,
            "offending_layers": offending or [],
            "metrics": {k: _jsonable(v) for k, v in (metrics or {}).items()},
            "health": {k: _jsonable(v) for k, v in (health or {}).items()},
        }
        if extra:
            payload.update({k: _jsonable(v) if not isinstance(v, (dict, list)) else v
                            for k, v in extra.items()})
        path.write_text(json.dumps(payload, indent=2))
        # flight recorder: the trace ring's last events (the steps leading
        # into the anomaly) land next to the metric snapshot; flight_dump
        # never raises
        from llm_training_tpu_torch.telemetry.trace import get_tracer

        get_tracer().flight_dump(run_dir, f"anomaly-{step}")
        # matching-tag device profile: if the guard lets the run go on
        # (warn and rollback paths), the next steps are captured under the
        # same `anomaly-<step>` name; on an abort the request is never polled
        from llm_training_tpu_torch.telemetry.profiling import get_profile_trigger

        trigger = get_profile_trigger()
        if trigger is not None:
            trigger.request(f"anomaly-{step}", source="anomaly")
        return path
    except Exception:
        logger.exception("anomaly dump failed (step %d, reason %s)", step, reason)
        return None
