"""Telemetry: the metric registry, the goodput ledger, the card's memory
gauges, the model-health metrics and host-side anomaly detection.

Counterpart of the part of `llm_training_tpu/telemetry/` that the trainer's
`fit` runs around every step: one registry and one goodput ledger per fit
(owned by the `Trainer`), `hbm/*` gauges sampled on log steps, per-layer
health norms at a configured cadence, and the spike detector and anomaly
dumps that `callbacks.NanGuard` uses. The tracer, the exporter, the SLO
monitor, profiling, the fleet view and the `report` command are not ported
yet (ROADMAP A.7).
"""

from llm_training_tpu_torch.telemetry.anomaly import (
    EmaZScore,
    dump_anomaly,
    offending_layers,
    resolve_run_dir,
    top_layers,
)
from llm_training_tpu_torch.telemetry.device import HBMTimeline, hbm_gauges
from llm_training_tpu_torch.telemetry.goodput import PHASES, GoodputLedger
from llm_training_tpu_torch.telemetry.health import (
    HealthConfig,
    build_param_groups,
    layer_health_metrics,
    layer_health_tensor,
)
from llm_training_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
    set_registry,
)

__all__ = [
    "PHASES",
    "EmaZScore",
    "GoodputLedger",
    "HBMTimeline",
    "HealthConfig",
    "TelemetryRegistry",
    "build_param_groups",
    "dump_anomaly",
    "get_registry",
    "hbm_gauges",
    "layer_health_metrics",
    "layer_health_tensor",
    "offending_layers",
    "resolve_run_dir",
    "set_registry",
    "top_layers",
]
