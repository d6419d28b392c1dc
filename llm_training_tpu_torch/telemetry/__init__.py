"""Telemetry: the metric registry, the goodput ledger, the card's memory
gauges, the model-health metrics, host-side anomaly detection, and the
live tier: the request tracer, the SLO monitor, the `/metrics` exporter
and the profile trigger.

Counterpart of `llm_training_tpu/telemetry/` without the fleet view and the
`report` command (ROADMAP A.7b, A.7c): one registry and one goodput ledger
per fit (owned by the `Trainer`), `hbm/*` gauges sampled on log steps,
per-layer health norms at a configured cadence, the spike detector and
anomaly dumps that `callbacks.NanGuard` uses, and the tracer, SLOs,
exporter and profile trigger that `serve` runs.
"""

from llm_training_tpu_torch.telemetry.anomaly import (
    EmaZScore,
    dump_anomaly,
    offending_layers,
    resolve_run_dir,
    top_layers,
)
from llm_training_tpu_torch.telemetry.device import HBMTimeline, hbm_gauges
from llm_training_tpu_torch.telemetry.exporter import (
    MetricsExporter,
    resolve_metrics_port,
    start_exporter,
)
from llm_training_tpu_torch.telemetry.goodput import PHASES, GoodputLedger
from llm_training_tpu_torch.telemetry.health import (
    HealthConfig,
    build_param_groups,
    layer_health_metrics,
    layer_health_tensor,
)
from llm_training_tpu_torch.telemetry.profiling import (
    ProfileTrigger,
    build_profile_trigger,
    get_profile_trigger,
    set_profile_trigger,
)
from llm_training_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
    set_registry,
)
from llm_training_tpu_torch.telemetry.slo import (
    SLOMonitor,
    build_slo_monitor,
    slo_config_from_env,
)
from llm_training_tpu_torch.telemetry.trace import TraceRecorder, get_tracer, set_tracer

__all__ = [
    "PHASES",
    "EmaZScore",
    "GoodputLedger",
    "HBMTimeline",
    "HealthConfig",
    "MetricsExporter",
    "ProfileTrigger",
    "SLOMonitor",
    "TelemetryRegistry",
    "TraceRecorder",
    "build_param_groups",
    "build_profile_trigger",
    "build_slo_monitor",
    "dump_anomaly",
    "get_profile_trigger",
    "get_registry",
    "get_tracer",
    "hbm_gauges",
    "layer_health_metrics",
    "layer_health_tensor",
    "offending_layers",
    "resolve_metrics_port",
    "resolve_run_dir",
    "set_profile_trigger",
    "set_registry",
    "set_tracer",
    "slo_config_from_env",
    "start_exporter",
    "top_layers",
]
