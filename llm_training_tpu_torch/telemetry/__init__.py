"""Telemetry: the metric registry, the goodput ledger, the card's memory
gauges, the model-health metrics, host-side anomaly detection, and the
live tier: the request tracer, the SLO monitor, the `/metrics` exporter
and the profile trigger; the fleet plane; and `report`.

Counterpart of `llm_training_tpu/telemetry/`: one registry and one goodput
ledger per fit (owned by the `Trainer`), `hbm/*` gauges sampled on log
steps, per-layer health norms at a configured cadence, the spike detector
and anomaly dumps that `callbacks.NanGuard` uses; the tracer, SLOs,
exporter and profile trigger that `fit`, `rl-fit` and `serve` run; the
fleet aggregator over the exporters' discovery cards (`fleet.py`, the
`fleet` command); and the run summary (`report.py`, the `report` command).
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
from llm_training_tpu_torch.telemetry.fleet import (
    FleetAggregator,
    discover_replicas,
    fleet_main,
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
from llm_training_tpu_torch.telemetry.report import (
    render_report,
    render_report_data,
    report_main,
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
    "FleetAggregator",
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
    "discover_replicas",
    "dump_anomaly",
    "fleet_main",
    "get_profile_trigger",
    "get_registry",
    "get_tracer",
    "hbm_gauges",
    "layer_health_metrics",
    "layer_health_tensor",
    "offending_layers",
    "render_report",
    "render_report_data",
    "report_main",
    "resolve_metrics_port",
    "resolve_run_dir",
    "set_profile_trigger",
    "set_registry",
    "set_tracer",
    "slo_config_from_env",
    "start_exporter",
    "top_layers",
]
