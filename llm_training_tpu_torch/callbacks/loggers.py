"""Metric loggers.

Counterpart of `JsonlLogger` in `llm_training_tpu/callbacks/loggers.py`:
one JSON object per logged step in `<save_dir>/<project>/<name>/metrics.jsonl`
(every metric the trainer logs: `step`, `loss`, `grad_norm`, `lr`, ... and
the telemetry that rides the log steps), the validation loss as its own
row, and the telemetry subset (`goodput/`, `hbm/`, `health/`, `nan_guard/`,
`resilience/`, `data/`, `perf/`, ...) also in `telemetry.jsonl`, with one
final record from the fit's epilogue (`on_telemetry`). The run's config
and metadata land beside them at fit start.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

from llm_training_tpu_torch.parallel.mesh import is_primary
from llm_training_tpu_torch.run_metadata import collect_run_metadata

# metric keys routed (additionally) to telemetry.jsonl, as JAX's
TELEMETRY_PREFIXES = (
    "goodput/", "hbm/", "xla/", "data/", "checkpoint/", "perf/",
    "health/", "nan_guard/", "resilience/", "decode/", "eval/", "serve/",
    "elastic/", "flash/", "trace/", "slo/", "exporter/", "attr/",
    "profile/", "hbm_timeline/", "router/", "rl/", "ckpt/",
)
TELEMETRY_KEYS = ("compile_time_s",)


def _is_telemetry_key(key: str) -> bool:
    return key in TELEMETRY_KEYS or key.startswith(TELEMETRY_PREFIXES)


def _floats(record: dict) -> dict:
    out = {}
    for key, value in record.items():
        try:
            out[key] = float(value)
        except (TypeError, ValueError):
            out[key] = str(value)
    return out


@dataclass
class JsonlLoggerConfig:
    save_dir: str = "runs"
    project: str = "llm-training-tpu"
    name: str | None = None  # default: timestamp


class JsonlLogger:
    def __init__(self, config: JsonlLoggerConfig | None = None):
        self.config = config or JsonlLoggerConfig()
        name = self.config.name or time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = Path(self.config.save_dir) / self.config.project / name
        self._files: dict[str, object] = {}

    def _write(self, filename: str, record: dict) -> None:
        # rank 0 alone writes the run's files, as JAX's process 0
        if not is_primary():
            return
        if filename not in self._files:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._files[filename] = open(self.run_dir / filename, "a")
        f = self._files[filename]
        f.write(json.dumps(record) + "\n")
        f.flush()

    def on_fit_start(self, trainer, objective, datamodule, start_step) -> None:
        if not is_primary():
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        # one metadata snapshot a run, as JAX's: the checkpointer's (taken
        # at its construction) so the checkpoint meta and the run dir record
        # the same world, env and rev; collected here when there is none
        run_metadata = getattr(getattr(trainer, "checkpointer", None), "run_metadata", None)
        if run_metadata is None:
            run_metadata = collect_run_metadata()
        (self.run_dir / "run_metadata.json").write_text(
            json.dumps(run_metadata, indent=2, default=str))
        if trainer.run_config:
            (self.run_dir / "config.json").write_text(
                json.dumps(trainer.run_config, indent=2, default=str)
            )

    def on_step_end(self, trainer, step, metrics) -> None:
        record = {"step": step, **_floats(metrics)}
        self._write("metrics.jsonl", record)
        telemetry = {k: v for k, v in record.items() if _is_telemetry_key(k)}
        if telemetry:
            self._write("telemetry.jsonl", {"step": step, **telemetry})

    def on_validation_end(self, trainer, step, metrics) -> None:
        self.on_step_end(trainer, step, metrics)

    def on_telemetry(self, trainer, step, record) -> None:
        """The fit epilogue's telemetry record: the final save and its wait
        land after the last log step, and this record carries them."""
        telemetry = {k: v for k, v in _floats(record).items() if _is_telemetry_key(k)}
        if telemetry:
            self._write("telemetry.jsonl", {"step": step, **telemetry})

    def on_fit_end(self, trainer, state) -> None:
        self.teardown()

    def teardown(self) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}
