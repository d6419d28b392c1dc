"""Metric loggers.

Counterpart of `JsonlLogger` in `llm_training_tpu/callbacks/loggers.py`:
one JSON object per logged step in `<save_dir>/<project>/<name>/metrics.jsonl`
(the keys the trainer logs: `step`, `loss`, `grad_norm`, `lr`, ...), and
the validation loss as its own row. The run's config and metadata land
beside it at fit start.
"""

from __future__ import annotations

import json
import platform
import time
from dataclasses import dataclass
from pathlib import Path

import torch


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
        if filename not in self._files:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._files[filename] = open(self.run_dir / filename, "a")
        f = self._files[filename]
        f.write(json.dumps(record) + "\n")
        f.flush()

    def on_fit_start(self, trainer, objective, datamodule, start_step) -> None:
        self.run_dir.mkdir(parents=True, exist_ok=True)
        device = trainer.device
        metadata = {
            "python": platform.python_version(),
            "torch": torch.__version__,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else platform.processor() or "cpu"),
        }
        (self.run_dir / "run_metadata.json").write_text(json.dumps(metadata, indent=2))
        if trainer.run_config:
            (self.run_dir / "config.json").write_text(
                json.dumps(trainer.run_config, indent=2, default=str)
            )

    def on_step_end(self, trainer, step, metrics) -> None:
        record = {"step": step}
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = str(value)
        self._write("metrics.jsonl", record)

    def on_validation_end(self, trainer, step, metrics) -> None:
        self.on_step_end(trainer, step, metrics)

    def on_fit_end(self, trainer) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}
