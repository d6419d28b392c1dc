"""JSON config loading and `class_path` instantiation.

Counterpart of `llm_training_tpu/cli/config.py` on JSON instead of YAML
(the card's machine has no PyYAML): the same node layout (`trainer`,
`model`, `data`; components as `{class_path, init_args}`), `key.path=value`
overrides and `${...}` interpolation. Class paths are looked up in a
port-side table that maps the JAX package's names onto the port's classes;
any other path outside the JAX package is imported by name, as the JAX
config imports every path (a user's own datamodule or callback). Each
class `Foo` is built as `Foo(FooConfig(**init_args))`, its config class
found beside it in its module.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Any

from llm_training_tpu_torch.callbacks.loggers import JsonlLogger, JsonlLoggerConfig
from llm_training_tpu_torch.callbacks.nan_guard import NanGuard, NanGuardConfig
from llm_training_tpu_torch.callbacks.output_redirection import (
    OutputRedirection,
    OutputRedirectionConfig,
)
from llm_training_tpu_torch.callbacks.profiler import ProfilerCallback, ProfilerCallbackConfig
from llm_training_tpu_torch.callbacks.progress import ProgressBar, ProgressBarConfig
from llm_training_tpu_torch.callbacks.time_estimator import (
    TrainingTimeEstimator,
    TrainingTimeEstimatorConfig,
)
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.lms import CLM, DPO, ORPO, CLMConfig, DPOConfig, ORPOConfig

_INTERP = re.compile(r"\$\{([^}]+)\}")

# the JAX package's class paths -> (the port's class, its config dataclass)
CLASS_PATHS: dict[str, tuple[type, type]] = {
    "llm_training_tpu.lms.CLM": (CLM, CLMConfig),
    "llm_training_tpu.lms.DPO": (DPO, DPOConfig),
    "llm_training_tpu.lms.ORPO": (ORPO, ORPOConfig),
    "llm_training_tpu.data.DummyDataModule": (DummyDataModule, DummyDataModuleConfig),
    "llm_training_tpu.callbacks.JsonlLogger": (JsonlLogger, JsonlLoggerConfig),
    "llm_training_tpu.callbacks.NanGuard": (NanGuard, NanGuardConfig),
    "llm_training_tpu.callbacks.TrainingTimeEstimator": (
        TrainingTimeEstimator, TrainingTimeEstimatorConfig),
    "llm_training_tpu.callbacks.ProgressBar": (ProgressBar, ProgressBarConfig),
    "llm_training_tpu.callbacks.ProfilerCallback": (ProfilerCallback, ProfilerCallbackConfig),
    "llm_training_tpu.callbacks.OutputRedirection": (OutputRedirection, OutputRedirectionConfig),
}


def _resolve_node(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _interpolate(value: Any, root: Any) -> Any:
    if isinstance(value, str):
        match = _INTERP.fullmatch(value)
        if match:  # whole-value reference keeps the referenced type
            return _interpolate(_resolve_node(root, match.group(1)), root)
        return _INTERP.sub(lambda m: str(_resolve_node(root, m.group(1))), value)
    if isinstance(value, dict):
        return {k: _interpolate(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_interpolate(v, root) for v in value]
    return value


def _parse_override(raw: str) -> tuple[str, Any]:
    if "=" not in raw:
        raise ValueError(f"override must be key.path=value, got {raw!r}")
    key, value = raw.split("=", 1)
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value  # a bare string


def _apply_override(config: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = config
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def load_config(path: str | Path, overrides: list[str] | None = None) -> dict:
    with open(path) as f:
        config = json.load(f)
    for raw in overrides or []:
        _apply_override(config, *_parse_override(raw))
    return _interpolate(config, config)


def instantiate_from_config(node: dict, default_class: str | None = None) -> Any:
    """`{class_path: pkg.Foo, init_args: {...}}` -> Foo(FooConfig(**init_args))."""
    class_path = node.get("class_path", default_class)
    if class_path is None:
        raise ValueError(f"config node needs class_path: {node}")
    if class_path in CLASS_PATHS:
        cls, config_cls = CLASS_PATHS[class_path]
    elif class_path.split(".")[0] == "llm_training_tpu" or "." not in class_path:
        raise NotImplementedError(
            f"{class_path!r} is not ported; the port has {sorted(CLASS_PATHS)}"
        )
    else:
        module_name, _, name = class_path.rpartition(".")
        module = importlib.import_module(module_name)
        cls = getattr(module, name)
        config_cls = getattr(module, name + "Config", None)
        if config_cls is None:
            raise ValueError(f"{class_path!r} has no {name}Config beside it in {module_name}")
    return cls(build_dataclass(config_cls, node.get("init_args", {}), class_path))
