"""Objective base: config surface and model provider.

Counterpart of `llm_training_tpu/lms/base.py`: `BaseLMConfig` (optimizer
config, frozen-module regexes) and `ModelProvider`, the `{model_class,
model_kwargs}` config node that builds a model. The JAX provider imports
the class by name from `llm_training_tpu.models`; the port maps the names
of the model classes it has onto its own classes and imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.optim.builder import OptimConfig

# model_class as the JAX configs name it (bare names resolve in
# `llm_training_tpu.models`) -> (model, config)
MODEL_CLASSES: dict[str, tuple[type, type]] = {
    "Llama": (Llama, LlamaConfig),
    "llm_training_tpu.models.Llama": (Llama, LlamaConfig),
}


@dataclass
class BaseLMConfig:
    """The JAX `BaseLMConfig` fields the port implements: random init (or
    not), the optimizer, and frozen-parameter regexes. Loading HF weights
    is not ported yet (ROADMAP A.5)."""

    init_weights: bool = True
    optim: OptimConfig = field(default_factory=OptimConfig)
    frozen_modules: list[str] = field(default_factory=list)


@dataclass
class ModelProvider:
    """`{model_class, model_kwargs}` -> validated config + model factory."""

    model_class: str
    model_kwargs: dict[str, Any] = field(default_factory=dict)

    def _resolve(self) -> tuple[type, type]:
        try:
            return MODEL_CLASSES[self.model_class]
        except KeyError:
            raise NotImplementedError(
                f"model_class {self.model_class!r} is not ported; the port has "
                f"{sorted(MODEL_CLASSES)}"
            ) from None

    def get_config(self) -> Any:
        _, config_cls = self._resolve()
        return config_cls.from_dict(self.model_kwargs, f"model_kwargs of {self.model_class}")

    def get_model(self, device: torch.device | str | None = None) -> torch.nn.Module:
        model_cls, _ = self._resolve()
        return model_cls(self.get_config(), device=device)
