"""Objective base: config surface and model provider.

Counterpart of `llm_training_tpu/lms/base.py`: `BaseLMConfig` (optimizer
config, frozen-module regexes) and `ModelProvider`, the `{model_class,
model_kwargs}` config node that builds a model. The JAX provider imports
the class by name from `llm_training_tpu.models`; the port maps the names
of the model classes it has onto its own classes and imports nothing of
the JAX package.

The objective contract the `Trainer` drives (the JAX objective's
`init_params` becomes a module): `configure_model(device, generator)`
returns the module whose parameters are the train state -- the model of
CLM and ORPO (`SingleModelObjective`), DPO's `PolicyAndReference` -- and
points the objective at it; `bind(module)` points the objective at such a
module restored elsewhere; `loss_and_metrics(batch, rng, train)` computes
with it; `config.optim` and `config.frozen_modules` build its optimizer.
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
    """JAX's `BaseLMConfig`, every field at JAX's default: random init (or
    not), the optimizer, frozen-parameter regexes, and the pre-trained
    source. `log_grad_norm` is read nowhere, as in JAX. Loading HF weights
    (`pre_trained_weights` here or in the model config, with `load_weights`)
    is not ported yet and raises in `build_model` (ROADMAP A.8)."""

    init_weights: bool = True
    load_weights: bool = True
    pre_trained_weights: str | None = None
    optim: OptimConfig = field(default_factory=OptimConfig)
    frozen_modules: list[str] = field(default_factory=list)
    log_grad_norm: bool = True


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


def build_model(
    provider: ModelProvider | None, lm_config: BaseLMConfig, device: torch.device,
    generator: torch.Generator, where: str,
) -> torch.nn.Module:
    """A model from a config node on `device`, with random weights from
    `generator` when `lm_config.init_weights`. A pre-trained source (the
    objective's `pre_trained_weights`, else the model config's) with
    `load_weights` raises: HF checkpoint I/O comes with ROADMAP A.8. With
    `load_weights: false` the source is ignored, as in JAX."""
    if provider is None:
        raise ValueError(f"{where} is required when no model is given")
    model_config = provider.get_config()
    source = lm_config.pre_trained_weights or getattr(model_config, "pre_trained_weights", None)
    if source and lm_config.load_weights:
        raise NotImplementedError(
            f"{where}: loading pre-trained weights from {source!r} is not ported yet "
            "(HF checkpoint I/O, ROADMAP A.8); set load_weights: false to start from the seed"
        )
    model = provider.get_model(device)
    if lm_config.init_weights:
        model.init_weights(generator)
    return model


class SingleModelObjective:
    """The objective contract over one causal LM (CLM, ORPO): a model
    handed in keeps its weights; one built from `config.model` is made by
    `configure_model` on the trainer's device."""

    def __init__(self, config: Any, model: torch.nn.Module | None = None):
        self.config = config
        self.model = model

    def configure_model(self, device: torch.device, generator: torch.Generator) -> torch.nn.Module:
        """The model on `device`: the one given, or one built from the
        config with random weights from `generator` (on `device`)."""
        if self.model is None:
            name = f"{type(self.config).__name__}.model"
            self.model = build_model(self.config.model, self.config, device, generator, name)
        self.model = self.model.to(device)
        return self.model

    def bind(self, module: torch.nn.Module) -> None:
        """Compute with `module` (a state built by `configure_model` and
        restored)."""
        self.model = module
