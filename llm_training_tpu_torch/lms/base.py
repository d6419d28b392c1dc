"""Objective base: config surface, model provider and pre-trained loading.

Counterpart of `llm_training_tpu/lms/base.py`: `BaseLMConfig` (optimizer
config, frozen-module regexes, the pre-trained source) and
`ModelProvider`, the `{model_class, model_kwargs}` config node that builds
a model. The JAX provider imports the class by name from
`llm_training_tpu.models`; the port maps the names of the model classes it
has (`Llama`, `Phi3`, `HFCausalLM`) onto its own classes and imports
nothing of the JAX package. `resolve_pretrained_source` and `init_model`
are JAX's `resolve_pretrained_source` and `load_single_model_pretrained`:
the objective's source wins over the model config's.

The objective contract the `Trainer` drives (the JAX objective's
`init_params` becomes a module): `configure_model(device, generator)`
returns the module whose parameters are the train state -- the model of
CLM and ORPO (`SingleModelObjective`), DPO's `PolicyAndReference` -- and
points the objective at it; `bind(module)` points the objective at such a
module restored elsewhere; `loss_and_metrics(batch, rng, train)` computes
with it; `config.optim` and `config.frozen_modules` build its optimizer.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any

import torch

from llm_training_tpu_torch.models.hf_causal_lm import (
    HFCausalLM,
    HFCausalLMConfig,
    resolve_hf_config,
)
from llm_training_tpu_torch.models.hf_io import load_pretrained_params
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.models.phi3 import Phi3, Phi3Config
from llm_training_tpu_torch.optim.builder import OptimConfig

logger = logging.getLogger(__name__)

# model_class as the JAX configs name it (bare names resolve in
# `llm_training_tpu.models`) -> (model, config)
MODEL_CLASSES: dict[str, tuple[type, type]] = {
    "Llama": (Llama, LlamaConfig),
    "llm_training_tpu.models.Llama": (Llama, LlamaConfig),
    "Phi3": (Phi3, Phi3Config),
    "llm_training_tpu.models.Phi3": (Phi3, Phi3Config),
    "HFCausalLM": (HFCausalLM, HFCausalLMConfig),
    "llm_training_tpu.models.HFCausalLM": (HFCausalLM, HFCausalLMConfig),
}


@dataclass
class BaseLMConfig:
    """JAX's `BaseLMConfig`, every field at JAX's default: random init (or
    not), the optimizer, frozen-parameter regexes, and the pre-trained
    source: an HF directory (`pre_trained_weights` here, else the model
    config's), loaded by `init_model` when `load_weights`.
    `log_grad_norm` is read nowhere, as in JAX."""

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

    def model_config(self) -> LlamaConfig:
        """The config the model is built from: `get_config()`, or for
        `HFCausalLM` the family config its `config.json` resolves to."""
        config = self.get_config()
        return resolve_hf_config(config)[1] if isinstance(config, HFCausalLMConfig) else config

    def get_model(self, device: torch.device | str | None = None) -> torch.nn.Module:
        model_cls, _ = self._resolve()
        return model_cls(self.get_config(), device=device)


def resolve_pretrained_source(lm_config: BaseLMConfig, model_config: Any) -> str | None:
    """The objective's `pre_trained_weights` wins; else the model config's
    own (JAX's `resolve_pretrained_source`)."""
    return lm_config.pre_trained_weights or getattr(model_config, "pre_trained_weights", None)


def build_model(provider: ModelProvider | None, device: torch.device, where: str) -> torch.nn.Module:
    """A model from a config node on `device`, its weights not yet set
    (`init_model` sets them)."""
    if provider is None:
        raise ValueError(f"{where} is required when no model is given")
    return provider.get_model(device)


def init_model(model: torch.nn.Module, lm_config: BaseLMConfig, source: str | None,
               generator: torch.Generator) -> torch.nn.Module:
    """Set a built model's weights: streamed from the HF directory `source`
    when there is one and `load_weights` (each tensor placed on the
    model's device in its parameter's dtype before the next is read), else
    random from `generator` when `init_weights`. With `load_weights: false`
    the source is ignored, as in JAX."""
    if source and lm_config.load_weights:
        logger.info("loading pre-trained weights from %s", source)
        load_pretrained_params(model.config, source, into=model.state_dict())
    elif lm_config.init_weights:
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
        config with the pre-trained source's weights, or random ones from
        `generator` (on `device`)."""
        if self.model is None:
            name = f"{type(self.config).__name__}.model"
            model = build_model(self.config.model, device, name)
            self.model = init_model(model, self.config,
                                    resolve_pretrained_source(self.config, model.config), generator)
        self.model = self.model.to(device)
        return self.model

    def bind(self, module: torch.nn.Module) -> None:
        """Compute with `module` (a state built by `configure_model` and
        restored)."""
        self.model = module
