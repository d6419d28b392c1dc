"""HFCausalLM: build the port's model straight from an HF checkpoint dir.

Counterpart of `llm_training_tpu/models/hf_causal_lm.py`: an architecture
router, not a wrapper. `config.json`'s `model_type` selects the family
(`hf_io.model_class_for_hf`: every Llama-graph type -> Llama, phi3 -> Phi3,
gemma / gemma2 / gemma3_text -> Gemma, deepseek_v2 / deepseek_v3 / kimi_k2
-> Deepseek, glm4_moe / dots1 -> Glm4Moe, gpt_oss -> GptOss, ernie4_5_moe ->
Ernie45Moe, hunyuan_v1_moe -> HunYuanMoe, qwen3_next -> Qwen3Next, minimax ->
MiniMax, bamba -> Bamba: every family of JAX's table), the family's
`config_from_hf` merges the hparams with any extra field of the node as
an override, and with `load_hf_weights` (the default) the family config's
`pre_trained_weights` defaults to `hf_path`, so the objective's loader
(`lms/base.py`) streams the weights in.

    {"model_class": "HFCausalLM",
     "model_kwargs": {"hf_path": "/path/to/hf-dir", "num_hidden_layers": 8}}
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field, fields
from typing import Any

import torch

from llm_training_tpu_torch.models.bamba import Bamba, BambaConfig
from llm_training_tpu_torch.models.deepseek import Deepseek, DeepseekConfig
from llm_training_tpu_torch.models.ernie45_moe import Ernie45Moe, Ernie45MoeConfig
from llm_training_tpu_torch.models.gemma import Gemma, GemmaConfig
from llm_training_tpu_torch.models.glm4_moe import Glm4Moe, Glm4MoeConfig
from llm_training_tpu_torch.models.gpt_oss import GptOss, GptOssConfig
from llm_training_tpu_torch.models.hf_io import load_hf_config, model_class_for_hf
from llm_training_tpu_torch.models.hunyuan_moe import HunYuanMoe, HunYuanMoeConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.models.minimax import MiniMax, MiniMaxConfig
from llm_training_tpu_torch.models.phi3 import Phi3, Phi3Config
from llm_training_tpu_torch.models.qwen3_next import Qwen3Next, Qwen3NextConfig

# JAX class path -> (the port's model class, its conversion module)
_FAMILY_CLASSES: dict[str, tuple[type, str]] = {
    "llm_training_tpu.models.Llama": (Llama, "llm_training_tpu_torch.models.llama.hf_conversion"),
    "llm_training_tpu.models.Phi3": (Phi3, "llm_training_tpu_torch.models.phi3.hf_conversion"),
    "llm_training_tpu.models.Gemma": (Gemma, "llm_training_tpu_torch.models.gemma.hf_conversion"),
    "llm_training_tpu.models.Deepseek": (
        Deepseek, "llm_training_tpu_torch.models.deepseek.hf_conversion"),
    "llm_training_tpu.models.Glm4Moe": (
        Glm4Moe, "llm_training_tpu_torch.models.glm4_moe.hf_conversion"),
    "llm_training_tpu.models.GptOss": (
        GptOss, "llm_training_tpu_torch.models.gpt_oss.hf_conversion"),
    "llm_training_tpu.models.Ernie45Moe": (
        Ernie45Moe, "llm_training_tpu_torch.models.ernie45_moe.hf_conversion"),
    "llm_training_tpu.models.HunYuanMoe": (
        HunYuanMoe, "llm_training_tpu_torch.models.hunyuan_moe.hf_conversion"),
    "llm_training_tpu.models.Qwen3Next": (
        Qwen3Next, "llm_training_tpu_torch.models.qwen3_next.hf_conversion"),
    "llm_training_tpu.models.MiniMax": (
        MiniMax, "llm_training_tpu_torch.models.minimax.hf_conversion"),
    "llm_training_tpu.models.Bamba": (Bamba, "llm_training_tpu_torch.models.bamba.hf_conversion"),
}
# each family config's model class (a Phi3Config is a LlamaConfig: first)
_CONFIG_MODELS: tuple[tuple[type, type], ...] = (
    (Phi3Config, Phi3), (LlamaConfig, Llama), (GemmaConfig, Gemma),
    (DeepseekConfig, Deepseek), (Glm4MoeConfig, Glm4Moe), (GptOssConfig, GptOss),
    (Ernie45MoeConfig, Ernie45Moe), (HunYuanMoeConfig, HunYuanMoe),
    (Qwen3NextConfig, Qwen3Next), (MiniMaxConfig, MiniMax), (BambaConfig, Bamba),
)


def model_class_for_config(config) -> type:
    """The port's model class of a family config."""
    for config_cls, model_cls in _CONFIG_MODELS:
        if isinstance(config, config_cls):
            return model_cls
    raise TypeError(f"no model class for {type(config).__name__}")


@dataclass
class HFCausalLMConfig:
    """`hf_path` plus any family-config field as an override (checked by
    the family's own config, so a typo still fails loudly)."""

    hf_path: str
    load_hf_weights: bool = True
    # route an unknown model_type to the Llama family (renamed llama forks)
    assume_llama_layout: bool = False
    overrides: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: dict[str, Any], where: str = "config") -> "HFCausalLMConfig":
        """The node's own fields; every other key is an override."""
        own = {f.name for f in fields(cls)} - {"overrides"}
        if "hf_path" not in data:
            raise ValueError(f"HFCausalLM needs hf_path in {where}")
        return cls(**{k: v for k, v in data.items() if k in own},
                   overrides={k: v for k, v in data.items() if k not in own})


def resolve_hf_config(config: HFCausalLMConfig) -> tuple[type, LlamaConfig]:
    """(the port's model class, the family config) of an HF directory."""
    hf_config = load_hf_config(config.hf_path)
    model_cls, conversion = _FAMILY_CLASSES[
        model_class_for_hf(hf_config, config.assume_llama_layout)]
    overrides = dict(config.overrides)
    if config.load_hf_weights:
        overrides.setdefault("pre_trained_weights", config.hf_path)
    return model_cls, importlib.import_module(conversion).config_from_hf(hf_config, **overrides)


class HFCausalLM:
    """`HFCausalLM(config, device)` returns the routed family model; the
    weights are loaded by the objective (`lms/base.py` `init_model`)."""

    def __new__(cls, config: HFCausalLMConfig, device: torch.device | str | None = None):
        model_cls, family_config = resolve_hf_config(config)
        return model_cls(family_config, device=device)
