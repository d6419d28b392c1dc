"""gpt-oss <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/gpt_oss/hf_conversion.py`. HF
already stacks the experts (`mlp.experts.gate_up_proj [E, H, 2I]`, the
JAX and port layout, and their biases); the port keeps them under JAX's
names (`mlp.experts_gate_up_proj`). The router is a torch Linear on both
sides. Export follows JAX's key order for the periodic layout (slot by
slot, each name over the slot's layers).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.gpt_oss.config import GptOssConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf

_TABLE: Table = [
    *[(f"self_attn.{p}_proj.{leaf}",) * 2 + (None,) for p in "qkvo" for leaf in ("weight", "bias")],
    ("self_attn.sinks", "self_attn.sinks", None),
    ("mlp.router.weight", "mlp.router.weight", None),
    ("mlp.router.bias", "mlp.router.bias", None),
    *[(f"mlp.experts_{p}", f"mlp.experts.{p}", None)
      for p in ("gate_up_proj", "gate_up_proj_bias", "down_proj", "down_proj_bias")],
    ("input_layernorm.weight", "input_layernorm.weight", None),
    ("post_attention_layernorm.weight", "post_attention_layernorm.weight", None),
]


def params_from_hf(state_dict: Mapping[str, Any], config: GptOssConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.norm.weight", read(state_dict, keys, "norm.weight"))
    put("lm_head.weight", read(state_dict, keys, "lm_head.weight"))
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: _TABLE, lambda i: [], 0)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: GptOssConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"],
           "lm_head.weight": params["lm_head.weight"]}
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: _TABLE, lambda i: [], 0)
    return out


def config_to_hf(config: GptOssConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's GptOssConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["GptOssForCausalLM"],
        "model_type": "gpt_oss",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "num_local_experts": config.num_local_experts,
        "num_experts_per_tok": config.num_experts_per_tok,
        "router_aux_loss_coef": config.router_aux_loss_coef,
        "output_router_logits": False,
        "hidden_act": "silu",
        "max_position_embeddings": config.max_position_embeddings,
        "initializer_range": config.initializer_range,
        "rms_norm_eps": config.rms_norm_eps,
        "pad_token_id": config.pad_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "tie_word_embeddings": config.tie_word_embeddings,
        "rope_theta": config.rope_theta,
        "rope_scaling": config.rope_scaling,
        "attention_bias": config.attention_bias,
        "attention_dropout": config.attention_dropout,
        "sliding_window": config.sliding_window,
        "layer_types": (config.layer_types or [
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(config.num_hidden_layers)]),
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> GptOssConfig:
    """HF gpt-oss config (object or dict) -> GptOssConfig; `overrides` win."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    return GptOssConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim", 64),
        max_position_embeddings=get("max_position_embeddings", 131072),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id"),
        eos_token_id=get("eos_token_id"),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 150000.0),
        rope_scaling=get("rope_scaling"),
        attention_bias=get("attention_bias", True),
        attention_dropout=get("attention_dropout", 0.0),
        sliding_window=get("sliding_window", 128),
        layer_types=list(get("layer_types") or []) or None,
        num_local_experts=get("num_local_experts", 128),
        num_experts_per_tok=get("num_experts_per_tok", 4),
        router_aux_loss_coef=get("router_aux_loss_coef", 0.9),
    ), **overrides})
