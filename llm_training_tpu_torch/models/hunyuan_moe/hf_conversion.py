"""HunYuan V1 MoE <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/hunyuan_moe/hf_conversion.py`: the
router under `mlp.gate.wg.weight`, the qk-norms as `query_layernorm` /
`key_layernorm`, the shared MLP as `mlp.shared_mlp.*`, one tensor an
expert. JAX exports layer by layer in both of its layouts, and so does
the port.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.hunyuan_moe.config import HunYuanMoeConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import (
    LOOPED,
    JaxLayout,
    Table,
    layers_from_hf,
    layers_to_hf,
)

_TABLE: Table = [
    *[(f"self_attn.{p}_proj.weight",) * 2 + (None,) for p in "qkvo"],
    ("self_attn.q_norm.weight", "self_attn.query_layernorm.weight", None),
    ("self_attn.k_norm.weight", "self_attn.key_layernorm.weight", None),
    ("mlp.gate_kernel", "mlp.gate.wg.weight", "T"),
    *[(f"mlp.shared_{p}.weight", f"mlp.shared_mlp.{p}.weight", None)
      for p in ("gate_proj", "up_proj", "down_proj")],
    ("input_layernorm.weight", "input_layernorm.weight", None),
    ("post_attention_layernorm.weight", "post_attention_layernorm.weight", None),
]
_BIASES: Table = [(f"self_attn.{p}_proj.bias",) * 2 + (None,) for p in "qkvo"]
_EXPERTS: Table = [(f"mlp.experts_{p}", f"mlp.experts.{{e}}.{p}.weight", "T")
                   for p in ("gate_proj", "up_proj", "down_proj")]


def layer_table(config: HunYuanMoeConfig) -> Table:
    return _TABLE + (_BIASES if config.attention_bias else [])


def params_from_hf(state_dict: Mapping[str, Any], config: HunYuanMoeConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.norm.weight", read(state_dict, keys, "norm.weight"))
    if not config.tie_word_embeddings:
        put("lm_head.weight", read(state_dict, keys, "lm_head.weight"))
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config), lambda i: _EXPERTS, config.num_experts)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: HunYuanMoeConfig) -> dict:
    """The port's state dict -> HF keys, layer by layer as JAX writes them."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head.weight"]
    layers_to_hf(params, out, JaxLayout(LOOPED), config.num_hidden_layers,
                 lambda i: layer_table(config), lambda i: _EXPERTS, config.num_experts)
    return out


def config_to_hf(config: HunYuanMoeConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's HunYuanMoeConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["HunYuanMoEV1ForCausalLM"],
        "model_type": "hunyuan_v1_moe",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.resolved_head_dim,
        "num_experts": config.num_experts,
        "moe_topk": config.moe_topk,
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
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> HunYuanMoeConfig:
    """HF HunYuan MoE config (object or dict) -> HunYuanMoeConfig;
    `overrides` win. Per-layer expert-count lists raise, as in JAX."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    for field in ("num_experts", "moe_topk"):
        if isinstance(get(field), (list, tuple)):
            raise ValueError(f"per-layer {field} lists are not supported (uniform expert "
                             "counts only)")
    return HunYuanMoeConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings", 32768),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 2),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        attention_bias=get("attention_bias", False),
        num_experts=get("num_experts", 16),
        moe_topk=get("moe_topk", 2),
    ), **overrides})
