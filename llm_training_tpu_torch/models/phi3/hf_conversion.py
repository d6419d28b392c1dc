"""Phi-3 <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/phi3/hf_conversion.py`. HF Phi-3
stores fused `qkv_proj` and `gate_up_proj` matrices; the port's model
keeps the Llama projections, so reading splits them (rows: q, k, v; gate,
up) and writing merges them, in JAX's key order.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.llama.hf_conversion import (
    LeafFn,
    canonical_keys,
    read,
)
from llm_training_tpu_torch.models.phi3.config import Phi3Config

# the in-layer names that are not fused, in JAX's export order
SPLIT_LAYER_PARAMS = (
    "self_attn.o_proj.weight", "mlp.down_proj.weight",
    "input_layernorm.weight", "post_attention_layernorm.weight",
)


def _qkv_splits(config: Phi3Config) -> tuple[int, int]:
    head_dim = config.resolved_head_dim
    return config.num_attention_heads * head_dim, config.num_key_value_heads * head_dim


def params_from_hf(
    state_dict: Mapping[str, Any], config: Phi3Config, leaf_fn: LeafFn | None = None
) -> dict[str, torch.Tensor]:
    """HF Phi-3 state dict (a lazy mapping) -> the port's state dict, layers
    `0..num_hidden_layers-1`, each tensor through `leaf_fn` as it is made."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.norm.weight", read(state_dict, keys, "norm.weight"))
    if not config.tie_word_embeddings:
        put("lm_head.weight", read(state_dict, keys, "lm_head.weight"))
    q_size, kv_size = _qkv_splits(config)
    inter = config.intermediate_size
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}."
        qkv = read(state_dict, keys, f"layers.{i}.self_attn.qkv_proj.weight")  # [q+2kv, hidden]
        put(prefix + "self_attn.q_proj.weight", qkv[:q_size])
        put(prefix + "self_attn.k_proj.weight", qkv[q_size:q_size + kv_size])
        put(prefix + "self_attn.v_proj.weight", qkv[q_size + kv_size:])
        del qkv
        gate_up = read(state_dict, keys, f"layers.{i}.mlp.gate_up_proj.weight")  # [2 inter, hidden]
        put(prefix + "mlp.gate_proj.weight", gate_up[:inter])
        put(prefix + "mlp.up_proj.weight", gate_up[inter:])
        del gate_up
        for name in SPLIT_LAYER_PARAMS:
            put(prefix + name, read(state_dict, keys, f"layers.{i}.{name}"))
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: Phi3Config) -> dict[str, torch.Tensor]:
    """The port's state dict -> HF Phi-3 keys with the fused projections."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head.weight"]
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}."
        out[prefix + "self_attn.qkv_proj.weight"] = torch.cat(
            [params[prefix + f"self_attn.{p}_proj.weight"] for p in "qkv"])
        out[prefix + "mlp.gate_up_proj.weight"] = torch.cat(
            [params[prefix + "mlp.gate_proj.weight"], params[prefix + "mlp.up_proj.weight"]])
        for name in SPLIT_LAYER_PARAMS:
            out[prefix + name] = params[prefix + name]
    return out


def config_to_hf(config: Phi3Config, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's Phi3Config -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["Phi3ForCausalLM"],
        "model_type": "phi3",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "hidden_act": "silu",
        "max_position_embeddings": config.max_position_embeddings,
        "original_max_position_embeddings": config.original_max_position_embeddings
        or config.max_position_embeddings,
        "initializer_range": config.initializer_range,
        "rms_norm_eps": config.rms_norm_eps,
        "pad_token_id": config.pad_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "tie_word_embeddings": config.tie_word_embeddings,
        "rope_theta": config.rope_theta,
        "rope_scaling": config.rope_scaling,
        "sliding_window": config.sliding_window,
        "attention_dropout": 0.0,
        "embd_pdrop": 0.0,
        "resid_pdrop": 0.0,
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_fields_from_hf(hf_config: Any, **overrides: Any) -> dict[str, Any]:
    """HF Phi-3 config (object or dict) -> the Phi3Config fields JAX's
    `config_from_hf` sets; `overrides` win."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d)
    )
    return {**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        original_max_position_embeddings=get("original_max_position_embeddings"),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 32000),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        sliding_window=get("sliding_window"),
    ), **overrides}


def config_from_hf(hf_config: Any, **overrides: Any) -> Phi3Config:
    return Phi3Config(**config_fields_from_hf(hf_config, **overrides))
