"""ERNIE-4.5-MoE <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/ernie45_moe/hf_conversion.py`. HF
keeps the correction bias under `mlp.moe_statics` as `[1, E]` (the port's
`mlp.e_score_correction_bias [E]`), the router as `mlp.gate.weight`, one
tensor an expert (and one bias an expert under `use_bias`), and
`lm_head.bias` for the port's `lm_head_bias`; export writes the tied head
too (`lm_head.weight`, the embedding), as HF's state dicts hold it.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.ernie45_moe.config import Ernie45MoeConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf

_PROJS = ("gate_proj", "up_proj", "down_proj")
_NORMS = ["input_layernorm.weight", "post_attention_layernorm.weight"]


def _same(names: list[str]) -> Table:
    return [(n, n, None) for n in names]


def layer_table(config: Ernie45MoeConfig, i: int) -> Table:
    names = [f"self_attn.{p}_proj.weight" for p in "qkvo"]
    if config.use_bias:
        names += [f"self_attn.{p}_proj.bias" for p in "qkvo"]
    if not config.layer_is_moe(i):
        names += [f"mlp.{p}.weight" for p in _PROJS]
        if config.use_bias:
            names += [f"mlp.{p}.bias" for p in _PROJS]
        return _same(names + _NORMS)
    table = _same(names) + [
        ("mlp.gate_kernel", "mlp.gate.weight", "T"),
        ("mlp.e_score_correction_bias", "mlp.moe_statics.e_score_correction_bias", "row")]
    if config.moe_num_shared_experts:
        shared = [f"mlp.shared_experts.{p}.weight" for p in _PROJS]
        if config.use_bias:
            shared += [f"mlp.shared_experts.{p}.bias" for p in _PROJS]
        table += _same(shared)
    return table + _same(_NORMS)


def expert_table(config: Ernie45MoeConfig, i: int) -> Table:
    if not config.layer_is_moe(i):
        return []
    table = []
    for p in _PROJS:
        table.append((f"mlp.experts_{p}", f"mlp.experts.{{e}}.{p}.weight", "T"))
        if config.use_bias:
            table.append((f"mlp.experts_{p}_bias", f"mlp.experts.{{e}}.{p}.bias", None))
    return table


def params_from_hf(state_dict: Mapping[str, Any], config: Ernie45MoeConfig,
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
    if config.use_bias:
        put("lm_head_bias", read(state_dict, keys, "lm_head.bias"))
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config, i), lambda i: expert_table(config, i),
                   config.moe_num_experts)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: Ernie45MoeConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"],
           "lm_head.weight": params["model.embed_tokens.weight" if config.tie_word_embeddings
                                    else "lm_head.weight"]}
    if config.use_bias:
        out["lm_head.bias"] = params["lm_head_bias"]
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i), lambda i: expert_table(config, i),
                 config.moe_num_experts)
    return out


def config_to_hf(config: Ernie45MoeConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's Ernie45MoeConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["Ernie4_5_MoeForCausalLM"],
        "model_type": "ernie4_5_moe",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "moe_intermediate_size": config.moe_intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.resolved_head_dim,
        "moe_num_experts": config.moe_num_experts,
        "moe_k": config.moe_k,
        "moe_num_shared_experts": config.moe_num_shared_experts,
        "moe_layer_start_index": config.moe_layer_start_index,
        "moe_layer_end_index": config.moe_layer_end_index,
        "moe_layer_interval": config.moe_layer_interval,
        "moe_norm_min": config.moe_norm_min,
        "use_bias": config.use_bias,
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
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> Ernie45MoeConfig:
    """HF ERNIE-4.5-MoE config (object or dict) -> Ernie45MoeConfig;
    `overrides` win."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    return Ernie45MoeConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        moe_intermediate_size=get("moe_intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings", 131072),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 2),
        tie_word_embeddings=get("tie_word_embeddings", True),
        rope_theta=get("rope_theta", 500000.0),
        rope_scaling=get("rope_scaling"),
        use_bias=get("use_bias", False),
        moe_num_experts=get("moe_num_experts", 64),
        moe_k=get("moe_k", 6),
        moe_num_shared_experts=get("moe_num_shared_experts", 2),
        moe_layer_start_index=get("moe_layer_start_index", 1),
        moe_layer_end_index=get("moe_layer_end_index", -1),
        moe_layer_interval=get("moe_layer_interval", 1),
        moe_norm_min=get("moe_norm_min", 1e-12),
    ), **overrides})
