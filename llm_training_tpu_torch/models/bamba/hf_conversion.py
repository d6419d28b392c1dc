"""Bamba <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/bamba/hf_conversion.py`. HF's layer
names are the port's, but for the depthwise conv (HF's `mamba.conv1d.weight
[C, 1, K]` and `mamba.conv1d.bias`, the port's and JAX's `mamba.conv_kernel
[K, C]` and `mamba.conv_bias`) and the final norm (`final_layernorm`).
Export follows JAX's key order for the config's layout (a scanned period
slot by slot, each slot's names over its layers, then each layer's conv).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.bamba.config import BambaConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf

_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _same(names) -> Table:
    return [(n, n, None) for n in names]


def layer_table(config: BambaConfig, i: int) -> Table:
    """JAX's per-layer table (stacked name by name in a scanned period)."""
    if config.layer_is_attention(i):
        names = [f"self_attn.{p}.weight" for p in _PROJS]
        if config.attention_bias:
            names += [f"self_attn.{p}.bias" for p in _PROJS]
        table = _same(names)
    else:
        table = _same(["mamba.in_proj.weight", "mamba.out_proj.weight", "mamba.norm.weight",
                       "mamba.A_log", "mamba.D", "mamba.dt_bias"])
        if config.mamba_conv_bias:
            table.append(("mamba.conv_bias", "mamba.conv1d.bias", None))
        if config.mamba_proj_bias:
            table += _same(["mamba.in_proj.bias", "mamba.out_proj.bias"])
    if config.mlp_bias:
        table += _same([f"feed_forward.{p}.bias" for p in _MLP])
    return table + _same([f"feed_forward.{p}.weight" for p in _MLP]
                         + ["input_layernorm.weight", "pre_ff_layernorm.weight"])


def extras_table(config: BambaConfig, i: int) -> Table:
    """Layer i's keys exported after the stacked ones: a mixer's conv."""
    if config.layer_is_attention(i):
        return []
    return [("mamba.conv_kernel", "mamba.conv1d.weight", "conv")]


def params_from_hf(state_dict: Mapping[str, Any], config: BambaConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict, each tensor
    through `leaf_fn` as it is read."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.final_layernorm.weight", read(state_dict, keys, "final_layernorm.weight"))
    if not config.tie_word_embeddings:
        put("lm_head.weight", read(state_dict, keys, "lm_head.weight"))
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config, i), lambda i: extras_table(config, i), 0)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: BambaConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.final_layernorm.weight": params["model.final_layernorm.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head.weight"]
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i), lambda i: extras_table(config, i), 0)
    return out


def config_to_hf(config: BambaConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's BambaConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["BambaForCausalLM"],
        "model_type": "bamba",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "attn_layer_indices": config.attn_layer_indices,
        "mamba_n_heads": config.mamba_n_heads,
        "mamba_d_head": config.mamba_d_head,
        "mamba_n_groups": config.mamba_n_groups,
        "mamba_d_state": config.mamba_d_state,
        "mamba_expand": config.mamba_expand,
        "mamba_d_conv": config.mamba_d_conv,
        "mamba_conv_bias": config.mamba_conv_bias,
        "mamba_proj_bias": config.mamba_proj_bias,
        "mamba_chunk_size": config.mamba_chunk_size,
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
        "partial_rotary_factor": config.partial_rotary_factor,
        "attention_bias": config.attention_bias,
        "attention_dropout": config.attention_dropout,
        "mlp_bias": config.mlp_bias,
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> BambaConfig:
    """HF Bamba config (object or dict) -> BambaConfig; `overrides` win."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    return BambaConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        max_position_embeddings=get("max_position_embeddings", 262144),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 2),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        partial_rotary_factor=get("partial_rotary_factor", 0.5),
        attention_bias=get("attention_bias", False),
        attention_dropout=get("attention_dropout", 0.0),
        mlp_bias=get("mlp_bias", False),
        attn_layer_indices=list(get("attn_layer_indices") or []) or None,
        mamba_n_heads=get("mamba_n_heads", 128),
        mamba_d_head=get("mamba_d_head", 64),
        mamba_n_groups=get("mamba_n_groups", 1),
        mamba_d_state=get("mamba_d_state", 256),
        mamba_expand=get("mamba_expand", 2),
        mamba_d_conv=get("mamba_d_conv", 4),
        mamba_conv_bias=get("mamba_conv_bias", True),
        mamba_proj_bias=get("mamba_proj_bias", False),
        mamba_chunk_size=get("mamba_chunk_size", 256),
    ), **overrides})
