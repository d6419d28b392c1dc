"""Gemma 1/2/3 <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/gemma/hf_conversion.py`. HF's layer
names are the port's parameter names, so a tensor crosses as it is: the
embeddings are always tied (no `lm_head` key either way), Gemma-2 and 3
carry two more norms per layer, and Gemma-3 its qk-norms. Export follows
JAX's key order, which follows its tree's layout: parameter by parameter,
each over the layers in order, or, for a Gemma-2 config JAX scans in
(sliding, full) pairs, the even (sliding) layers before the odd ones.
`config_to_hf` refuses, as JAX's does, a version-3 config without qk-norm.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.gemma.config import GemmaConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read

# in-layer names, in JAX's export order
_LAYER_PARAMS = [
    "self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
    "self_attn.o_proj.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight",
    "mlp.down_proj.weight", "input_layernorm.weight", "post_attention_layernorm.weight",
]
_V2_NORM_PARAMS = ["pre_feedforward_layernorm.weight", "post_feedforward_layernorm.weight"]
_V3_QK_NORM_PARAMS = ["self_attn.q_norm.weight", "self_attn.k_norm.weight"]


def layer_params(config: GemmaConfig) -> list[str]:
    extra = _V2_NORM_PARAMS if config.version in (2, 3) else []
    if config.version == 3 and config.use_qk_norm:
        extra = extra + _V3_QK_NORM_PARAMS
    return _LAYER_PARAMS + extra


def _export_layers(config: GemmaConfig) -> list[int]:
    """The layers in JAX's export order for one parameter."""
    layers = list(range(config.num_hidden_layers))
    if config.scan_layers and config.paired:
        return layers[0::2] + layers[1::2]
    return layers


def params_from_hf(
    state_dict: Mapping[str, Any], config: GemmaConfig, leaf_fn: LeafFn | None = None
) -> dict[str, torch.Tensor]:
    """HF Gemma state dict (a lazy mapping) -> the port's state dict, each
    tensor through `leaf_fn` as it is read."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.norm.weight", read(state_dict, keys, "norm.weight"))
    for i in range(config.num_hidden_layers):
        for name in layer_params(config):
            put(f"model.layers.{i}.{name}", read(state_dict, keys, f"layers.{i}.{name}"))
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: GemmaConfig) -> dict[str, torch.Tensor]:
    """The port's state dict -> HF Gemma keys, in JAX's order."""
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"]}
    for name in layer_params(config):
        for i in _export_layers(config):
            out[f"model.layers.{i}.{name}"] = params[f"model.layers.{i}.{name}"]
    return out


def config_to_hf(config: GemmaConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's GemmaConfig -> HF `config.json` dict (as JAX's)."""
    common = {
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh",
        "max_position_embeddings": config.max_position_embeddings,
        "initializer_range": config.initializer_range,
        "rms_norm_eps": config.rms_norm_eps,
        "pad_token_id": config.pad_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "tie_word_embeddings": True,
        "rope_theta": config.rope_theta,
        "attention_bias": config.attention_bias,
        "attention_dropout": 0.0,
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }
    if config.version == 3:
        if not config.use_qk_norm:
            raise ValueError(
                "version=3 with use_qk_norm=False cannot be exported as "
                "gemma3_text (HF always applies q/k norms)"
            )
        return {
            "architectures": ["Gemma3ForCausalLM"],
            "model_type": "gemma3_text",
            "query_pre_attn_scalar": config.query_pre_attn_scalar or config.head_dim,
            "sliding_window": config.sliding_window,
            "layer_types": config.layer_types or ["full_attention"] * config.num_hidden_layers,
            "rope_local_base_freq": config.rope_local_base_freq,
            "rope_scaling": config.rope_scaling,
            "use_qk_norm": config.use_qk_norm,
            **common,
        }
    if config.version == 2:
        return {
            "architectures": ["Gemma2ForCausalLM"],
            "model_type": "gemma2",
            "query_pre_attn_scalar": config.query_pre_attn_scalar or config.head_dim,
            "attn_logit_softcapping": config.attn_logit_softcapping,
            "final_logit_softcapping": config.final_logit_softcapping,
            "sliding_window": config.sliding_window,
            **common,
        }
    return {"architectures": ["GemmaForCausalLM"], "model_type": "gemma", **common}


def config_fields_from_hf(hf_config: Any, **overrides: Any) -> dict[str, Any]:
    """HF Gemma config (object or dict) -> the GemmaConfig fields JAX's
    `config_from_hf` sets; `overrides` win."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d)
    )
    version = {"gemma2": 2, "gemma3_text": 3}.get(get("model_type"), 1)
    fields = dict(
        version=version,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        head_dim=get("head_dim", 256),
        max_position_embeddings=get("max_position_embeddings", 8192),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 10000.0),
        attention_bias=get("attention_bias", False),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 2),
        eos_token_id=get("eos_token_id", 1),
    )
    if version == 2:
        fields.update(
            query_pre_attn_scalar=get("query_pre_attn_scalar"),
            attn_logit_softcapping=get("attn_logit_softcapping"),
            final_logit_softcapping=get("final_logit_softcapping"),
            sliding_window=get("sliding_window"),
        )
    if version == 3:
        fields.update(
            query_pre_attn_scalar=get("query_pre_attn_scalar"),
            sliding_window=get("sliding_window"),
            layer_types=list(get("layer_types") or []) or None,
            rope_local_base_freq=get("rope_local_base_freq", 10000.0),
            rope_scaling=get("rope_scaling"),
            # HF's Gemma-3 text models always apply q/k norms
            use_qk_norm=get("use_qk_norm", True),
        )
    return {**fields, **overrides}


def config_from_hf(hf_config: Any, **overrides: Any) -> GemmaConfig:
    return GemmaConfig(**config_fields_from_hf(hf_config, **overrides))
