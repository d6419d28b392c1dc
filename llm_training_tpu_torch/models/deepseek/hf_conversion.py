"""DeepSeek V2/V3 <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/deepseek/hf_conversion.py`. HF's
layer names are the port's, but for the router (`mlp.gate.weight [E, H]`,
the port's `mlp.gate_kernel [H, E]`), its correction bias
(`mlp.gate.e_score_correction_bias`) and the experts, one HF tensor an
expert (`mlp.experts.{e}.gate_proj.weight [I, H]`), stacked `[E, H, I]`.
Export follows JAX's key order for the config's layout (the looped dense
prefix layer by layer, the scanned MoE suffix name by name).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.deepseek.config import DeepseekConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf

_ATTN_COMMON = ["self_attn.kv_a_proj_with_mqa.weight", "self_attn.kv_a_layernorm.weight",
                "self_attn.kv_b_proj.weight", "self_attn.o_proj.weight",
                "input_layernorm.weight", "post_attention_layernorm.weight"]
_Q_FULL = ["self_attn.q_proj.weight"]
_Q_LORA = ["self_attn.q_a_proj.weight", "self_attn.q_a_layernorm.weight",
           "self_attn.q_b_proj.weight"]
_ATTN_BIASES = ["self_attn.kv_a_proj_with_mqa.bias", "self_attn.o_proj.bias"]
_DENSE_MLP = [f"mlp.{p}.weight" for p in ("gate_proj", "up_proj", "down_proj")]
_SHARED_MLP = [f"mlp.shared_experts.{p}.weight" for p in ("gate_proj", "up_proj", "down_proj")]
_EXPERT_PROJS = ("gate_proj", "up_proj", "down_proj")


def layer_table(config: DeepseekConfig, i: int) -> Table:
    names = list(_ATTN_COMMON) + (_Q_FULL if config.q_lora_rank is None else _Q_LORA)
    if config.attention_bias:
        names += _ATTN_BIASES
        if config.q_lora_rank is not None:
            names.append("self_attn.q_a_proj.bias")
    if not config.layer_is_moe(i):
        return [(n, n, None) for n in names + _DENSE_MLP]
    table = [(n, n, None) for n in names + _SHARED_MLP]
    table.append(("mlp.gate_kernel", "mlp.gate.weight", "T"))
    if config.version == 3:
        table.append(("mlp.e_score_correction_bias", "mlp.gate.e_score_correction_bias", None))
    return table


def expert_table(config, i: int) -> Table:
    if not config.layer_is_moe(i):
        return []
    return [(f"mlp.experts_{p}", f"mlp.experts.{{e}}.{p}.weight", "T") for p in _EXPERT_PROJS]


def top_from_hf(state_dict, config, put, keys) -> None:
    put("model.embed_tokens.weight", read(state_dict, keys, "embed_tokens.weight"))
    put("model.norm.weight", read(state_dict, keys, "norm.weight"))
    if not config.tie_word_embeddings:
        put("lm_head.weight", read(state_dict, keys, "lm_head.weight"))


def top_to_hf(params, config) -> dict[str, torch.Tensor]:
    out = {"model.embed_tokens.weight": params["model.embed_tokens.weight"],
           "model.norm.weight": params["model.norm.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head.weight"]
    return out


def params_from_hf(state_dict: Mapping[str, Any], config: DeepseekConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict, each tensor
    through `leaf_fn` as it is read."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    top_from_hf(state_dict, config, put, keys)
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config, i), lambda i: expert_table(config, i),
                   config.n_routed_experts or 0)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: DeepseekConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = top_to_hf(params, config)
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i), lambda i: expert_table(config, i),
                 config.n_routed_experts or 0)
    return out


def config_to_hf(config: DeepseekConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's DeepseekConfig -> HF `config.json` dict (as JAX's)."""
    v3 = config.version == 3
    return {
        "architectures": ["DeepseekV3ForCausalLM" if v3 else "DeepseekV2ForCausalLM"],
        "model_type": "deepseek_v3" if v3 else "deepseek_v2",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "moe_intermediate_size": config.moe_intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_attention_heads,
        "q_lora_rank": config.q_lora_rank,
        "kv_lora_rank": config.kv_lora_rank,
        "qk_rope_head_dim": config.qk_rope_head_dim,
        "qk_nope_head_dim": config.qk_nope_head_dim,
        "v_head_dim": config.v_head_dim,
        "n_routed_experts": config.n_routed_experts,
        "n_shared_experts": config.n_shared_experts,
        "num_experts_per_tok": config.num_experts_per_tok,
        "first_k_dense_replace": config.first_k_dense_replace,
        "norm_topk_prob": config.norm_topk_prob,
        "routed_scaling_factor": config.routed_scaling_factor,
        "n_group": config.n_group,
        "topk_group": config.topk_group,
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
        "use_cache": True,
        "torch_dtype": torch_dtype,
        **({"rope_interleave": config.rope_interleave} if v3
           else {"topk_method": config.topk_method}),
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> DeepseekConfig:
    """HF DeepSeek config (object or dict) -> DeepseekConfig; `overrides`
    win. kimi_k2 is the V3 graph under its own model_type."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    version = 3 if get("model_type") in ("deepseek_v3", "kimi_k2") else 2
    if version == 2 and get("topk_method", "greedy") not in ("greedy", "group_limited_greedy"):
        raise ValueError(f"unsupported topk_method {get('topk_method')!r}")
    return DeepseekConfig(**{**dict(
        version=version,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        moe_intermediate_size=get("moe_intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 0),
        eos_token_id=get("eos_token_id", 1),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        rope_interleave=get("rope_interleave", True),
        attention_bias=get("attention_bias", False),
        attention_dropout=get("attention_dropout", 0.0),
        q_lora_rank=get("q_lora_rank"),
        kv_lora_rank=get("kv_lora_rank", 512),
        qk_rope_head_dim=get("qk_rope_head_dim", 64),
        qk_nope_head_dim=get("qk_nope_head_dim", 128),
        v_head_dim=get("v_head_dim", 128),
        n_routed_experts=get("n_routed_experts"),
        n_shared_experts=get("n_shared_experts", 1),
        num_experts_per_tok=get("num_experts_per_tok", 8),
        first_k_dense_replace=get("first_k_dense_replace", 0),
        norm_topk_prob=get("norm_topk_prob", True),
        routed_scaling_factor=get("routed_scaling_factor", 1.0),
        n_group=get("n_group"),
        topk_group=get("topk_group"),
        topk_method=get("topk_method", "greedy") if version == 2 else "greedy",
    ), **overrides})
