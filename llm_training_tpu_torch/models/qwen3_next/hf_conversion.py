"""Qwen3-Next <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/qwen3_next/hf_conversion.py`. HF's
layer names are the port's, but for the depthwise conv (HF's
`linear_attn.conv1d.weight [C, 1, K]`, the port's and JAX's `conv_kernel
[K, C]`) and the MoE block (the Llama graph's `MoEMLP`: one HF tensor an
expert, `mlp.experts.{e}.gate_proj.weight [I, H]`, stacked `[E, H, I]`; the
shared expert's matrices and gate in JAX's `[in, out]`). Export follows
JAX's key order for the config's layout (a scanned period slot by slot,
each slot's attention and norms name by name over its layers, then each
layer's conv and MoE keys).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.deepseek.hf_conversion import top_from_hf, top_to_hf
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf
from llm_training_tpu_torch.models.qwen3_next.config import Qwen3NextConfig

_FULL_ATTN: Table = [(f"self_attn.{n}.weight",) * 2 + (None,)
                     for n in ("q_proj", "k_proj", "v_proj", "o_proj", "q_norm", "k_norm")]
_LINEAR_ATTN: Table = [
    *[(f"linear_attn.{n}.weight",) * 2 + (None,)
      for n in ("in_proj_qkvz", "in_proj_ba", "out_proj", "norm")],
    ("linear_attn.A_log", "linear_attn.A_log", None),
    ("linear_attn.dt_bias", "linear_attn.dt_bias", None),
]
_NORMS: Table = [(f"{n}.weight",) * 2 + (None,)
                 for n in ("input_layernorm", "post_attention_layernorm")]
_SHARED = ("gate_proj", "up_proj", "down_proj")


def layer_table(config: Qwen3NextConfig, i: int) -> Table:
    """JAX's per-layer table (stacked name by name in a scanned period)."""
    return (_LINEAR_ATTN if config.layer_is_linear(i) else _FULL_ATTN) + _NORMS


def moe_table(prefix: str, config) -> Table:
    """The Llama graph's `MoEMLP` under `prefix` (HF's module name) against
    HF's per-expert keys, in JAX's export order: the router, the experts
    projection by projection, the shared expert and its gate."""
    names = ({"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
             if config.moe_style == "mixtral" else {p: p for p in _SHARED})
    table = [(f"{prefix}.gate.weight", f"{prefix}.gate.weight", None)]
    table += [(f"{prefix}.experts_{ours}", f"{prefix}.experts.{{e}}.{hf}.weight", "T")
              for ours, hf in names.items()]
    if config.shared_expert_intermediate_size:
        table += [(f"{prefix}.shared_{p}", f"{prefix}.shared_expert.{p}.weight", "T")
                  for p in _SHARED]
        table.append((f"{prefix}.shared_expert_gate", f"{prefix}.shared_expert_gate.weight", "T"))
    return table


def extras_table(config: Qwen3NextConfig, i: int) -> Table:
    """Layer i's keys exported after the stacked ones: the conv, the MoE."""
    table = ([("linear_attn.conv_kernel", "linear_attn.conv1d.weight", "conv")]
             if config.layer_is_linear(i) else [])
    return table + (moe_table("mlp", config) if config.num_experts else [])


def params_from_hf(state_dict: Mapping[str, Any], config: Qwen3NextConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict, each tensor
    through `leaf_fn` as it is read."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    top_from_hf(state_dict, config, put, keys)
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config, i), lambda i: extras_table(config, i),
                   config.num_experts or 0)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: Qwen3NextConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = top_to_hf(params, config)
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i), lambda i: extras_table(config, i),
                 config.num_experts or 0)
    return out


def config_to_hf(config: Qwen3NextConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's Qwen3NextConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["Qwen3NextForCausalLM"],
        "model_type": "qwen3_next",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "partial_rotary_factor": config.partial_rotary_factor,
        "layer_types": ["linear_attention" if config.layer_is_linear(i) else "full_attention"
                        for i in range(config.num_hidden_layers)],
        "linear_num_key_heads": config.linear_num_key_heads,
        "linear_num_value_heads": config.linear_num_value_heads,
        "linear_key_head_dim": config.linear_key_head_dim,
        "linear_value_head_dim": config.linear_value_head_dim,
        "linear_conv_kernel_dim": config.linear_conv_kernel_dim,
        "num_experts": config.num_experts,
        "num_experts_per_tok": config.num_experts_per_tok,
        "moe_intermediate_size": config.moe_intermediate_size,
        "norm_topk_prob": config.norm_topk_prob,
        "shared_expert_intermediate_size": config.shared_expert_intermediate_size,
        "router_aux_loss_coef": config.router_aux_loss_coef,
        "decoder_sparse_step": 1,
        "mlp_only_layers": [],
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
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> Qwen3NextConfig:
    """HF Qwen3-Next config (object or dict) -> Qwen3NextConfig; `overrides`
    win. Mixed dense/sparse schedules refuse, as in JAX."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers"):
        raise ValueError(
            "mixed dense/sparse layer schedules (decoder_sparse_step != 1 or "
            "mlp_only_layers) are not supported")
    return Qwen3NextConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim", 256),
        max_position_embeddings=get("max_position_embeddings", 32768),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id"),
        eos_token_id=get("eos_token_id"),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        partial_rotary_factor=get("partial_rotary_factor", 0.25),
        attention_bias=get("attention_bias", False),
        attention_dropout=get("attention_dropout", 0.0),
        layer_types=list(get("layer_types") or []) or None,
        linear_num_key_heads=get("linear_num_key_heads", 16),
        linear_num_value_heads=get("linear_num_value_heads", 32),
        linear_key_head_dim=get("linear_key_head_dim", 128),
        linear_value_head_dim=get("linear_value_head_dim", 128),
        linear_conv_kernel_dim=get("linear_conv_kernel_dim", 4),
        num_experts=get("num_experts"),
        num_experts_per_tok=get("num_experts_per_tok", 10),
        moe_intermediate_size=get("moe_intermediate_size"),
        norm_topk_prob=get("norm_topk_prob", True),
        shared_expert_intermediate_size=get("shared_expert_intermediate_size"),
        router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
    ), **overrides})
