"""MiniMax <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/minimax/hf_conversion.py`. HF's
layer names are the port's, but for the MoE block (the Llama graph's
`MoEMLP` under `block_sparse_moe`: Mixtral's per-expert `w1`/`w3`/`w2`,
stacked `[E, H, I]`). Export writes what HF persists beside the weights:
each lightning layer's decay buffers (`self_attn.slope_rate`,
`query_decay`, `key_decay`, `diagonal_decay`), recomputed from the config
as JAX's export does; import reads none of them. Export follows JAX's key
order for the config's layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from llm_training_tpu_torch.models.deepseek.hf_conversion import top_from_hf, top_to_hf
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.minimax.config import MiniMaxConfig
from llm_training_tpu_torch.models.minimax.model import slope_rate
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf
from llm_training_tpu_torch.models.qwen3_next.hf_conversion import moe_table

_FULL_ATTN: Table = [(f"self_attn.{p}.weight",) * 2 + (None,)
                     for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
_LINEAR_ATTN: Table = [(f"self_attn.{p}.weight",) * 2 + (None,)
                       for p in ("qkv_proj", "output_gate", "out_proj", "norm")]
_NORMS: Table = [(f"{n}.weight",) * 2 + (None,)
                 for n in ("input_layernorm", "post_attention_layernorm")]
DECAY_BUFFERS = ("slope_rate", "query_decay", "key_decay", "diagonal_decay")


def decay_buffers(config: MiniMaxConfig, i: int) -> dict[str, torch.Tensor]:
    """The lightning layer i's decay buffers as HF persists them (fp32)."""
    c = config.block_size
    slope = slope_rate(config.num_attention_heads, i, config.num_hidden_layers)[:, None, None]
    pos = (np.arange(c, dtype=np.float32) + 1.0)[:, None]
    diff = pos - pos.T
    values = {
        "slope_rate": slope,
        "query_decay": np.exp(-slope * pos[None]),
        "key_decay": np.exp(-slope * (c - pos)[None]),
        "diagonal_decay": np.where(diff >= 0, np.exp(-slope * diff[None]), 0.0)[None],
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in values.items()}


def layer_table(config: MiniMaxConfig, i: int) -> Table:
    """JAX's per-layer table (stacked name by name in a scanned period)."""
    return (_LINEAR_ATTN if config.layer_is_linear(i) else _FULL_ATTN) + _NORMS


def extras_table(config: MiniMaxConfig, i: int, export: bool = False) -> Table:
    """Layer i's keys exported after the stacked ones: a lightning layer's
    decay buffers (export only), then the MoE."""
    table = ([(f"self_attn.{b}",) * 2 + (None,) for b in DECAY_BUFFERS]
             if export and config.layer_is_linear(i) else [])
    return table + moe_table("block_sparse_moe", config)


def params_from_hf(state_dict: Mapping[str, Any], config: MiniMaxConfig,
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
                   config.num_experts)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: MiniMaxConfig) -> dict:
    """The port's state dict -> HF keys (the decay buffers included), in
    JAX's order."""
    buffers = {f"model.layers.{i}.self_attn.{name}": value
               for i in range(config.num_hidden_layers) if config.layer_is_linear(i)
               for name, value in decay_buffers(config, i).items()}
    out = top_to_hf(params, config)
    layers_to_hf({**params, **buffers}, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i), lambda i: extras_table(config, i, True),
                 config.num_experts)
    return out


def config_to_hf(config: MiniMaxConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's MiniMaxConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["MiniMaxForCausalLM"],
        "model_type": "minimax",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.resolved_head_dim,
        # HF MiniMax (as Mixtral) names the experts' width intermediate_size
        "intermediate_size": config.moe_intermediate_size,
        "layer_types": list(config.layer_types),
        "block_size": config.block_size,
        "full_attn_alpha_factor": config.full_attn_alpha_factor,
        "full_attn_beta_factor": config.full_attn_beta_factor,
        "linear_attn_alpha_factor": config.linear_attn_alpha_factor,
        "linear_attn_beta_factor": config.linear_attn_beta_factor,
        "mlp_alpha_factor": config.mlp_alpha_factor,
        "mlp_beta_factor": config.mlp_beta_factor,
        "num_local_experts": config.num_experts,
        "num_experts_per_tok": config.num_experts_per_tok,
        "router_aux_loss_coef": config.router_aux_loss_coef,
        "router_jitter_noise": 0.0,
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
        "use_cache": True,
        "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> MiniMaxConfig:
    """HF MiniMax config (object or dict) -> MiniMaxConfig; `overrides`
    win. A router jitter refuses, as in JAX."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    if get("router_jitter_noise", 0.0):
        raise ValueError("minimax router_jitter_noise is not supported; set it to 0.0")
    return MiniMaxConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        # HF's intermediate_size is the experts' width (Mixtral's)
        intermediate_size=get("intermediate_size"),
        moe_intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings"),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id"),
        eos_token_id=get("eos_token_id"),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 1e6),
        rope_scaling=get("rope_scaling"),
        attention_bias=get("attention_bias", False),
        attention_dropout=get("attention_dropout", 0.0),
        sliding_window=get("sliding_window"),
        layer_types=list(get("layer_types") or []) or None,
        block_size=get("block_size", 256),
        full_attn_alpha_factor=get("full_attn_alpha_factor", 1.0),
        full_attn_beta_factor=get("full_attn_beta_factor", 1.0),
        linear_attn_alpha_factor=get("linear_attn_alpha_factor", 1.0),
        linear_attn_beta_factor=get("linear_attn_beta_factor", 1.0),
        mlp_alpha_factor=get("mlp_alpha_factor", 1.0),
        mlp_beta_factor=get("mlp_beta_factor", 1.0),
        num_experts=get("num_local_experts"),
        num_experts_per_tok=get("num_experts_per_tok", 2),
        norm_topk_prob=True,  # Mixtral's renormalisation
        router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
    ), **overrides})
