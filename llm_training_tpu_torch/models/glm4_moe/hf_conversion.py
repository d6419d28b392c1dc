"""GLM-4.5 (and dots1) <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/glm4_moe/hf_conversion.py`: plain
GQA attention names, DeepSeek's MoE key layout (`mlp.gate.weight`, its
`e_score_correction_bias`, one HF tensor an expert, `shared_experts`), and
JAX's refusals on export (a windowed or o-biased config is dots1's; dots1
needs full rotary, qk-norm and one bias flag).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from llm_training_tpu_torch.models.deepseek import hf_conversion as deepseek_hf
from llm_training_tpu_torch.models.glm4_moe.config import Glm4MoeConfig
from llm_training_tpu_torch.models.llama.hf_conversion import LeafFn, canonical_keys, read
from llm_training_tpu_torch.models.moe_scan_io import Table, layers_from_hf, layers_to_hf

_ATTN = [f"self_attn.{p}_proj.weight" for p in "qkvo"]
_ATTN_BIASES = [f"self_attn.{p}_proj.bias" for p in "qkv"]
_QK_NORMS = ["self_attn.q_norm.weight", "self_attn.k_norm.weight"]
_DENSE_MLP = [f"mlp.{p}.weight" for p in ("gate_proj", "up_proj", "down_proj")]
_SHARED_MLP = [f"mlp.shared_experts.{p}.weight" for p in ("gate_proj", "up_proj", "down_proj")]
_NORMS = ["input_layernorm.weight", "post_attention_layernorm.weight"]


def layer_table(config: Glm4MoeConfig, i: int) -> Table:
    names = list(_ATTN)
    if config.attention_bias:
        names += _ATTN_BIASES
    if config.attention_out_bias:
        names.append("self_attn.o_proj.bias")
    if config.use_qk_norm:
        names += _QK_NORMS
    if not config.layer_is_moe(i):
        return [(n, n, None) for n in names + _DENSE_MLP + _NORMS]
    return ([(n, n, None) for n in names + _SHARED_MLP]
            + [("mlp.gate_kernel", "mlp.gate.weight", "T"),
               ("mlp.e_score_correction_bias", "mlp.gate.e_score_correction_bias", None)]
            + [(n, n, None) for n in _NORMS])


def params_from_hf(state_dict: Mapping[str, Any], config: Glm4MoeConfig,
                   leaf_fn: LeafFn | None = None) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's state dict."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: torch.Tensor) -> None:
        out[name] = leaf_fn(name, value) if leaf_fn else value

    deepseek_hf.top_from_hf(state_dict, config, put, keys)
    layers_from_hf(config, put, lambda name: read(state_dict, keys, name),
                   lambda i: layer_table(config, i),
                   lambda i: deepseek_hf.expert_table(config, i), config.n_routed_experts)
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: Glm4MoeConfig) -> dict:
    """The port's state dict -> HF keys, in JAX's order."""
    out = deepseek_hf.top_to_hf(params, config)
    layers_to_hf(params, out, config.jax_layout, config.num_hidden_layers,
                 lambda i: layer_table(config, i),
                 lambda i: deepseek_hf.expert_table(config, i), config.n_routed_experts)
    return out


def _moe_fields(config: Glm4MoeConfig) -> dict[str, Any]:
    return {
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "moe_intermediate_size": config.moe_intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
    }


def _common(config: Glm4MoeConfig) -> dict[str, Any]:
    return {
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
    }


def config_to_hf(config: Glm4MoeConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's Glm4MoeConfig -> HF `config.json` dict (as JAX's)."""
    if config.hf_flavor == "dots1":
        if config.partial_rotary_factor != 1.0 or not config.use_qk_norm:
            raise ValueError(
                "dots1 exports require partial_rotary_factor=1.0 and "
                "use_qk_norm (the HF Dots1 graph hardcodes both)")
        if config.attention_bias != config.attention_out_bias:
            raise ValueError(
                "HF Dots1 biases all four attention projections from ONE "
                "attention_bias flag; asymmetric biases cannot be exported")
        return {
            "architectures": ["Dots1ForCausalLM"], "model_type": "dots1",
            **_moe_fields(config), **_common(config),
            "sliding_window": config.sliding_window,
            "layer_types": (list(config.layer_types) if config.layer_types is not None
                            else ["full_attention"] * config.num_hidden_layers),
            "use_cache": True, "torch_dtype": torch_dtype,
        }
    if config.sliding_window is not None or config.layer_types is not None:
        raise ValueError(
            "HF glm4_moe has no sliding-window fields; set hf_flavor='dots1' "
            "to export a windowed config")
    if config.attention_out_bias:
        raise ValueError(
            "HF glm4_moe never biases o_proj; set hf_flavor='dots1' "
            "(whose attention_bias covers all four projections)")
    common = _common(config)
    return {
        "architectures": ["Glm4MoeForCausalLM"], "model_type": "glm4_moe",
        **_moe_fields(config),
        "partial_rotary_factor": config.partial_rotary_factor,
        "use_qk_norm": config.use_qk_norm,
        **common, "use_cache": True, "torch_dtype": torch_dtype,
    }


def config_from_hf(hf_config: Any, **overrides: Any) -> Glm4MoeConfig:
    """HF glm4_moe or dots1 config (object or dict) -> Glm4MoeConfig;
    `overrides` win. dots1 is the same graph at full rotary with per-head
    qk-norm always on, one bias flag over o_proj too, and qwen2-style
    per-layer windows."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d))
    if get("model_type") == "dots1":
        layer_types = list(get("layer_types") or []) or None
        if layer_types is None:
            # HF Dots1Config's rule: layers from max_window_layers on slide
            n_layers = get("num_hidden_layers")
            mwl = get("max_window_layers", n_layers)
            layer_types = ["sliding_attention" if get("sliding_window") is not None and i >= mwl
                           else "full_attention" for i in range(n_layers)]
        dots = dict(
            partial_rotary_factor=1.0,
            use_qk_norm=True,
            attention_out_bias=get("attention_bias", False),
            sliding_window=get("sliding_window"),
            layer_types=layer_types,
            norm_topk_prob=get("norm_topk_prob", False),
            first_k_dense_replace=get("first_k_dense_replace", 0),
            n_routed_experts=get("n_routed_experts"),
            num_experts_per_tok=get("num_experts_per_tok"),
            n_shared_experts=get("n_shared_experts"),
            head_dim=get("head_dim") or get("hidden_size") // get("num_attention_heads"),
            hf_flavor="dots1",
        )
        if set(dots["layer_types"]) == {"full_attention"}:
            dots["layer_types"] = None
            dots["sliding_window"] = None
        overrides = {**dots, **overrides}
    return Glm4MoeConfig(**{**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        moe_intermediate_size=get("moe_intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim", 128),
        max_position_embeddings=get("max_position_embeddings", 131072),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id"),
        eos_token_id=get("eos_token_id"),
        tie_word_embeddings=get("tie_word_embeddings", False),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=get("rope_scaling"),
        partial_rotary_factor=get("partial_rotary_factor", 0.5),
        attention_bias=get("attention_bias", False),
        attention_dropout=get("attention_dropout", 0.0),
        use_qk_norm=get("use_qk_norm", False),
        n_routed_experts=get("n_routed_experts", 128),
        n_shared_experts=get("n_shared_experts", 1),
        num_experts_per_tok=get("num_experts_per_tok", 8),
        first_k_dense_replace=get("first_k_dense_replace", 1),
        norm_topk_prob=get("norm_topk_prob", True),
        routed_scaling_factor=get("routed_scaling_factor", 1.0),
        n_group=get("n_group"),
        topk_group=get("topk_group"),
    ), **overrides})
