"""Tiny HF `config.json` dicts of the hybrid families JAX routes (qwen3_next
-> Qwen3Next, minimax -> MiniMax, bamba -> Bamba), for their parity tests:
hidden 64, 4 layers alternating the recurrent mixer and softmax attention
(a period of 2, the depth at which JAX scans a `layers/slot{j}` body), the
recurrences' chunks 8 long so that the tests' rows of 20 tokens span three
of them (the last one partial); the MoE families with 8 experts of width
32, 2 a token, Qwen3-Next's with a gated shared expert, MiniMax's with
residual factors away from 1."""

from __future__ import annotations

import functools

BASE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64, rms_norm_eps=1e-5,
            initializer_range=0.1, bos_token_id=1, eos_token_id=2)
_ALTERNATE = ["linear_attention", "full_attention"] * 2

CASES: dict[str, dict] = {
    "qwen3_next": dict(intermediate_size=96, head_dim=16, partial_rotary_factor=0.25,
                       layer_types=_ALTERNATE, linear_num_key_heads=2, linear_num_value_heads=4,
                       linear_key_head_dim=16, linear_value_head_dim=16, linear_conv_kernel_dim=4,
                       num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                       shared_expert_intermediate_size=48, norm_topk_prob=True,
                       rope_theta=10000.0),
    "minimax": dict(intermediate_size=32, head_dim=16, layer_types=_ALTERNATE, block_size=8,
                    num_local_experts=8, num_experts_per_tok=2, rope_theta=10000.0,
                    max_position_embeddings=64, full_attn_alpha_factor=1.3,
                    full_attn_beta_factor=0.9, linear_attn_alpha_factor=1.2,
                    linear_attn_beta_factor=0.8, mlp_alpha_factor=1.1, mlp_beta_factor=0.7),
    "bamba": dict(intermediate_size=96, attn_layer_indices=[1, 3], mamba_n_heads=8,
                  mamba_d_head=16, mamba_n_groups=2, mamba_d_state=8, mamba_expand=2,
                  mamba_d_conv=4, mamba_chunk_size=8, pad_token_id=0),
}
TYPES = sorted(CASES)
FP32 = dict(compute_dtype="float32", param_dtype="float32")
# the MoE types (Bamba is dense)
MOE_TYPES = ["minimax", "qwen3_next"]
# the JAX config field of each family's chunk length
CHUNK_FIELD = {"qwen3_next": "delta_chunk_size", "minimax": "block_size",
               "bamba": "mamba_chunk_size"}


def hf_config(model_type: str) -> dict:
    """The HF config dict of `model_type`'s case."""
    return {**BASE, **CASES[model_type], "model_type": model_type}


def conversions(model_type: str):
    """(JAX's conversion module, the port's) of the type's family."""
    import importlib

    return (importlib.import_module(f"llm_training_tpu.models.{model_type}.hf_conversion"),
            importlib.import_module(f"llm_training_tpu_torch.models.{model_type}.hf_conversion"))


def configs(model_type: str, **overrides):
    """(JAX's config, the port's) of the type's case, each from its own
    package's `config_from_hf`: fp32, JAX's XLA attention, the exact dense
    MoE impl (MoE types), Qwen3-Next's delta-rule chunk of 8, unless
    `overrides` name others."""
    jax_conv, conv = conversions(model_type)
    hf = hf_config(model_type)
    base = {"attention_impl": "xla", **FP32}
    if model_type in MOE_TYPES:
        base["moe_impl"] = "dense"
    if model_type == "qwen3_next":
        base["delta_chunk_size"] = 8
    overrides = {**base, **overrides}
    return jax_conv.config_from_hf(hf, **overrides), conv.config_from_hf(hf, **overrides)


@functools.lru_cache(maxsize=None)
def models(model_type: str, **overrides):
    """(JAX's model, the port's model class, JAX's config, the port's),
    built once a process for each type and overrides (the callers copy a
    config with `dataclasses.replace` before changing it)."""
    import llm_training_tpu.models as jax_models
    from llm_training_tpu_torch.models.hf_causal_lm import model_class_for_config

    jax_config, config = configs(model_type, **overrides)
    port_cls = model_class_for_config(config)
    return getattr(jax_models, port_cls.__name__)(jax_config), port_cls, jax_config, config
