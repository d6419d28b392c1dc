"""Tiny HF `config.json` dicts, one for each HF `model_type` that JAX routes
to its non-Llama MoE families (deepseek_v2, deepseek_v3, kimi_k2 ->
Deepseek; glm4_moe, dots1 -> Glm4Moe; gpt_oss -> GptOss; ernie4_5_moe ->
Ernie45Moe; hunyuan_v1_moe -> HunYuanMoe), for the families' parity tests:
hidden 64, 8 experts of width 32 (4 for gpt-oss and HunYuan), 2 a token,
2-4 layers (a dense prefix where the family has one; two sliding/full
periods for gpt-oss, the depth JAX scans), and each type's
own router, biases, rotary and windows."""

from __future__ import annotations

import functools

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            initializer_range=0.1, bos_token_id=1, eos_token_id=2, num_experts_per_tok=2)
_MLA = dict(kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
            n_routed_experts=8, n_shared_experts=1, moe_intermediate_size=32,
            first_k_dense_replace=1)
_YARN = dict(type="yarn", factor=4.0, beta_fast=32, beta_slow=1, mscale=0.707,
             mscale_all_dim=0.707, original_max_position_embeddings=16)

CASES: dict[str, dict] = {
    # v2: softmax router, group-limited greedy over 4 groups of 2
    "deepseek_v2": dict(**_MLA, q_lora_rank=None, topk_method="group_limited_greedy",
                        n_group=4, topk_group=2, norm_topk_prob=False,
                        routed_scaling_factor=1.5, rope_scaling=_YARN),
    # v3: q through a LoRA, sigmoid router with the correction bias, top-2-sum
    # group selection, renormalised and scaled
    "deepseek_v3": dict(**_MLA, q_lora_rank=24, n_group=4, topk_group=2, norm_topk_prob=True,
                        routed_scaling_factor=2.5, rope_interleave=True),
    # the V3 graph under Moonshot's type, here with the attention biases
    "kimi_k2": dict(**_MLA, q_lora_rank=24, n_group=2, topk_group=1, norm_topk_prob=True,
                    routed_scaling_factor=1.0, attention_bias=True),
    "glm4_moe": dict(moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
                     first_k_dense_replace=1, n_group=2, topk_group=1, norm_topk_prob=True,
                     routed_scaling_factor=1.5, partial_rotary_factor=0.5, attention_bias=True,
                     use_qk_norm=True),
    # full, full, sliding: a suffix of mixed windows, which JAX loops
    "dots1": dict(moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
                  first_k_dense_replace=1, norm_topk_prob=True, routed_scaling_factor=1.0,
                  attention_bias=True, sliding_window=4, max_window_layers=2),
    "gpt_oss": dict(num_hidden_layers=4, intermediate_size=32, num_local_experts=4,
                    sliding_window=4, router_aux_loss_coef=0.9,
                    rope_scaling=dict(rope_type="yarn", factor=4.0, beta_fast=32.0,
                                      beta_slow=1.0, original_max_position_embeddings=16,
                                      truncate=False)),
    "ernie4_5_moe": dict(moe_num_experts=8, moe_k=2, moe_intermediate_size=32,
                         moe_num_shared_experts=1, moe_layer_start_index=1, use_bias=True,
                         tie_word_embeddings=True),
    "hunyuan_v1_moe": dict(num_hidden_layers=2, intermediate_size=32, num_experts=4, moe_topk=2,
                           attention_bias=True),
}
TYPES = sorted(CASES)
FP32 = dict(compute_dtype="float32", param_dtype="float32")
# model_type -> the family's module name, in both packages
FAMILY = {"deepseek_v2": "deepseek", "deepseek_v3": "deepseek", "kimi_k2": "deepseek",
          "glm4_moe": "glm4_moe", "dots1": "glm4_moe", "gpt_oss": "gpt_oss",
          "ernie4_5_moe": "ernie45_moe", "hunyuan_v1_moe": "hunyuan_moe"}


def hf_config(model_type: str) -> dict:
    """The HF config dict of `model_type`'s case."""
    return {**BASE, **CASES[model_type], "model_type": model_type}


def conversions(model_type: str):
    """(JAX's conversion module, the port's) of the type's family."""
    import importlib

    family = FAMILY[model_type]
    return (importlib.import_module(f"llm_training_tpu.models.{family}.hf_conversion"),
            importlib.import_module(f"llm_training_tpu_torch.models.{family}.hf_conversion"))


def configs(model_type: str, **overrides):
    """(JAX's config, the port's) of the type's case, each from its own
    package's `config_from_hf`: fp32, JAX's XLA attention, the exact dense
    MoE impl unless `overrides` name another."""
    jax_conv, conv = conversions(model_type)
    hf = hf_config(model_type)
    overrides = {"attention_impl": "xla", "moe_impl": "dense", **FP32, **overrides}
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
