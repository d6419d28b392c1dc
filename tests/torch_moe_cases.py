"""Tiny HF `config.json` dicts, one for each of the 8 MoE `model_type`s that
JAX routes to its `Llama` (mixtral, phimoe, granitemoe, granitemoeshared,
qwen2_moe, qwen3_moe, olmoe, flex_olmo), for the MoE parity tests: 4 to 8
experts of width 32, 2 a token, a shared expert where the type has one,
2 layers at hidden 64, and each type's own norms, biases and multipliers."""

from __future__ import annotations

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            initializer_range=0.1, bos_token_id=1, eos_token_id=2, num_experts_per_tok=2)

CASES: dict[str, dict] = {
    "mixtral": dict(num_local_experts=4, intermediate_size=32),
    "phimoe": dict(num_local_experts=4, intermediate_size=32, router_jitter_noise=0.2,
                   attention_bias=True, lm_head_bias=True, layer_norm_eps=1e-5),
    "granitemoe": dict(num_local_experts=4, intermediate_size=32, embedding_multiplier=4.0,
                       attention_multiplier=0.2, residual_multiplier=0.5, logits_scaling=2.0),
    "granitemoeshared": dict(num_local_experts=4, intermediate_size=32,
                             shared_intermediate_size=48, embedding_multiplier=4.0,
                             attention_multiplier=0.2, residual_multiplier=0.5,
                             logits_scaling=2.0),
    "qwen2_moe": dict(num_experts=4, moe_intermediate_size=32,
                      shared_expert_intermediate_size=48, norm_topk_prob=False,
                      tie_word_embeddings=False),
    "qwen3_moe": dict(num_experts=8, moe_intermediate_size=32, norm_topk_prob=True,
                      tie_word_embeddings=False),
    "olmoe": dict(num_experts=4, intermediate_size=32, norm_topk_prob=False, clip_qkv=0.5),
    "flex_olmo": dict(num_experts=4, intermediate_size=32, norm_topk_prob=True),
}
TYPES = sorted(CASES)
FP32 = dict(compute_dtype="float32", param_dtype="float32")


def hf_config(model_type: str) -> dict:
    """The HF config dict of `model_type`'s case."""
    return {**BASE, **CASES[model_type], "model_type": model_type}


def configs(model_type: str, **overrides):
    """(JAX's config, the port's) of the type's case, each from its own
    package's `config_from_hf`: fp32, JAX's XLA attention, the exact dense
    MoE impl unless `overrides` name another."""
    from llm_training_tpu.models.llama import hf_conversion as jax_conv
    from llm_training_tpu_torch.models.llama import hf_conversion as conv

    hf = hf_config(model_type)
    overrides = {"attention_impl": "xla", **FP32, **overrides}
    return jax_conv.config_from_hf(hf, **overrides), conv.config_from_hf(hf, **overrides)


def random_params(jax_model, seed: int = 1, scale: float = 0.1):
    """The model's parameter tree (shapes from `eval_shape`) filled with
    normal draws (biases and norm weights nonzero too)."""
    import flax.linen as nn
    import jax
    import numpy as np

    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), np.zeros((1, 4), np.int32))))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
