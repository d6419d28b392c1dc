"""Tiny HF `config.json` dicts, one for each dense `model_type` that JAX
routes to its `Llama` (the 28 of `llm_training_tpu/models/hf_io.py`'s
table without the 8 MoE types), for the Llama-variant parity tests. Each
sets the fields its family reads (biases, windows, layer patterns, NoPE
layers, multipliers, partial rotary) at widths of at most 128, and an
`initializer_range` that keeps the logits of a random model in a range
where fp32 differences show."""

from __future__ import annotations

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            initializer_range=0.1, bos_token_id=1, eos_token_id=2)
WINDOW = 5  # below the tests' sequence length, so the windows mask
SLIDING_FULL = ["sliding_attention", "full_attention"]

CASES: dict[str, dict] = {
    "llama": dict(rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
    "code_llama": dict(rope_theta=1000000.0),
    "mistral": dict(sliding_window=WINDOW),
    "ministral": dict(sliding_window=WINDOW, layer_types=SLIDING_FULL),
    "helium": dict(attention_bias=False),
    "arcee": dict(hidden_act="relu2", attention_bias=True),
    "seed_oss": dict(attention_bias=True, attention_out_bias=False),
    "qwen2": dict(sliding_window=WINDOW, use_sliding_window=True, tie_word_embeddings=True),
    "qwen3": dict(tie_word_embeddings=False),
    "olmo": dict(clip_qkv=0.5),
    "olmo2": dict(),
    "olmo3": dict(sliding_window=WINDOW, layer_types=SLIDING_FULL,
                  rope_scaling={"rope_type": "linear", "factor": 2.0}),
    "granite": dict(embedding_multiplier=12.0, attention_multiplier=0.125,
                    residual_multiplier=0.22, logits_scaling=8.0),
    "starcoder2": dict(use_bias=True, norm_epsilon=1e-5, sliding_window=WINDOW),
    "stablelm": dict(use_qkv_bias=True, partial_rotary_factor=0.25, layer_norm_eps=1e-5),
    "cohere": dict(use_qk_norm=True, logit_scale=0.25, layer_norm_eps=1e-5,
                   tie_word_embeddings=True),
    "cohere2": dict(sliding_window=WINDOW, sliding_window_pattern=2, logit_scale=0.25,
                    layer_norm_eps=1e-5, tie_word_embeddings=True),
    "phi": dict(num_key_value_heads=4, partial_rotary_factor=0.5, layer_norm_eps=1e-5,
                hidden_act="gelu_new"),
    "nemotron": dict(partial_rotary_factor=0.5, norm_eps=1e-5),
    "ernie4_5": dict(use_bias=True),
    "hunyuan_v1_dense": dict(attention_bias=True),
    "gpt2": dict(n_embd=64, n_inner=96, n_layer=2, n_head=4, n_positions=64,
                 layer_norm_epsilon=1e-5, bos_token_id=1, eos_token_id=2),
    "gpt_neox": dict(num_key_value_heads=4, head_dim=None, rotary_pct=0.25,
                     rotary_emb_base=10000.0, layer_norm_eps=1e-5, use_parallel_residual=True,
                     hidden_act="gelu"),
    "smollm3": dict(no_rope_layers=[1, 0]),
    "exaone4": dict(sliding_window=WINDOW, layer_types=SLIDING_FULL),
    "apertus": dict(),
    "glm": dict(partial_rotary_factor=0.5, attention_bias=True),
    "glm4": dict(partial_rotary_factor=0.5, attention_bias=True),
}


def hf_config(model_type: str) -> dict:
    """The HF config dict of `model_type`'s case."""
    return {**BASE, **CASES[model_type], "model_type": model_type}


# the HF classes `transformers` loads each exported type with (those of
# JAX's `tests/test_llama.py` export round trips, and the rest it routes)
EXPORTED_TYPES = ("qwen3", "qwen2", "granite", "starcoder2", "phi", "glm4", "nemotron",
                  "gpt2", "cohere2", "gpt_neox", "olmo")


# the two halves of the 28 types, one test file each (each under ~25 s)
TYPES = sorted(CASES)
FIRST_HALF, SECOND_HALF = TYPES[:14], TYPES[14:]
FP32 = dict(compute_dtype="float32", param_dtype="float32")


def configs(model_type: str, **overrides):
    """(JAX's config, the port's) of the type's case, each from its own
    package's `config_from_hf`, fp32 and JAX's XLA attention."""
    from llm_training_tpu.models.llama import hf_conversion as jax_conv
    from llm_training_tpu_torch.models.llama import hf_conversion as conv

    hf = hf_config(model_type)
    overrides = {"attention_impl": "xla", **FP32, **overrides}
    return jax_conv.config_from_hf(hf, **overrides), conv.config_from_hf(hf, **overrides)


def random_params(jax_model, seed: int = 1, scale: float = 0.1):
    """The model's parameter tree (shapes from `eval_shape`) filled with
    normal draws: biases, norm weights and the xIELU scalars nonzero too, so
    every branch that reads them shows."""
    import flax.linen as nn
    import jax
    import numpy as np

    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), np.zeros((1, 4), np.int32))))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def jax_config_to_hf(jax_config) -> dict:
    """JAX's `config_to_hf`, with the port's one addition (ROADMAP C.42): a
    windowed `qwen2` / `qwen3` export says so in HF's own keys."""
    from llm_training_tpu.models.llama import hf_conversion as jax_conv

    hf = jax_conv.config_to_hf(jax_config)
    if hf["model_type"] in ("qwen2", "qwen3") and jax_config.sliding_window:
        hf.update(use_sliding_window=True, max_window_layers=0)
    return hf
