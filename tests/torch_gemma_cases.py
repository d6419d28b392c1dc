"""Tiny Gemma configs shared by the Gemma parity tests (`test_torch_gemma*.py`):
one per version and JAX tree layout, with the features each version adds
made to bite at 12 tokens (a window of 5, small soft caps, linear rope
scaling on Gemma-3's full layers), and random parameters drawn in JAX's
layout (norm weights nonzero, so the (1 + w) scale shows)."""


BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=64, compute_dtype="float32", param_dtype="float32")
V2 = dict(version=2, query_pre_attn_scalar=24, attn_logit_softcapping=5.0,
          final_logit_softcapping=3.0, sliding_window=5)
VARIANTS = {
    # gemma 1: one kv head (MQA), JAX's scanned `layers/layer` tree
    "v1": dict(BASE, num_key_value_heads=1),
    # gemma 2: windows on even layers, both caps; scanned (sliding, full) pairs
    "v2_pairs": dict(BASE, **V2),
    # the same graph in JAX's looped `layers_{i}` tree (what serving needs)
    "v2_looped": dict(BASE, **V2, scan_layers=False),
    # gemma 3: qk-norm, a 3:1 sliding/full pattern, dual rotary tables
    "v3": dict(BASE, version=3, query_pre_attn_scalar=24, sliding_window=5,
               layer_types=["sliding_attention", "sliding_attention", "sliding_attention",
                            "full_attention"],
               rope_theta=1e6, rope_local_base_freq=1e4,
               rope_scaling={"rope_type": "linear", "factor": 2.0}),
}


def configs(name: str, **fields):
    """(JAX's GemmaConfig with the XLA attention, the port's) for a variant."""
    from llm_training_tpu.models import GemmaConfig as JaxGemmaConfig
    from llm_training_tpu_torch.models.gemma import GemmaConfig

    kw = {**VARIANTS[name], **fields}
    jax_config = JaxGemmaConfig(**kw, attention_impl="xla")
    return jax_config, GemmaConfig(**kw, attention_impl="xla")


def random_params(jax_model, seed: int = 1, scale: float = 0.1):
    """The model's parameter tree (shapes from `eval_shape`) of normal draws."""
    import flax.linen as nn
    import jax
    import numpy as np

    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), np.zeros((1, 4), np.int32))))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def batch():
    """One packed and padded batch of 2 x 12 tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 5 + [2] * 7, [1] * 10 + [0] * 2], np.int32)
    return ids, seg
