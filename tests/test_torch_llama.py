"""Port parity of the Llama decoder: logits of the JAX `Llama` forward and
of the port's, on weights carried across by `state_dict_from_jax`, for the
scanned and the looped JAX parameter layouts (fp32, CPU)."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax, tree_from_flat
from llm_training_tpu_torch.models.llama.model import Llama

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order than XLA's
TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
    },
    compute_dtype="float32", param_dtype="float32",
)


def jax_model_and_params(scan_layers: bool, seed: int = 0, **overrides):
    """A tiny JAX Llama and its parameter tree as nested numpy dicts."""
    model = JaxLlama(JaxLlamaConfig(
        **TINY, scan_layers=scan_layers, attention_impl="xla", **overrides
    ))
    variables = model.init(jax.random.key(seed), np.zeros((1, 4), np.int32))
    return model, variables, jax.device_get(nn.meta.unbox(variables))


def port_model(params, **overrides) -> Llama:
    config = LlamaConfig(**TINY, **overrides)
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    return model.eval()


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "looped"])
def test_logits_match_jax(scan_layers):
    jax_model, variables, params = jax_model_and_params(scan_layers)
    model = port_model(params)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 5 + [2] * 7, [1] * 10 + [0] * 2], np.int32)  # packed + padded
    expected = np.asarray(jax_model.apply(
        variables, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg)
    ).logits)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg)).logits
    np.testing.assert_allclose(logits.numpy(), expected, **TOL)


def test_tied_embeddings_and_npz_round_trip(tmp_path):
    jax_model, variables, params = jax_model_and_params(True, tie_word_embeddings=True)
    flat = {}

    def flatten(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                flatten(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = value

    flatten(params, "")
    np.savez(tmp_path / "w.npz", **flat)
    with np.load(tmp_path / "w.npz") as data:
        model = port_model(tree_from_flat(data), tie_word_embeddings=True)
    assert model.lm_head is None
    ids = np.arange(1, 9, dtype=np.int32)[None]
    expected = np.asarray(jax_model.apply(variables, input_ids=jnp.asarray(ids)).logits)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(logits.numpy(), expected, **TOL)


@pytest.mark.parametrize("field,value", [
    ("num_experts", 4), ("norm_scheme", "post"), ("norm_type", "layernorm"),
    ("mlp_type", "gelu"), ("qk_norm", True), ("clip_qkv", 8.0),
    ("partial_rotary_factor", 0.5), ("position_embedding_type", "learned"),
    ("layer_types", ["full_attention", "full_attention"]),
])
def test_unported_architectures_raise(field, value):
    with pytest.raises(NotImplementedError):
        LlamaConfig(**{**TINY, field: value})


def test_llama_3_1_8b_preset_widths():
    config = preset("llama-3.1-8b")
    assert (config.hidden_size, config.intermediate_size, config.num_hidden_layers) == (
        4096, 14336, 32,
    )
    assert (config.num_attention_heads, config.num_key_value_heads) == (32, 8)
    assert config.resolved_head_dim == 128 and config.vocab_size == 128256
    assert config.rope_config.type == "llama3" and config.rope_theta == 500000.0
    assert not config.tie_word_embeddings
    assert config.compute_torch_dtype == config.param_torch_dtype == torch.bfloat16
    # the same widths validate in the JAX config too
    JaxLlamaConfig(**{
        k: v for k, v in dataclasses.asdict(config).items()
        if k in JaxLlamaConfig.model_fields
    })
    # built on the meta device: shapes only, no 16 GB of weights here
    model = Llama(preset("llama-3.1-8b", num_hidden_layers=1), device="meta")
    n_layer = sum(p.numel() for p in model.model.layers.parameters())
    assert n_layer == 218_112_000  # one Llama-3.1-8B decoder layer
