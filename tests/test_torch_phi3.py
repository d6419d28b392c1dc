"""Port parity of the Phi-3 family and the RoPE variants: the port's
`rope_utils` against JAX's for all six rope types, `Phi3Config`'s errors
against JAX's, tiny-Phi-3 logits of the port against the JAX `Phi3` on the
same carried parameters (a window shorter than the sequence, fp32
attention under bf16 compute, longrope on both sides of its switch), and
greedy paged-decode tokens against the JAX `ServingEngine` (fp32, CPU)."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.models import Phi3 as JaxPhi3
from llm_training_tpu.models import Phi3Config as JaxPhi3Config
from llm_training_tpu.ops import rope_utils as jax_rope_utils
from llm_training_tpu.serve import ServeConfig as JaxServeConfig
from llm_training_tpu.serve import ServingEngine as JaxServingEngine
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.phi3 import Phi3, Phi3Config
from llm_training_tpu_torch.ops import rope_utils
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order than XLA's
TINY = dict(
    vocab_size=160, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
    bos_token_id=1, eos_token_id=2, pad_token_id=0,
)
HALF = 8  # head_dim 16 / 2
LONGROPE = dict(
    rope_scaling={"type": "longrope",
                  "short_factor": [1.0 + 0.1 * i for i in range(HALF)],
                  "long_factor": [2.0 + 0.5 * i for i in range(HALF)]},
    original_max_position_embeddings=16,
)
ROPE_CASES = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 2.0},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "beta_fast": 16, "beta_slow": 2},
    "yarn_deepseek": {"rope_type": "yarn", "factor": 4.0, "mscale": 0.707,
                      "mscale_all_dim": 0.707, "original_max_position_embeddings": 32},
    "longrope": {"rope_type": "longrope", "factor": 4.0,
                 "short_factor": [1.0 + 0.1 * i for i in range(HALF)],
                 "long_factor": [2.0 + 0.5 * i for i in range(HALF)]},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
}


@pytest.mark.parametrize("seq_len", [None, 40, 200], ids=["none", "short", "long"])
@pytest.mark.parametrize("name", sorted(ROPE_CASES))
def test_rope_tables_match_jax(name, seq_len):
    """inv_freq, the attention factor and cos/sin of every rope type, with
    the sequence lengths that flip dynamic NTK's base and longrope's short
    and long factors (max positions 64), within 1e-6."""
    ours = rope_utils.rope_config_from_hf(ROPE_CASES[name], 10000.0, 2 * HALF, 64)
    theirs = jax_rope_utils.rope_config_from_hf(ROPE_CASES[name], 10000.0, 2 * HALF, 64)
    inv, factor = rope_utils.compute_rope_frequencies(ours, seq_len)
    inv_j, factor_j = jax_rope_utils.compute_rope_frequencies(theirs, seq_len)
    np.testing.assert_allclose(inv, inv_j, **ROPE_TOL)
    assert factor == pytest.approx(factor_j, rel=1e-6)
    positions = np.arange(96, dtype=np.int32)[None].repeat(2, 0)
    cos, sin = rope_utils.compute_rope_cos_sin(inv, torch.from_numpy(positions), factor)
    cos_j, sin_j = jax_rope_utils.compute_rope_cos_sin(inv_j, jnp.asarray(positions), factor_j)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), **ROPE_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), **ROPE_TOL)
    if name == "longrope":
        short = jax_rope_utils.compute_rope_frequencies(theirs, 40)[0]
        long = jax_rope_utils.compute_rope_frequencies(theirs, 200)[0]
        assert not np.allclose(short, long)  # the switch is exercised


@pytest.mark.parametrize("fields", [
    {"resid_pdrop": 0.1},
    {"embd_pdrop": 0.2},
    {"rope_scaling": {**LONGROPE["rope_scaling"], "short_factor": [1.0] * 3},
     "original_max_position_embeddings": 16},
    {"rope_scaling": LONGROPE["rope_scaling"]},
    {"rope_scaling": {"rope_type": "linear"}},
    {"rope_scaling": {"rope_type": "warp"}},
], ids=["resid_pdrop", "embd_pdrop", "longrope_length", "longrope_no_original", "linear_no_factor",
        "unknown_type"])
def test_phi3_config_errors_match_jax(fields):
    with pytest.raises(ValueError) as theirs:
        JaxPhi3Config(**TINY, **fields)
    with pytest.raises(ValueError) as ours:
        Phi3Config(**TINY, **fields)
    assert str(ours.value) in str(theirs.value)


def _jax_phi3(seed=0, **fields):
    model = JaxPhi3(JaxPhi3Config(**TINY, attention_impl="xla", **fields))
    variables = model.init(jax.random.key(seed), np.zeros((1, 4), np.int32))
    return model, variables, jax.device_get(nn.meta.unbox(variables))


def _port_phi3(params, **fields) -> Phi3:
    config = Phi3Config(**TINY, **fields)
    model = Phi3(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    return model.eval()


@pytest.mark.parametrize("seq,fields", [
    (12, dict(sliding_window=5, compute_dtype="float32", param_dtype="float32")),
    (12, dict(sliding_window=5, compute_dtype="bfloat16", param_dtype="float32",
              attention_compute_dtype="float32")),
    (12, dict(compute_dtype="float32", param_dtype="float32", **LONGROPE)),
    (24, dict(compute_dtype="float32", param_dtype="float32", **LONGROPE)),
], ids=["window", "fp32_attention_bf16_compute", "longrope_short", "longrope_long"])
def test_logits_match_jax(seq, fields, monkeypatch):
    """The training forward over a packed and padded batch, fp32 within
    1e-4. Under bf16 compute the two frameworks round their bf16 products
    and activations at other places: the logits are held within two bf16
    steps of the largest logit (2 x 2^-8 x max|logit|), and the attention
    is seen to take fp32 q, k and v."""
    from llm_training_tpu_torch.models.llama import model as llama_model

    jax_model, variables, params = _jax_phi3(**fields)
    model = _port_phi3(params, **fields)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab_size"], (2, seq)).astype(np.int32)
    seg = np.ones((2, seq), np.int32)
    seg[0, seq // 3:] = 2
    seg[1, seq - 2:] = 0
    expected = np.asarray(jax_model.apply(
        variables, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg)).logits, np.float32)
    seen = set()
    attention = llama_model.dot_product_attention

    def watched(q, k, v, **kwargs):
        seen.add((q.dtype, k.dtype, v.dtype))
        return attention(q, k, v, **kwargs)

    monkeypatch.setattr(llama_model, "dot_product_attention", watched)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(seg)).logits
    got = logits.float().numpy()
    assert seen == {(torch.float32,) * 3}
    if fields["compute_dtype"] == "float32":
        np.testing.assert_allclose(got, expected, **TOL)
    else:
        assert logits.dtype == torch.bfloat16
        assert np.abs(got - expected).max() <= 2 * 2.0**-8 * np.abs(expected).max()


@pytest.mark.parametrize("fields", [
    dict(sliding_window=6),
    dict(attention_compute_dtype="float32"),
    LONGROPE,
], ids=["window", "fp32_attention", "longrope"])
def test_greedy_paged_decode_tokens_match_jax(fields):
    """Greedy tokens of the port's `ServingEngine` equal the JAX engine's on
    the same carried weights: rows that outgrow the window, the paged path
    under the attention dtype, longrope's tables chosen from
    `max_model_len` (above the original 16 positions: the long factors)."""
    fields = dict(fields, compute_dtype="float32", param_dtype="float32")
    jax_model, variables, params = _jax_phi3(seed=1, **fields)
    serve = dict(max_batch=2, max_model_len=48, block_size=8, prefill_chunk=4,
                 eos_token_id=None)
    requests = [{"id": str(i), "prompt": p, "max_new_tokens": 10}
                for i, p in enumerate([[3, 17, 42, 7, 11, 9, 8], [5, 9], [1, 2, 3, 4]])]
    expected = JaxServingEngine(jax_model, variables, JaxServeConfig(**serve)).run(requests)
    got = ServingEngine(_port_phi3(params, **fields), ServeConfig(**serve), device="cpu").run(
        requests)

    def tokens(events):
        return {e["id"]: e["tokens"] for e in events if e["type"] == "done"}

    assert tokens(got) == tokens(expected)
    assert len(tokens(got)) == 3


def test_phi3_is_the_llama_stack_over_a_phi3_config():
    """JAX's defaults (Phi-3-mini's widths) and the rope's factor defaulting."""
    assert dataclasses.asdict(Phi3Config()) == {
        k: v for k, v in JaxPhi3Config().model_dump().items()
        if k in {f.name for f in dataclasses.fields(Phi3Config)}
    }
    config = Phi3Config(**{**TINY, **LONGROPE})
    theirs = JaxPhi3Config(**{**TINY, **LONGROPE}).rope_config
    ours = config.rope_config
    assert (ours.type, ours.max_position_embeddings, ours.scaling["factor"]) == (
        theirs.type, theirs.max_position_embeddings, theirs.scaling["factor"]) == (
        "longrope", 16, 4.0)
