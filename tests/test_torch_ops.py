"""Port parity of the plain ops on the serving path: the PyTorch functions
in `llm_training_tpu_torch.ops` against their JAX counterparts in
`llm_training_tpu.ops`, on the same numpy inputs, in fp32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.ops import attention as jax_attention
from llm_training_tpu.ops import rope as jax_rope
from llm_training_tpu.ops import rope_utils as jax_rope_utils
from llm_training_tpu.ops.rms_norm import rms_norm as jax_rms_norm
from llm_training_tpu.ops.swiglu import silu_mul as jax_silu_mul
from llm_training_tpu_torch.ops import attention, rope, rope_utils
from llm_training_tpu_torch.ops.rms_norm import rms_norm
from llm_training_tpu_torch.ops.swiglu import silu_mul

TOL = dict(rtol=1e-5, atol=1e-5)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
LLAMA3 = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rms_norm_matches_jax():
    rng = _rng()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL,
    )


def test_rms_norm_rounds_before_weight_in_bf16():
    """Normalise in fp32, round to bf16, THEN multiply by the weight."""
    rng = _rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ours = rms_norm(_t(x).bfloat16(), _t(w).bfloat16(), 1e-5).float().numpy()
    theirs = jax_rms_norm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5
    ).astype(jnp.float32)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


@pytest.mark.parametrize("scaling", [None, LLAMA3], ids=["default", "llama3"])
def test_rope_frequencies_match_jax(scaling):
    ours = rope_utils.rope_config_from_hf(scaling, 500000.0, 16, 64)
    theirs = jax_rope_utils.rope_config_from_hf(scaling, 500000.0, 16, 64)
    inv, factor = rope_utils.compute_rope_frequencies(ours)
    inv_j, factor_j = jax_rope_utils.compute_rope_frequencies(theirs)
    assert inv.dtype == np.float32 and factor == factor_j
    np.testing.assert_allclose(inv, inv_j, **ROPE_TOL)
    if scaling is not None:  # the scaling branch really changed something
        plain, _ = rope_utils.compute_rope_frequencies(
            rope_utils.rope_config_from_hf(None, 500000.0, 16, 64)
        )
        assert not np.allclose(inv, plain)


def test_rope_cos_sin_and_apply_match_jax():
    rng = _rng(2)
    config = jax_rope_utils.rope_config_from_hf(LLAMA3, 500000.0, 16, 64)
    inv, factor = jax_rope_utils.compute_rope_frequencies(config)
    positions = np.asarray([[0, 3, 7, 20, 41], [5, 6, 7, 8, 9]], np.int32)
    cos, sin = rope_utils.compute_rope_cos_sin(inv, _t(positions), factor)
    cos_j, sin_j = jax_rope_utils.compute_rope_cos_sin(inv, jnp.asarray(positions), factor)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), **ROPE_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), **ROPE_TOL)

    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    q_rot, k_rot = rope.apply_rope(_t(q), _t(k), cos, sin)
    q_j, k_j = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    np.testing.assert_allclose(q_rot.numpy(), np.asarray(q_j), **TOL)
    np.testing.assert_allclose(k_rot.numpy(), np.asarray(k_j), **TOL)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        rope.rotate_half(_t(x)).numpy(), np.asarray(jax_rope.rotate_half(jnp.asarray(x)))
    )


def test_unported_rope_type_raises():
    """Every JAX rope type is ported; a type JAX lacks raises JAX's error."""
    with pytest.raises(ValueError, match="Unknown rope type 'ntk_by_parts'"):
        rope_utils.rope_config_from_hf({"rope_type": "ntk_by_parts", "factor": 2.0}, 1e4, 16, 64)
    with pytest.raises(ValueError, match="Unknown rope type 'ntk_by_parts'"):
        jax_rope_utils.rope_config_from_hf({"rope_type": "ntk_by_parts", "factor": 2.0}, 1e4, 16, 64)


def test_silu_mul_matches_jax():
    rng = _rng(3)
    gate = rng.standard_normal((4, 32)).astype(np.float32)
    up = rng.standard_normal((4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        silu_mul(_t(gate), _t(up)).numpy(),
        np.asarray(jax_silu_mul(jnp.asarray(gate), jnp.asarray(up))), **TOL,
    )


@pytest.mark.parametrize("window,offset", [(None, 0), (3, 0), (None, 4), (2, 5)])
def test_make_attention_mask_matches_jax(window, offset):
    seg = np.asarray([[1, 1, 2, 2, 2, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    ours = attention.make_attention_mask(
        _t(seg), _t(seg), 6, 6, sliding_window=window, q_offset=offset
    )
    theirs = jax_attention.make_attention_mask(
        jnp.asarray(seg), jnp.asarray(seg), 6, 6, sliding_window=window, q_offset=offset
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    plain = attention.make_attention_mask(None, None, 4, 6, sliding_window=window)
    np.testing.assert_array_equal(
        plain.numpy(),
        np.asarray(jax_attention.make_attention_mask(None, None, 4, 6, sliding_window=window)),
    )


@pytest.mark.parametrize("cap,group", [(None, 2), (4.0, 1), (None, 4)])
def test_xla_attention_matches_jax(cap, group):
    """GQA in the kv-major layout, soft cap, and a fully masked row (the
    padding row of segment 0) that must come out exactly 0."""
    rng = _rng(4)
    kv_heads, head_dim = 2, 16
    q = rng.standard_normal((2, 6, kv_heads * group, head_dim)).astype(np.float32)
    k = rng.standard_normal((2, 6, kv_heads, head_dim)).astype(np.float32)
    v = rng.standard_normal((2, 6, kv_heads, head_dim)).astype(np.float32)
    seg = np.asarray([[1, 1, 2, 2, 2, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    mask = jax_attention.make_attention_mask(jnp.asarray(seg), jnp.asarray(seg), 6, 6)
    ours = attention._xla_attention(
        _t(q), _t(k), _t(v), _t(np.asarray(mask)), head_dim**-0.5, cap
    )
    theirs = jax_attention._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, head_dim**-0.5, cap
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    assert float(ours[0, 5].abs().max()) == 0.0
