"""The port's copy of JAX's random streams (`llm_training_tpu_torch/prng.py`)
against `jax.random` on the CPU, bit for bit: keys, fold_in and split, the
raw bits of several shapes, uniform values in fp32 and bf16, and the
tokens of categorical draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu_torch import prng


def _data(key) -> list[int]:
    return [int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1)]


@pytest.mark.parametrize("seed", [0, 7, 42, 2**31 - 1, -1, 2**32 + 5])
def test_key_fold_in_split_match_jax(seed):
    """key(seed) is JAX's (two words), fold_in of several data, and split
    into 2 and 5 keys, each word equal."""
    jax_key = jax.random.key(seed)
    key = prng.key(seed)
    assert list(key) == _data(jax_key)
    for data in (0, 1, 3, 1000, 2**31 + 9):
        assert list(prng.fold_in(key, data)) == _data(jax.random.fold_in(jax_key, data))
    for num in (2, 5):
        ours = [w for k in prng.split(key, num) for w in k]
        assert ours == _data(jax.random.split(jax_key, num))
    # keys derived from derived keys
    deep = jax.random.fold_in(jax.random.split(jax_key, 3)[2], 11)
    assert list(prng.fold_in(prng.split(key, 3)[2], 11)) == _data(deep)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 7), (4, 1, 9)])
def test_raw_bits_match_jax(shape):
    """32-bit words of ranks 1 to 3 with odd sizes (partitionable threefry:
    element i hashes the pair (i >> 32, i & 0xFFFFFFFF))."""
    key = jax.random.fold_in(jax.random.key(3), 17)
    expected = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)).astype(np.int64)
    got = prng.random_bits(prng.fold_in(prng.key(3), 17), shape).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, expected)


def test_threefry_partitionable_mode_is_on():
    """The streams copied are those of the partitionable mode, JAX's
    default: the test above would not hold under the other."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,minval,maxval", [
    ((33,), 0.0, 1.0), ((4, 33), -0.3, 0.7), ((2, 5, 16), -2.5e-3, 2.5e-3), ((3, 7), 1.0, 4.0),
    ((5, 64), -7.3e-2, 3.1e-3),
])
def test_uniform_bit_identical(dtype, shape, minval, maxval):
    """Uniform values in fp32 and bf16 (bf16 takes 8 random bits) with
    minval and maxval applied in the result's type: the same bits."""
    key = jax.random.fold_in(jax.random.key(5), 2)
    jax_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    torch_dtype = getattr(torch, dtype)
    expected = np.asarray(jax.random.uniform(key, shape, dtype=jax_dtype, minval=minval,
                                             maxval=maxval))
    got = prng.uniform(prng.fold_in(prng.key(5), 2), shape, torch_dtype, minval, maxval)
    assert got.dtype == torch_dtype and tuple(got.shape) == shape
    words = np.uint32 if dtype == "float32" else np.uint16
    ints = torch.int32 if dtype == "float32" else torch.int16
    np.testing.assert_array_equal(got.view(ints).numpy().view(words), expected.view(words))


# (global shape, block): a rank's rows, its rows and sequence chunk, one
# row's chunk, the whole; the last is one strided run of segments of 2 dims
BLOCKS = [
    ((4, 6, 8), (slice(2, 4),)),
    ((4, 6, 8), (slice(0, 2), slice(3, 6))),
    ((4, 6, 8), (slice(1, 2), slice(0, 3))),
    ((3, 5), ()),
    ((2, 4, 3, 5), (slice(1, 2), slice(1, 3), slice(0, 2))),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", BLOCKS)
def test_block_draw_is_that_block_of_the_whole_draw(dtype, shape, block):
    """`uniform(..., block=...)` (a mesh rank's NEFTune noise) gives the
    values of JAX's whole draw in that block, bit for bit; the kernel's
    segments (base + (i // seg_len) * seg_stride + i % seg_len) address
    the same elements."""
    key = jax.random.fold_in(jax.random.key(5), 2)
    jax_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    torch_dtype = getattr(torch, dtype)
    whole = np.asarray(jax.random.uniform(key, shape, dtype=jax_dtype, minval=-0.3, maxval=0.7))
    got = prng.uniform(prng.fold_in(prng.key(5), 2), shape, torch_dtype, -0.3, 0.7, block=block)
    want = whole[block]
    assert tuple(got.shape) == want.shape
    words = np.uint32 if dtype == "float32" else np.uint16
    ints = torch.int32 if dtype == "float32" else torch.int16
    np.testing.assert_array_equal(got.view(ints).numpy().view(words), want.view(words))

    local, base, seg_len, seg_stride = prng._block_segments(shape, block)
    i = np.arange(int(np.prod(local)))
    flat = np.arange(int(np.prod(shape))).reshape(shape)[block].reshape(-1)
    np.testing.assert_array_equal(base + (i // seg_len) * seg_stride + i % seg_len, flat)


def test_block_draw_rejects_what_the_kernel_cannot_address():
    with pytest.raises(ValueError, match="strided run"):
        prng._block_segments((4, 6, 8), (slice(0, 2), slice(0, 3), slice(0, 4)))
    with pytest.raises(ValueError, match="step 1"):
        prng.uniform(prng.key(0), (4, 6), block=(slice(0, 4, 2),))


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("vocab", [50, 1000])
def test_categorical_tokens_match_jax(rows, vocab):
    """categorical on [rows, vocab] along the last axis, over 8 keys: the
    same tokens. The Gumbel noise -log(-log(u)) is within a few fp32 ulps
    of JAX's (the two libraries' log differ in the last bit)."""
    logits = np.random.default_rng(rows + vocab).standard_normal((rows, vocab)).astype(np.float32)
    for call in range(8):
        jax_key = jax.random.fold_in(jax.random.key(1), call)
        key = prng.fold_in(prng.key(1), call)
        expected = np.asarray(jax.random.categorical(jax_key, jnp.asarray(logits), axis=-1))
        got = prng.categorical(key, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), expected)
        noise = prng.gumbel(key, (rows, vocab)).numpy()
        jax_noise = np.asarray(jax.random.gumbel(jax_key, (rows, vocab)))
        np.testing.assert_allclose(noise, jax_noise, rtol=4 * 2.0**-23, atol=4 * 2.0**-23)


def test_random_bits_rejects_other_widths():
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(prng.key(0), (3,), bit_width=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.uniform(prng.key(0), (3,), torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wrappers_take_the_plain_version_on_the_cpu(dtype):
    """On CPU tensors `uniform` and `categorical` are their plain versions
    (the kernels run on the card only) and launch nothing."""
    key = prng.fold_in(prng.key(7), 4)
    launches = (prng.uniform.launches, prng.categorical.launches)
    got = prng.uniform(key, (6, 11), dtype, -0.5, 0.25)
    want = prng.uniform_torch(key, (6, 11), dtype, -0.5, 0.25)
    assert got.device.type == "cpu" and torch.equal(got, want)
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32))
    assert torch.equal(prng.categorical(key, logits), prng.categorical_torch(key, logits))
    assert (prng.uniform.launches, prng.categorical.launches) == launches


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        prng.uniform(prng.key(0), (3,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        prng.categorical(prng.key(0), torch.zeros((2, 5), device="meta"))
