"""Port parity of the paged-cache attention path: `paged_append`,
`paged_cached_attention` and the plain version of the ragged paged-decode
kernel, against the JAX functions (the Pallas kernel in interpret mode),
on the same numpy inputs in fp32 on the CPU. The CUDA kernel itself is
held against the plain version on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.ops import paged_attention as jax_paged
from llm_training_tpu.ops.pallas import paged_attention as jax_kernel
from llm_training_tpu_torch.ops import paged_attention
from llm_training_tpu_torch.ops.kernels import bench_paged_decode as bench
from llm_training_tpu_torch.ops.kernels import paged_attention as kernels
from llm_training_tpu_torch.serve.paged_cache import TRASH_BLOCK

TOL = dict(rtol=2e-5, atol=2e-5)
BATCH, KV_HEADS, HEAD_DIM, PAGE, PAGES = 3, 2, 8, 8, 3
LENGTHS = np.asarray([0, 7, 20], np.int32)  # ragged: page starts and middles


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(group, seed=0, seq=1):
    rng = np.random.default_rng(seed)
    pool_shape = (1 + BATCH * PAGES, PAGE, KV_HEADS, HEAD_DIM)
    return dict(
        pool_k=rng.standard_normal(pool_shape).astype(np.float32),
        pool_v=rng.standard_normal(pool_shape).astype(np.float32),
        q=rng.standard_normal((BATCH, seq, KV_HEADS * group, HEAD_DIM)).astype(np.float32),
        k=rng.standard_normal((BATCH, seq, KV_HEADS, HEAD_DIM)).astype(np.float32),
        v=rng.standard_normal((BATCH, seq, KV_HEADS, HEAD_DIM)).astype(np.float32) + 1.0,
        tables=np.arange(1, 1 + BATCH * PAGES, dtype=np.int32).reshape(BATCH, PAGES),
    )


def test_paged_append_pads_go_to_trash():
    pool = torch.zeros((4, 8, 1, 4))
    k = torch.ones((1, 4, 1, 4))
    seg = torch.tensor([[1, 1, 0, 0]])
    tables = torch.tensor([[2, 3]], dtype=torch.int32)
    paged_attention.paged_append(
        pool, pool.clone(), k, k, torch.tensor([7], dtype=torch.int32), tables, seg
    )
    assert float(pool[2, 7, 0, 0]) == 1.0 and float(pool[3, 0, 0, 0]) == 1.0
    assert float(pool[1:].sum()) == 2 * 4  # two real tokens x head_dim
    assert float(pool[TRASH_BLOCK].sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_append_matches_jax(seed):
    """A 4-wide chunk with a padded tail and a row running off its table."""
    x = _inputs(1, seed, seq=4)
    seg = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]], np.int32)
    lengths = np.asarray([0, 7, 22], np.int32)
    pool_k, pool_v = _t(x["pool_k"]), _t(x["pool_v"])
    paged_attention.paged_append(
        pool_k, pool_v, _t(x["k"]), _t(x["v"]), _t(lengths), _t(x["tables"]), _t(seg)
    )
    jk, jv = jax_paged.paged_append(
        jnp.asarray(x["pool_k"]), jnp.asarray(x["pool_v"]), jnp.asarray(x["k"]),
        jnp.asarray(x["v"]), jnp.asarray(lengths), jnp.asarray(x["tables"]),
        jnp.asarray(seg),
    )
    # the trash block takes several writes in one scatter, in an order
    # neither framework fixes: compare the live blocks only
    np.testing.assert_array_equal(pool_k.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(pool_v.numpy()[1:], np.asarray(jv)[1:])


@pytest.mark.parametrize("seq", [1, 4], ids=["decode", "prefill_chunk"])
@pytest.mark.parametrize("window,cap", [(None, None), (5, 4.0)])
def test_paged_cached_attention_matches_jax(seq, window, cap):
    x = _inputs(2, seed=3, seq=seq)
    seg = np.ones((BATCH, seq), np.int32)
    if seq > 1:
        seg[1, seq // 2:] = 0  # a padded tail: its k/v go to the trash block
    pool_k, pool_v = _t(x["pool_k"]), _t(x["pool_v"])
    out = paged_attention.paged_cached_attention(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), (pool_k, pool_v), _t(LENGTHS),
        _t(x["tables"]), segment_ids=_t(seg), sliding_window=window,
        logits_soft_cap=cap,
    )
    out_j, (jk, _) = jax_paged.paged_cached_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        (jnp.asarray(x["pool_k"]), jnp.asarray(x["pool_v"])), jnp.asarray(LENGTHS),
        jnp.asarray(x["tables"]), segment_ids=jnp.asarray(seg),
        sliding_window=window, logits_soft_cap=cap, impl="xla",
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_array_equal(pool_k.numpy()[1:], np.asarray(jk)[1:])


@pytest.mark.parametrize("window,cap,group", [
    (None, None, 2), (5, None, 2), (None, 4.0, 1), (5, 4.0, 4),
])
def test_plain_decode_matches_pallas_kernel(window, cap, group):
    """The kernel's plain version against the Pallas kernel (interpreted),
    as `tests/test_serve.py` runs it: ragged lengths plus an idle row
    (length 1 on trash block 0)."""
    x = _inputs(group)
    q = x["q"][:, 0]
    tables = np.concatenate([x["tables"], np.zeros((1, PAGES), np.int32)])
    lengths = np.concatenate([LENGTHS + 1, [1]]).astype(np.int32)
    q = np.concatenate([q, q[:1]])
    ours = kernels.paged_decode_attention_torch(
        _t(q), _t(x["pool_k"]), _t(x["pool_v"]), _t(tables), _t(lengths),
        sliding_window=window, logits_soft_cap=cap,
    )
    theirs = jax_kernel.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(x["pool_k"]), jnp.asarray(x["pool_v"]),
        jnp.asarray(tables), jnp.asarray(lengths),
        sliding_window=window, logits_soft_cap=cap, interpret=True,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_wrapper_takes_plain_version_on_cpu_only():
    x = _inputs(2)
    args = (
        _t(x["q"][:, 0]), _t(x["pool_k"]), _t(x["pool_v"]), _t(x["tables"]),
        _t(LENGTHS + 1),
    )
    before = kernels.paged_decode_attention.launches
    torch.testing.assert_close(
        kernels.paged_decode_attention(*args),
        kernels.paged_decode_attention_torch(*args), rtol=0, atol=0,
    )
    assert kernels.paged_decode_attention.launches == before  # no kernel ran
    with pytest.raises(ValueError):  # impl='kernel' never falls back
        paged_attention.paged_cached_attention(
            _t(x["q"]), _t(x["k"]), _t(x["v"]), (args[1], args[2]),
            _t(LENGTHS), args[3], impl="kernel",
        )


def test_decode_bound_counts_visited_pages():
    """The kernel's HBM bound: K and V of each row's first `len` slots once
    (the unread tail of a row's last page is not counted), the table
    entries of the pages visited, plus q, out and lengths."""
    case = dict(
        q=torch.zeros((2, 8, 128), dtype=torch.bfloat16),
        k_pages=torch.zeros((9, 16, 2, 128), dtype=torch.bfloat16),
        block_tables=torch.zeros((2, 4), dtype=torch.int32),
        lengths=torch.tensor([1, 33], dtype=torch.int32),
    )
    slots = 1 + 33
    pages = 1 + 3  # ceil(1 / 16) + ceil(33 / 16)
    nbytes = slots * 2 * 128 * 2 * 2 + 2 * 2 * 8 * 128 * 2 + pages * 4 + 2 * 4
    bound_ms, bound_by = bench.decode_bound_ms(case)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(1e3 * nbytes / bench.HBM_BYTES_PER_S, rel=1e-12)
    assert bench.cold_copies(case) * 9 * 16 * 2 * 128 * 2 * 2 > 2 * bench.L2_BYTES


def test_wrapper_rejects_unsupported_shapes():
    """The kernel's shape checks run before any build or launch."""
    q = torch.zeros((2, 18, 64))
    pool = torch.zeros((4, 16, 2, 64))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="GQA group 9"):
        kernels._check(q, pool, pool, tables, lengths)
    with pytest.raises(ValueError, match="head_dim 32"):
        kernels._check(torch.zeros((2, 4, 32)), pool[..., :32], pool[..., :32], tables, lengths)
    with pytest.raises(ValueError, match="int32"):
        kernels._check(torch.zeros((2, 4, 64)), pool, pool, tables.long(), lengths)
