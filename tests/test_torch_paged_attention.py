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


def test_decode_bound_counts_the_window_only():
    """With a sliding window the bound counts each row's last `window`
    slots and the pages they lie in: Phi-3's 2047-token window over a row
    of 3000 tokens (slots 953-2999, pages 59-187) and a row inside it."""
    case = dict(
        q=torch.zeros((2, 32, 96), dtype=torch.bfloat16),
        k_pages=torch.zeros((200, 16, 32, 96), dtype=torch.bfloat16),
        block_tables=torch.zeros((2, 256), dtype=torch.int32),
        lengths=torch.tensor([3000, 100], dtype=torch.int32),
    )
    slots = 2047 + 100
    pages = (188 - 59) + 7
    nbytes = slots * 32 * 96 * 2 * 2 + 2 * 2 * 32 * 96 * 2 + pages * 4 + 2 * 4
    bound_ms, bound_by = bench.decode_bound_ms(case, window=2047)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(1e3 * nbytes / bench.HBM_BYTES_PER_S, rel=1e-12)
    assert bench.decode_bound_ms(case)[0] > bound_ms


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


# ------------------------------------------- the bf16 kernel's split and merge

SPLIT_PAGE, SPLIT_PAGES = 8, 12  # 96 slots a row
SPLIT_LENGTHS = [1, 5, 40, 96, 70, 1]  # rows 0 and 5 idle: length 1 on trash block 0


def _split_inputs(group, seed, head_dim=HEAD_DIM):
    rng = np.random.default_rng(seed)
    rows = len(SPLIT_LENGTHS)
    pool_shape = (1 + rows * SPLIT_PAGES, SPLIT_PAGE, KV_HEADS, head_dim)
    tables = np.arange(1, 1 + rows * SPLIT_PAGES, dtype=np.int32).reshape(rows, SPLIT_PAGES)
    tables = rng.permuted(tables, axis=1)  # the table indirection matters
    tables[0] = tables[-1] = TRASH_BLOCK
    return (
        rng.standard_normal((rows, KV_HEADS * group, head_dim)).astype(np.float32),
        rng.standard_normal(pool_shape).astype(np.float32),
        rng.standard_normal(pool_shape).astype(np.float32) + 0.5,
        tables, np.asarray(SPLIT_LENGTHS, np.int32),
    )


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("window,cap,group", [
    (None, None, 1), (20, None, 4), (None, 4.0, 2), (33, 4.0, 8),
], ids=["plain_g1", "window20_g4", "cap_g2", "window33_cap_g8"])
def test_split_merge_matches_pallas_kernel(splits, window, cap, group):
    """The bf16 kernel's algebra in plain PyTorch: each row's visible slots
    cut into `splits` runs of whole 16-slot chunks, a (m, l, acc) per split,
    the splits merged in order. Against the Pallas kernel (interpreted):
    ragged lengths, idle rows of length 1 on the trash block, and windows
    that leave whole splits empty (20 visible slots over 8 splits)."""
    q, pool_k, pool_v, tables, lengths = _split_inputs(group, seed=splits + group)
    ours = kernels.paged_decode_split_torch(
        _t(q), _t(pool_k), _t(pool_v), _t(tables), _t(lengths), splits,
        sliding_window=window, logits_soft_cap=cap,
    )
    theirs = jax_kernel.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tables),
        jnp.asarray(lengths), sliding_window=window, logits_soft_cap=cap, interpret=True,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    if window:  # the longest row's window leaves splits empty
        nonempty = sum(hi > lo for lo, hi in kernels.split_bounds(96, window, splits))
        assert nonempty <= -(-window // kernels.CHUNK) and (splits < 8 or nonempty < splits)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("window,group", [(None, 1), (20, 1), (33, 4)],
                         ids=["mha", "window20_mha", "window33_g4"])
def test_split_merge_matches_pallas_kernel_at_head_dim_96(splits, window, group):
    """Phi-3's head_dim 96 (MHA, a window shorter than the rows): the split
    algebra and the gather path (the plain versions of K4) against the
    Pallas kernel (interpreted), fp32, within 2e-5."""
    q, pool_k, pool_v, tables, lengths = _split_inputs(group, seed=96 + splits, head_dim=96)
    args = (_t(q), _t(pool_k), _t(pool_v), _t(tables), _t(lengths))
    theirs = np.asarray(jax_kernel.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, pool_k, pool_v, tables, lengths)),
        sliding_window=window, interpret=True,
    ))
    split = kernels.paged_decode_split_torch(*args, splits, sliding_window=window)
    np.testing.assert_allclose(split.numpy(), theirs, **TOL)
    gather = kernels.paged_decode_attention(*args, sliding_window=window)  # CPU: the plain version
    np.testing.assert_allclose(gather.numpy(), theirs, **TOL)


def test_wrapper_takes_head_dim_96_and_refuses_what_it_lacks():
    """96 joins 64 and 128 in what the kernel takes; 80 still raises."""
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    pool = torch.zeros((4, 16, 32, 96))
    assert kernels._check(torch.zeros((2, 32, 96)), pool, pool, tables, lengths) == 1
    with pytest.raises(ValueError, match="head_dim 80"):
        kernels._check(torch.zeros((2, 32, 80)), pool[..., :80], pool[..., :80], tables, lengths)


@pytest.mark.parametrize("length,window,splits", [
    (1, None, 1), (1, None, 8), (96, None, 3), (70, 20, 8), (1000, None, 16), (17, 5, 2),
])
def test_split_bounds_cover_the_visible_slots_once(length, window, splits):
    """Splits are contiguous runs of whole chunks in order, together exactly
    the visible slots [start, length); past the row's end a split is empty."""
    bounds = kernels.split_bounds(length, window, splits)
    start = max(length - window, 0) if window else 0
    assert len(bounds) == splits
    covered = [s for lo, hi in bounds for s in range(lo, hi)]
    assert covered == list(range(start, length))
    for lo, hi in bounds:
        assert hi <= lo or (lo - start) % kernels.CHUNK == 0


def test_merge_of_empty_parts_is_empty():
    """Parts that saw nothing (m = -inf, l = 0) weigh nothing; all of them
    give m = -inf, l = 0 and a zero accumulator, never NaN."""
    m = torch.tensor([[-np.inf], [1.5], [-np.inf]])
    l = torch.tensor([[0.0], [2.0], [0.0]])
    acc = torch.tensor([[[0.0, 0.0]], [[4.0, -2.0]], [[0.0, 0.0]]])
    top, l_sum, a_sum = kernels.merge_states(m, l, acc)
    assert float(top[0]) == 1.5 and float(l_sum[0]) == 2.0
    assert a_sum[0].tolist() == [4.0, -2.0]
    top, l_sum, a_sum = kernels.merge_states(m[[0, 2]], l[[0, 2]], acc[[0, 2]])
    assert float(top[0]) == -np.inf and float(l_sum[0]) == 0.0
    assert not torch.isnan(a_sum).any() and not a_sum.any()


@pytest.mark.parametrize("slots,rows,sms,expected", [
    (1024, 64, 132, 2),    # B 8 x Hkv 8, one wave of 128 blocks
    (2048, 64, 132, 2),    # the serving engine's table: 128 pages of 16 slots
    (2048, 8, 132, 16),    # the same table at batch 1
    (1024, 8, 132, 16),    # batch 1: the largest cluster
    (2000, 10, 132, 13),   # an intermediate count
    (100, 8, 132, 2),      # a short row: no split under 64 slots
    (30, 8, 132, 1),
    (4096, 1, 132, 16),    # capped at the largest cluster
    (1024, 200, 132, 1),   # more rows than SMs
    (0, 8, 132, 1),
])
def test_split_planner(slots, rows, sms, expected):
    """The host's split count: about one wave of `sms` SMs over `rows`
    (B x Hkv) rows, no split shorter than MIN_SPLIT_SLOTS of the slots a
    row's table holds, 1 to MAX_SPLITS."""
    assert kernels.plan_splits(slots, rows, sms) == expected
    assert 1 <= expected <= kernels.MAX_SPLITS
