"""Port parity of flash attention on the CPU: the port's plain versions
(`ops/kernels/flash_attention.py`, which the CPU takes and which the CUDA
kernels are held to on the card) against the JAX package.

The same numpy inputs go through JAX `dot_product_attention(impl="xla")`
(O and the gradients, fp32, atol 1e-4: summation order only) and through
JAX `flash_attention` / `flash_fwd_flat` run as their own tests run them,
interpreted on the CPU (O, LSE and some gradients at that file's 2e-3).
Sizes are those of `tests/test_pallas_flash_attention.py`."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.ops.attention import dot_product_attention as jax_dpa
from llm_training_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from llm_training_tpu.ops.pallas.flash_attention import flash_fwd_flat as jax_fwd_flat
from llm_training_tpu_torch.ops import attention
from llm_training_tpu_torch.ops.kernels import flash_attention as fa

XLA_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32, summation order only
FLASH_TOL = dict(rtol=2e-3, atol=2e-3)  # the JAX flash tests' own tolerance

# (name, hq, hkv, sliding_window, soft_cap, packed): test_pallas_flash_attention.CASES
CASES = [
    ("causal", 4, 4, None, None, False),
    ("gqa", 4, 2, None, None, False),
    ("packed_gqa", 4, 2, None, None, True),
    ("window", 2, 2, 37, None, False),
    ("softcap", 2, 2, None, 20.0, False),
    ("everything", 4, 2, 50, 30.0, True),
]


def _packed_segments(rng, batch, seq, max_docs=4):
    """Random packed segment ids: 1..N runs then 0-padding (as in the JAX tests)."""
    rows = []
    for _ in range(batch):
        cuts = np.sort(rng.choice(np.arange(1, seq), size=max_docs - 1, replace=False))
        row, seg, prev = [], 1, 0
        for c in list(cuts) + [seq - 2]:
            if c <= prev:
                continue
            row += [seg] * (c - prev)
            seg += 1
            prev = c
        row += [0] * (seq - len(row))
        rows.append(row)
    return np.asarray(rows, np.int32)


def _qkv(rng, batch, sq, skv, hq, hkv, d):
    return (
        rng.standard_normal((batch, sq, hq, d)).astype(np.float32),
        rng.standard_normal((batch, skv, hkv, d)).astype(np.float32),
        rng.standard_normal((batch, skv, hkv, d)).astype(np.float32),
    )


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _port(q, k, v, cot, sinks=None, **kw):
    """O and the gradients of sum(O * cot) through the port's wrapper (the
    plain version, since the tensors are on the CPU)."""
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    if sinks is not None:
        leaves.append(_t(sinks).requires_grad_())
    kw = {k_: _t(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    out = fa.flash_attention(*leaves[:3], sinks=leaves[3] if sinks is not None else None, **kw)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _jax(fn, q, k, v, cot, sinks=None, **kw):
    kw = {k_: _j(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    args = [_j(x) for x in (q, k, v)] + ([_j(sinks)] if sinks is not None else [])

    def loss(*a):
        out = fn(*a[:3], sinks=a[3] if sinks is not None else None, **kw)
        return (out * _j(cot)).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _xla(*a, **kw):
    return _jax(lambda *x, **y: jax_dpa(*x, impl="xla", **y), *a, **kw)


def _check(port, ref, tol, names=("dq", "dk", "dv", "d_sinks")):
    np.testing.assert_allclose(port[0], ref[0], err_msg="out", **tol)
    for name, a, b in zip(names, port[1], ref[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


def _lse_vs_jax_flat(q, k, v, seg_q, seg_kv, sinks=None, **kw):
    """LSE of the port's flat plain forward against JAX `flash_fwd_flat`
    (interpreted), on q with the scale folded in, as both wrappers do."""
    batch, sq, hq, d = q.shape
    hkv = k.shape[2]
    qs = q * d**-0.5
    flat = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, x.shape[1], d)  # noqa: E731
    o_j, lse_j = jax_fwd_flat(
        flat(qs), flat(k), flat(v), jnp.asarray(seg_q), jnp.asarray(seg_kv),
        num_q_heads=hq, num_kv_heads=hkv, scale=1.0, interpret=True,
        sinks=_j(sinks), block_q=min(128, sq), block_k=min(128, k.shape[1]),
        causal=kw.get("causal", True), sliding_window=kw.get("window") or None,
        logits_soft_cap=kw.get("cap") or None, q_offset=kw.get("q_offset", 0),
    )
    o, lse = fa.flash_fwd_torch(
        _t(qs), _t(k), _t(v), _t(seg_q), _t(seg_kv), _t(sinks),
        causal=kw.get("causal", True), window=kw.get("window", 0), cap=kw.get("cap", 0.0),
        q_offset=kw.get("q_offset", 0),
    )
    lse_j = np.asarray(lse_j).reshape(batch, hq, sq)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(lse_j))
    finite = np.isfinite(lse_j)
    np.testing.assert_allclose(lse.numpy()[finite], lse_j[finite], **FLASH_TOL)
    o_j = np.asarray(o_j).reshape(batch, hq, sq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.numpy(), o_j, **FLASH_TOL)
    return lse.numpy()


@pytest.mark.parametrize("name,hq,hkv,window,cap,packed", CASES, ids=[c[0] for c in CASES])
def test_forward_lse_and_grads_match_jax(name, hq, hkv, window, cap, packed):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    batch, seq, d = 2, 256, 32
    q, k, v = _qkv(rng, batch, seq, seq, hq, hkv, d)
    seg = _packed_segments(rng, batch, seq) if packed else None
    cot = rng.standard_normal((batch, seq, hq, d)).astype(np.float32)
    kw = dict(segment_ids=seg, causal=True, sliding_window=window, logits_soft_cap=cap)
    _check(_port(q, k, v, cot, **kw), _xla(q, k, v, cot, **kw), XLA_TOL)
    ones = np.ones((batch, seq), np.int32)
    _lse_vs_jax_flat(q, k, v, ones if seg is None else seg, ones if seg is None else seg,
                     window=window or 0, cap=cap or 0.0)


@pytest.mark.parametrize("name", ["packed_gqa", "everything"])
def test_grads_match_jax_flash_interpreted(name):
    _, hq, hkv, window, cap, _ = next(c for c in CASES if c[0] == name)
    rng = np.random.default_rng(zlib.crc32(("bwd" + name).encode()))
    batch, seq, d = 1, 256, 32
    q, k, v = _qkv(rng, batch, seq, seq, hq, hkv, d)
    seg = _packed_segments(rng, batch, seq)
    cot = rng.standard_normal((batch, seq, hq, d)).astype(np.float32)
    kw = dict(segment_ids=seg, causal=True, sliding_window=window, logits_soft_cap=cap)
    flash = lambda *a, **k_: jax_flash(*a, block_q=128, block_k=128, **k_)  # noqa: E731
    _check(_port(q, k, v, cot, **kw), _jax(flash, q, k, v, cot, **kw), FLASH_TOL)


def test_block_aligned_docs():
    """Two 256-token documents at 128-token blocks: the layout that broke
    the Pallas kernel's DMA elision (`test_packed_block_aligned_docs`)."""
    rng = np.random.default_rng(7)
    batch, seq, h, d = 2, 512, 2, 32
    q, k, v = _qkv(rng, batch, seq, seq, h, h, d)
    seg = np.tile(np.repeat([1, 2], 256)[None], (batch, 1)).astype(np.int32)
    cot = rng.standard_normal((batch, seq, h, d)).astype(np.float32)
    kw = dict(segment_ids=seg, causal=True)
    port = _port(q, k, v, cot, **kw)
    _check(port, _xla(q, k, v, cot, **kw), XLA_TOL)
    got = np.asarray(jax_flash(*map(_j, (q, k, v)), segment_ids=_j(seg), causal=True,
                               block_q=128, block_k=128))
    np.testing.assert_allclose(port[0], got, **FLASH_TOL)


def test_fully_masked_rows_emit_zero():
    """Padding rows give exactly 0 output, LSE -inf and zero dq."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 128, 128, 2, 2, 32)
    seg = np.asarray([[1] * 64 + [0] * 64], np.int32)
    cot = rng.standard_normal((1, 128, 2, 32)).astype(np.float32)
    out, (dq, _, _) = _port(q, k, v, cot, segment_ids=seg)
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out[:, 64:], 0.0)
    np.testing.assert_array_equal(dq[:, 64:], 0.0)
    lse = _lse_vs_jax_flat(q, k, v, seg, seg)
    assert np.isneginf(lse[:, :, 64:]).all() and np.isfinite(lse[:, :, :64]).all()


def test_cross_length_chunk_with_q_offset():
    """q is the second half of the kv sequence (q_offset 128): the same as
    that slice of the full attention, and as JAX's chunk."""
    rng = np.random.default_rng(3)
    seq, d = 256, 32
    q, k, v = _qkv(rng, 1, seq, seq, 2, 2, d)
    seg = _packed_segments(rng, 1, seq)
    cot = rng.standard_normal((1, 128, 2, d)).astype(np.float32)
    kw = dict(segment_ids=seg, q_segment_ids=seg[:, 128:], q_offset=128)
    part = _port(q[:, 128:], k, v, cot, **kw)
    _check(part, _xla(q[:, 128:], k, v, cot, **kw), XLA_TOL)
    full = fa.flash_attention(*map(_t, (q, k, v)), segment_ids=_t(seg))
    np.testing.assert_allclose(part[0], full[:, 128:].numpy(), **XLA_TOL)
    _lse_vs_jax_flat(q[:, 128:], k, v, seg[:, 128:], seg, q_offset=128)


@pytest.mark.parametrize("sliding_window", [None, 8])
def test_sinks_match_jax(sliding_window):
    """gpt-oss sinks: O, LSE and every gradient including d_sinks
    (`test_sinks_match_xla`; d_sinks sums row terms that cancel, so it is
    held at that test's atol 1e-3)."""
    rng = np.random.default_rng(60)
    b, s, hq, hkv, d = 2, 32, 4, 2, 64
    q, k, v = _qkv(rng, b, s, s, hq, hkv, d)
    sinks = rng.standard_normal(hq).astype(np.float32)
    seg = np.concatenate([np.ones((b, s - 6)), np.full((b, 4), 2), np.zeros((b, 2))], 1)
    seg = seg.astype(np.int32)
    cot = np.broadcast_to(np.arange(d, dtype=np.float32), (b, s, hq, d)).copy()
    kw = dict(segment_ids=seg, causal=True, sliding_window=sliding_window)
    port = _port(q, k, v, cot, sinks=sinks, **kw)
    ref = _xla(q, k, v, cot, sinks=sinks, **kw)
    _check((port[0], port[1][:3]), (ref[0], ref[1][:3]), XLA_TOL)
    np.testing.assert_allclose(port[1][3], ref[1][3], rtol=1e-4, atol=1e-3, err_msg="d_sinks")
    lse = _lse_vs_jax_flat(q, k, v, seg, seg, sinks=sinks, window=sliding_window or 0)
    # a padding row sees only its sink: O = 0 and LSE = sink
    np.testing.assert_array_equal(port[0][:, -2:], 0.0)
    np.testing.assert_allclose(lse[:, :, -1], np.broadcast_to(sinks, (b, hq)), rtol=1e-6)


def test_sink_grad_glue_matches_autograd():
    """The backward's d_sinks glue (-sum exp(sink - LSE) * delta) equals
    autograd through the plain version."""
    rng = np.random.default_rng(61)
    q, k, v = _qkv(rng, 1, 40, 40, 4, 2, 64)
    sinks = _t(rng.standard_normal(4).astype(np.float32)).requires_grad_()
    seg = _t(np.asarray([[1] * 30 + [2] * 8 + [0] * 2], np.int32))
    dout = _t(rng.standard_normal((1, 40, 4, 64)).astype(np.float32))
    o, lse = fa.flash_fwd_torch(_t(q), _t(k), _t(v), seg, seg, sinks)
    (o * dout).sum().backward()
    delta = (dout * o.detach()).sum(-1).transpose(1, 2)
    np.testing.assert_allclose(
        fa.sink_grad(sinks.detach(), lse.detach(), delta).numpy(), sinks.grad.numpy(), **XLA_TOL
    )


def test_gqa_group4():
    rng = np.random.default_rng(44)
    q, k, v = _qkv(rng, 1, 256, 256, 8, 2, 32)
    cot = rng.standard_normal((1, 256, 8, 32)).astype(np.float32)
    kw = dict(causal=True, sliding_window=70)
    _check(_port(q, k, v, cot, **kw), _xla(q, k, v, cot, **kw), XLA_TOL)


@pytest.mark.parametrize("case", [
    dict(seq=384, docs=[128, 128, 128], window=None, hq=4, hkv=1),
    dict(seq=384, docs=[256, 128], window=64, hq=4, hkv=2),
    dict(seq=512, docs=[128, 256, 128], window=96, hq=8, hkv=2),
    dict(seq=512, docs=[384, 128], window=None, hq=2, hkv=2),
    dict(seq=512, docs=[64, 192, 256], window=160, hq=4, hkv=4),
], ids=["aligned3", "window64", "gqa4_window96", "long_doc", "mixed"])
def test_packed_layout_fuzz(case):
    """`test_packed_layout_fuzz_fwd_and_grad`'s layouts: block-aligned
    boundaries, documents spanning blocks, windows across boundaries."""
    rng = np.random.default_rng(zlib.crc32(str(sorted(case.items())).encode()))
    seq, hq, hkv = case["seq"], case["hq"], case["hkv"]
    q, k, v = _qkv(rng, 1, seq, seq, hq, hkv, 32)
    seg = np.concatenate([np.full(n, i + 1) for i, n in enumerate(case["docs"])])[None]
    cot = rng.standard_normal((1, seq, hq, 32)).astype(np.float32)
    kw = dict(segment_ids=seg.astype(np.int32), causal=True, sliding_window=case["window"])
    _check(_port(q, k, v, cot, **kw), _xla(q, k, v, cot, **kw), XLA_TOL)


def test_dispatcher_routes_and_raises():
    """'auto' and 'torch' take the plain path on a CPU tensor and agree
    with JAX; 'kernel' (JAX's 'pallas') raises there instead of falling back."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 64, 64, 4, 2, 32)
    expected = np.asarray(jax_dpa(*map(_j, (q, k, v)), impl="xla"))
    for impl in ("auto", "torch", "xla"):
        got = attention.dot_product_attention(*map(_t, (q, k, v)), impl=impl)
        np.testing.assert_allclose(got.numpy(), expected, **XLA_TOL)
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            attention.dot_product_attention(*map(_t, (q, k, v)), impl=impl)
    with pytest.raises(ValueError, match="impl"):
        attention.dot_product_attention(*map(_t, (q, k, v)), impl="flash")


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: a CPU tensor raises before
    anything is built."""
    q = torch.zeros((1, 64, 2, 64))
    seg = torch.ones((1, 64), dtype=torch.int32)
    ranges = fa.tile_ranges(seg)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_kernel(q, q, q, seg, seg, ranges, ranges, None,
                            causal=True, window=0, cap=0.0, q_offset=0)
    assert fa.flash_fwd_kernel.launches == 0


def test_tile_ranges():
    seg = torch.tensor([[1] * 64 + [2] * 30 + [0] * 34 + [0] * 64 + [3] * 10 + [4] * 54])
    ranges = fa.tile_ranges(seg).tolist()
    assert ranges == [[[1, 1], [2, 2], [2**30, 0], [3, 4]]]


# ------------------------------------------------ the 128-row block of the bf16 backward


def _ids(kind: str, seq: int, seed: int) -> torch.Tensor:
    """Segment ids `[2, seq]` for the range and padding tests."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(2):
        if kind == "packed":
            row = _packed_segments(rng, 1, seq, max_docs=6)[0]
        elif kind == "boundary_64":  # a document boundary inside a 128-row block
            row = np.ones(seq, np.int32)
            row[64:] = 2
            row[seq - 3:] = 0
        elif kind == "padding_block":  # a whole 64-row tile of padding in a block
            row = np.ones(seq, np.int32)
            row[64:128] = 0
            row[128:] = 3
        else:
            row = np.zeros(seq, np.int32)
        rows.append(np.asarray(row, np.int32))
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("kind", ["packed", "boundary_64", "padding_block", "all_padding"])
@pytest.mark.parametrize("seq", [128, 384, 1024])
def test_block_ranges_merge_tile_ranges(kind, seq):
    """A 128-row block's range is the smallest and largest over its two
    64-row tiles' ranges (an all-padding tile's 2**30 never wins the
    smallest unless both are padding)."""
    seg = _ids(kind, seq, seq)
    tiles = fa.tile_ranges(seg)
    blocks = fa.tile_ranges(seg, fa.BLOCK)
    assert tiles.shape == (2, seq // fa.TILE, 2) and blocks.shape == (2, seq // fa.BLOCK, 2)
    pairs = tiles.reshape(2, -1, 2, 2)
    assert torch.equal(blocks[..., 0], pairs[..., 0].amin(-1))
    assert torch.equal(blocks[..., 1], pairs[..., 1].amax(-1))
    assert blocks.dtype == torch.int32 and blocks.is_contiguous()


@pytest.mark.parametrize("head_dim", [16, 64, 100, 128])
@pytest.mark.parametrize("q_len,kv_len", [(64, 64), (257, 257), (300, 300), (100, 300)])
def test_pad_inputs_pads_to_the_block(q_len, kv_len, head_dim):
    """Sequences go to the next multiple of 128 and head_dim to 64 or 128;
    the caller's values stay where they were, padded rows carry segment id 0
    and zeros."""
    rng = np.random.default_rng(q_len + head_dim)
    q = _t(rng.standard_normal((2, q_len, 4, head_dim)).astype(np.float32))
    k = _t(rng.standard_normal((2, kv_len, 2, head_dim)).astype(np.float32))
    v = _t(rng.standard_normal((2, kv_len, 2, head_dim)).astype(np.float32))
    seg_kv = _ids("packed", kv_len, kv_len).clamp_min(1)
    seg_q = seg_kv[:, kv_len - q_len:]
    pq, pk, pv, psq, pskv = fa.pad_inputs(q, k, v, seg_q, seg_kv)
    d_pad = 64 if head_dim <= 64 else 128
    for padded, orig, ids, n in ((pq, q, psq, q_len), (pk, k, pskv, kv_len), (pv, v, pskv, kv_len)):
        assert padded.shape[1] % fa.BLOCK == 0 and 0 <= padded.shape[1] - n < fa.BLOCK
        assert padded.shape[3] == d_pad and padded.is_contiguous() and ids.is_contiguous()
        assert torch.equal(padded[:, :n, :, :head_dim], orig)
        assert not padded[:, n:].any() and not padded[..., head_dim:].any()
        assert ids.shape == padded.shape[:2] and not ids[:, n:].any()
    assert torch.equal(psq[:, :q_len], seg_q) and torch.equal(pskv[:, :kv_len], seg_kv)


@pytest.mark.parametrize("q_len,kv_len", [(64, 64), (257, 257), (300, 300), (100, 300)])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_kernel_route_pads_and_slices_back(q_len, kv_len, head_dim):
    """The wrapper's CUDA route with the plain version standing in for the
    kernels: what reaches them is padded to the block with segment id 0,
    and what comes back is sliced to the caller's lengths and equals the
    plain attention on the unpadded inputs (O and the gradients)."""
    rng = np.random.default_rng(q_len + kv_len + head_dim)
    q, k, v = _qkv(rng, 2, q_len, kv_len, 4, 2, head_dim)
    cot = rng.standard_normal(q.shape).astype(np.float32)
    seg_kv = _ids("packed", kv_len, kv_len)
    seg_q = seg_kv[:, kv_len - q_len:].contiguous()
    q_offset = kv_len - q_len
    seen = {}

    def attend(q, k, v, seg_q, seg_kv, sinks, causal, window, cap, q_offset):
        seen.update(q=q.shape, k=k.shape, seg_q=seg_q, seg_kv=seg_kv)
        return fa.flash_fwd_torch(q, k, v, seg_q, seg_kv, sinks, causal=causal, window=window,
                                  cap=cap, q_offset=q_offset)[0]

    def run(fn):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(_t(cot))
        return [out.detach(), *[leaf.grad for leaf in leaves]]

    got = run(lambda q, k, v: fa._through_kernels(
        q, k, v, seg_kv, seg_q, True, 50, 0.0, head_dim**-0.5, q_offset, None, attend=attend))
    expected = run(lambda q, k, v: fa.flash_attention_torch(
        q, k, v, seg_kv, seg_q, causal=True, sliding_window=50, q_offset=q_offset))
    assert seen["q"][1] % fa.BLOCK == 0 and seen["k"][1] % fa.BLOCK == 0
    assert seen["q"][3] == seen["k"][3] == (64 if head_dim <= 64 else 128)
    assert not seen["seg_q"][:, q_len:].any() and not seen["seg_kv"][:, kv_len:].any()
    assert got[0].shape == (2, q_len, 4, head_dim)
    for a, b in zip(got, expected):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **XLA_TOL)


def test_backward_launchers_want_whole_blocks():
    """In bf16 the backward launchers refuse a sequence that is not a
    multiple of the 128-row block, before anything is built."""
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    seg = torch.ones((1, 64), dtype=torch.int32)
    ranges = fa.tile_ranges(seg)
    row = torch.zeros((1, 2, 64))
    for launcher, blocks in ((fa.flash_dq_kernel, "q_blocks"), (fa.flash_dkv_kernel, "k_blocks")):
        with pytest.raises(ValueError, match="multiple of 128"):
            launcher(q, q, q, seg, seg, ranges, ranges, q, row, row, causal=True, window=0,
                     cap=0.0, q_offset=0, **{blocks: ranges})
        assert launcher.launches == 0
