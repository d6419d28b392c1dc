"""Tests of the port that need an NVIDIA card: the CUDA kernels have no CPU
mode, so these skip elsewhere. This file imports no JAX, so it also runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from llm_training_tpu_torch.ops.kernels import paged_attention as kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-decode kernel has no CPU mode")
    return torch.device("cuda")


def _case(dtype, head_dim, group, page, lengths, device):
    gen = torch.Generator(device=device).manual_seed(0)
    pages = [-(-n // page) for n in lengths]
    num_blocks = 1 + sum(pages)
    tables = torch.zeros((len(lengths), max(pages)), dtype=torch.int32)
    used = 1
    for row, n in enumerate(pages):
        tables[row, :n] = torch.arange(used, used + n)
        used += n
    shape = (num_blocks, page, 2, head_dim)
    return dict(
        q=torch.randn((len(lengths), 2 * group, head_dim), generator=gen, device=device).to(dtype),
        k_pages=torch.randn(shape, generator=gen, device=device).to(dtype),
        v_pages=torch.randn(shape, generator=gen, device=device).to(dtype),
        block_tables=tables.to(device),
        lengths=torch.tensor(lengths, dtype=torch.int32, device=device),
    )


@pytest.mark.cuda
# against the plain version in fp32 on the same values: the kernel keeps
# every intermediate in fp32, so in bf16 only the rounding of its output
# (at most 2^-8 of the value) may differ
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 2.0**-8, 1e-5),
])
@pytest.mark.parametrize("head_dim,group,page", [(64, 1, 8), (128, 4, 16), (128, 8, 32),
                                                 (96, 1, 16), (96, 4, 16), (80, 1, 16),
                                                 (80, 4, 16), (256, 2, 16), (256, 8, 16),
                                                 (128, 16, 16), (128, 12, 16)])
@pytest.mark.parametrize("window,cap", [(None, None), (20, 5.0)])
def test_kernel_matches_plain(cuda, dtype, rtol, atol, head_dim, group, page, window, cap):
    case = _case(dtype, head_dim, group, page, [1, page, 50, 300, 1100], cuda)
    opts = dict(sliding_window=window, logits_soft_cap=cap)
    before = kernels.paged_decode_attention.launches
    out = kernels.paged_decode_attention(**case, **opts)
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}
    ref = kernels.paged_decode_attention_torch(**as_fp32, **opts)
    torch.cuda.synchronize()
    assert kernels.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,splits", [
    ([1500, 1], 16), ([1, 16, 53, 2000, 1], 13), ([1, 9, 40, 63, 1], 1),
], ids=["batch1_long", "ragged", "short"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 5.0)])
def test_split_kernel_matches_plain(cuda, lengths, splits, group, window, cap):
    """The bf16 kernel splits each row over a cluster of `splits` blocks
    (what the planner picks for these rows on 132 SMs) and merges on chip:
    per element within one bf16 rounding (2^-8 |x| + 1e-5) of the plain
    version in fp32 on the same values, and of the split algebra's own
    plain version; idle rows exactly 0 where the plain version is."""
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    case = decode_case(lengths, 16, 2, group, 128, torch.bfloat16, seed=group)
    case["block_tables"][-1] = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = kernels.plan_splits(case["block_tables"].shape[1] * 16, 2 * len(lengths), sms)
    if sms == 132:
        assert planned == splits
    opts = dict(sliding_window=window, logits_soft_cap=cap)
    out = kernels.paged_decode_attention(**case, **opts).float()
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}
    ref = kernels.paged_decode_attention_torch(**as_fp32, **opts)
    split_ref = kernels.paged_decode_split_torch(**as_fp32, splits=planned, **opts)
    torch.cuda.synchronize()
    for expected in (ref, split_ref):
        torch.testing.assert_close(out, expected, rtol=2.0**-8, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [None, 2047])
def test_split_kernel_at_head_dim_96(cuda, group, window):
    """Phi-3's shape: head_dim 96 (192-byte K/V rows through the swizzled
    ring), MHA and group 4, its 2047-token window over rows up to 3000
    tokens, bf16: within one bf16 rounding of the plain version in fp32
    and of the split algebra's plain version."""
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    case = decode_case([1, 16, 530, 2100, 3000, 1], 16, 4, group, 96, torch.bfloat16, seed=96)
    case["block_tables"][-1] = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = kernels.plan_splits(case["block_tables"].shape[1] * 16, 4 * 6, sms)
    out = kernels.paged_decode_attention(**case, sliding_window=window).float()
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}
    ref = kernels.paged_decode_attention_torch(**as_fp32, sliding_window=window)
    split_ref = kernels.paged_decode_split_torch(**as_fp32, splits=planned, sliding_window=window)
    torch.cuda.synchronize()
    for expected in (ref, split_ref):
        torch.testing.assert_close(out, expected, rtol=2.0**-8, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,kv_heads,group", [
    (80, 32, 1),  # Phi-2: MHA, 160-byte K/V rows
    (256, 8, 2),  # Gemma-2-9B
    (256, 1, 8),  # gemma-2b
    (128, 2, 16),  # GLM-4-9B: two n8 column tiles
    (128, 8, 12),  # Command-R+: group 12 on kG 16, columns masked
    (256, 4, 16),  # D 256 and group 16 together
])
@pytest.mark.parametrize("window,cap", [(None, None), (700, 50.0)])
def test_split_kernel_at_new_shapes(cuda, head_dim, kv_heads, group, window, cap):
    """The split kernel at the head shapes added for Phi-2, Gemma and the
    groups above 8, with a window and Gemma's soft cap: within one bf16
    rounding of the plain version in fp32 and of the split algebra's."""
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    case = decode_case([1, 16, 530, 2100, 1], 16, kv_heads, group, head_dim, torch.bfloat16,
                       seed=head_dim + group)
    case["block_tables"][-1] = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = kernels.plan_splits(case["block_tables"].shape[1] * 16, kv_heads * 5, sms)
    opts = dict(sliding_window=window, logits_soft_cap=cap)
    before = kernels.paged_decode_attention.launches
    out = kernels.paged_decode_attention(**case, **opts).float()
    assert kernels.paged_decode_attention.launches == before + 1
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}
    ref = kernels.paged_decode_attention_torch(**as_fp32, **opts)
    split_ref = kernels.paged_decode_split_torch(**as_fp32, splits=planned, **opts)
    torch.cuda.synchronize()
    for expected in (ref, split_ref):
        torch.testing.assert_close(out, expected, rtol=2.0**-8, atol=1e-5)


@pytest.mark.cuda
def test_split_kernel_is_deterministic(cuda):
    """Two launches on one input give the same bits: the blocks of a
    cluster merge in a fixed order, no atomics."""
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    case = decode_case([1500, 700, 1], 16, 8, 4, 128, torch.bfloat16, seed=3)
    first = kernels.paged_decode_attention(**case)
    assert torch.equal(first, kernels.paged_decode_attention(**case))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    case = _case(torch.float32, 128, 4, 16, [5, 9], cuda)
    case["q"] = case["q"][:, ::2]  # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        kernels.paged_decode_attention(**case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_phi2_decode_step_runs_through_k4(cuda, dtype):
    """A Llama-graph type at Phi-2's head_dim 80 decodes through K4 on the
    card (no plain fallback): one launch per layer, logits within the
    dtype's limit of the same step through the plain gather path."""
    from llm_training_tpu_torch.models.base import PagedDecodeState
    from llm_training_tpu_torch.models.llama.hf_conversion import config_from_hf
    from llm_training_tpu_torch.models.llama.model import Llama

    name = "float32" if dtype == torch.float32 else "bfloat16"
    config = config_from_hf({
        "model_type": "phi", "vocab_size": 64, "hidden_size": 160, "intermediate_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 2, "max_position_embeddings": 64},
        compute_dtype=name, param_dtype=name)
    assert config.resolved_head_dim == 80
    model = Llama(config, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model.init_weights(gen)
    tokens = torch.randint(0, 64, (1, 6), generator=gen, device=cuda)
    logits = {}
    for impl in ("kernel", "torch"):
        pool = torch.zeros((2, 2, 16, 2, 80), dtype=dtype, device=cuda)
        state = PagedDecodeState(k=pool, v=pool.clone(),
                                 block_tables=torch.ones((1, 1), dtype=torch.int32, device=cuda),
                                 lengths=torch.zeros(1, dtype=torch.int32, device=cuda))
        with torch.no_grad():
            state = model(tokens[:, :5], decode_state=state, paged_impl="torch").decode_state
            before = kernels.paged_decode_attention.launches
            out = model(tokens[:, 5:], decode_state=state, paged_impl=impl)
        launched = kernels.paged_decode_attention.launches - before
        assert launched == (2 if impl == "kernel" else 0)
        logits[impl] = out.logits.float()
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(logits["torch"].abs().max())
    assert float((logits["kernel"] - logits["torch"]).abs().max()) <= limit * scale


# ---------------------------------------------------------------- flash attention (K1-K3)


def _flash_case(dtype, head_dim, group, q_len=None, seq=300):
    import numpy as np

    from llm_training_tpu_torch.ops.kernels import bench_flash

    rng = np.random.default_rng(head_dim + group)
    rows = [bench_flash.layout("packed", seq, rng), bench_flash.layout("padding_tail", seq, rng)]
    return bench_flash.flash_case(seq, 2 * group, 2, head_dim, dtype, rows, seed=group, q_len=q_len)


def _assert_flash_matches_plain(got, ref, case, dtype):
    """Per tensor over max|ref|: fp32 within 1e-4 (summation order only);
    bf16 within 1e-2 (P and dS rounded to bf16 at other points; d_sinks, a
    sum of cancelling row terms, is left to chip_smoke.py's fp32 check).
    LSE is fp32 in both: 1e-4. Fully masked rows: O and dq exactly 0."""
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    for name, value in got.items():
        if name == "dsinks" and dtype == torch.bfloat16:
            continue
        finite = torch.isfinite(ref[name])
        assert torch.equal(torch.isfinite(value), finite), name
        scale = float(ref[name][finite].abs().max())
        err = float((value[finite].float() - ref[name][finite].float()).abs().max())
        assert err <= (1e-4 if name == "lse" else limit) * scale, (name, err, scale)
    padding = case["q_segment_ids"] == 0
    assert bool((got["out"][padding] == 0).all()) and bool((got["dq"][padding] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,group", [(64, 1), (128, 4), (128, 8), (256, 2), (256, 8)])
@pytest.mark.parametrize("variant", ["causal", "window", "cap", "sinks", "q_offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_kernels_match_plain(cuda, dtype, head_dim, group, variant):
    """K1 (O, LSE) and K2/K3 (dq, dk, dv, d_sinks) against the plain
    version in the same dtype (limits: `_assert_flash_matches_plain`)."""
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    case = _flash_case(dtype, head_dim, group, q_len=100 if variant == "q_offset" else None)
    opts = {"window": dict(sliding_window=100), "cap": dict(logits_soft_cap=30.0),
            "sinks": dict(sinks=torch.randn(2 * group, device=cuda))}.get(variant, {})
    before = (fa.flash_fwd_kernel.launches, fa.flash_dq_kernel.launches,
              fa.flash_dkv_kernel.launches)
    got = bench_flash.run_case(case, kernel=True, causal=True, **dict(opts))
    ref = bench_flash.run_case(case, kernel=False, causal=True, **dict(opts))
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.launches == before[0] + 2  # the autograd call and the LSE call
    assert fa.flash_dq_kernel.launches == before[1] + 1
    assert fa.flash_dkv_kernel.launches == before[2] + 1
    _assert_flash_matches_plain(got, ref, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,q_len", [(64, None), (257, None), (300, 170), (300, 70)],
                         ids=["s64", "s257", "chunk170", "chunk70"])
@pytest.mark.parametrize("head_dim,group", [(64, 1), (64, 8), (128, 4), (128, 8), (256, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_kernels_across_the_block(cuda, dtype, head_dim, group, seq, q_len):
    """Lengths that cross the backward kernels' 128-row block: half a block,
    two blocks and a row (with a packed boundary at row 64, inside a block),
    and q_offset chunks that are no block multiple (Sq != Skv), with a
    sliding window."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    case = _flash_case(dtype, head_dim, group, q_len=q_len, seq=seq)
    opts = dict(causal=True, sliding_window=90)
    got = bench_flash.run_case(case, kernel=True, **opts)
    ref = bench_flash.run_case(case, kernel=False, **opts)
    torch.cuda.synchronize()
    _assert_flash_matches_plain(got, ref, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 90], ids=["full", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_kernels_without_causal_mask(cuda, dtype, window):
    """causal=False: every kv tile of a document is visible to its q rows
    (the producers' loop bounds and the unmasked path do not assume k <= q)."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    case = _flash_case(dtype, 128, 4, seq=300)
    opts = dict(causal=False, sliding_window=window)
    got = bench_flash.run_case(case, kernel=True, **opts)
    ref = bench_flash.run_case(case, kernel=False, **opts)
    torch.cuda.synchronize()
    _assert_flash_matches_plain(got, ref, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,group,seq", [(64, 1, 257), (128, 4, 300), (128, 8, 1024),
                                               (256, 2, 1024)])
def test_flash_forward_is_deterministic(cuda, head_dim, group, seq):
    """K1 launched twice on one input gives bit-identical O and LSE."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    case = _flash_case(torch.bfloat16, head_dim, group, seq=seq)
    assert bench_flash.forward_twice_identical(case)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,group,seq", [(64, 1, 257), (128, 4, 300), (128, 8, 1024),
                                               (256, 2, 1024)])
def test_flash_backward_is_deterministic(cuda, head_dim, group, seq):
    """K2 and K3 launched twice on one input give bit-identical dq, dk, dv:
    every block sums its own rows in a fixed order, no atomics."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    case = _flash_case(torch.bfloat16, head_dim, group, seq=seq)
    assert bench_flash.backward_twice_identical(case)


@pytest.mark.cuda
def test_fused_cross_entropy_bf16_on_the_card(cuda):
    """The bf16 head product on the card gives fp32 logits from its fp32
    accumulator: the loss agrees with the fp32 product of the same bf16
    values to fp32 rounding. Hidden and weight get bf16 gradients under the
    chunks' checkpoints, within two bf16 steps of max|ref|: the backward
    rounds the logits' gradient and its two products to bf16, and weight's
    gradient is summed over the three chunks in bf16."""
    from llm_training_tpu_torch.ops import cross_entropy as ce

    gen = torch.Generator(device=cuda).manual_seed(0)
    hidden = torch.randn((96, 64), generator=gen, device=cuda).bfloat16()
    weight = (0.5 * torch.randn((64, 512), generator=gen, device=cuda)).bfloat16()
    labels = torch.randint(0, 512, (96,), generator=gen, device=cuda)
    results = []
    for upcast in (False, True):
        h = (hidden.float() if upcast else hidden).clone().requires_grad_()
        w = (weight.float() if upcast else weight).clone().requires_grad_()
        total, count = ce.fused_linear_cross_entropy(h, w, labels, chunk_size=32)
        total.backward()
        results.append((total.detach(), h.grad, w.grad))
    (loss, dh, dw), (loss32, dh32, dw32) = results
    assert int(count) == 96 and dh.dtype == dw.dtype == torch.bfloat16
    torch.testing.assert_close(loss, loss32, rtol=1e-5, atol=0)
    for got, ref in ((dh, dh32), (dw, dw32)):
        assert float((got.float() - ref).abs().max()) <= 2 * 2.0**-8 * float(ref.abs().max())


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_it_cannot_take(cuda):
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    q = torch.zeros((1, 64, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head_dim 320.*ROADMAP B"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,minval,maxval", [
    ((33,), 0.0, 1.0), ((4, 33), -0.3, 0.7), ((3, 5, 17), -2.5e-3, 2.5e-3),
    ((8192, 4096), -8.6e-4, 8.6e-4),  # NEFTune (alpha 5) at the fit's row of 8192 x 4096
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_uniform_kernel_matches_plain_bits(cuda, dtype, shape, minval, maxval):
    """The uniform kernel gives its plain version's bits (which are JAX's,
    `test_torch_prng.py`) in one launch."""
    from llm_training_tpu_torch import prng

    key = prng.fold_in(prng.key(5), 2)
    before = prng.uniform.launches
    got = prng.uniform(key, shape, dtype, minval, maxval, device=cuda)
    assert prng.uniform.launches == before + 1
    want = prng.uniform_torch(key, shape, dtype, minval, maxval, device=cuda)
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    ((4, 6, 8), (slice(2, 4),)),  # a rank's rows: one segment at an offset
    ((4, 6, 8), (slice(0, 2), slice(3, 6))),  # rows and a sequence chunk: strided
    ((8, 4096, 4096), (slice(2, 4), slice(2048, 4096))),  # at 8B widths
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_uniform_kernel_block_matches_plain_bits(cuda, dtype, shape, block):
    """A block of the draw (a mesh rank's NEFTune noise) in one launch: the
    plain version's bits, which are the whole draw's in that block."""
    from llm_training_tpu_torch import prng

    key = prng.fold_in(prng.key(5), 2)
    before = prng.uniform.launches
    got = prng.uniform(key, shape, dtype, -8.6e-4, 8.6e-4, device=cuda, block=block)
    assert prng.uniform.launches == before + 1
    want = prng.uniform_torch(key, shape, dtype, -8.6e-4, 8.6e-4, device=cuda, block=block)
    assert torch.equal(got, want)
    whole = prng.uniform(key, shape, dtype, -8.6e-4, 8.6e-4, device=cuda)
    assert torch.equal(got, whole[block])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(1, 128256), (8, 128256), (3, 1000)])
def test_categorical_kernel_matches_plain(cuda, rows, vocab):
    """Gumbel-perturbed logits in one launch: the same tokens as the plain
    version over 8 keys, the perturbed values within 4 fp32 ulps of the
    larger addend."""
    from llm_training_tpu_torch import prng

    gen = torch.Generator(device=cuda).manual_seed(rows)
    logits = 3 * torch.randn((rows, vocab), generator=gen, device=cuda)
    for call in range(8):
        key = prng.fold_in(prng.key(1), call)
        before = prng.categorical.launches
        got = prng.categorical(key, logits)
        assert prng.categorical.launches == before + 1
        assert torch.equal(got, prng.categorical_torch(key, logits))
    noise = prng.gumbel(key, logits.shape, device=cuda)
    perturbed = torch.empty_like(logits)
    lib = prng._load()
    err = lib.prng_gumbel_logits_launch(key[0], key[1], logits.numel(), logits.data_ptr(),
                                        perturbed.data_ptr(), prng._stream(cuda))
    assert err == 0
    # within 4 ulps of the larger addend (one rounding of the sum moves 1)
    limit = 4 * 2.0**-23 * torch.maximum(noise.abs(), logits.abs())
    assert ((perturbed - (noise + logits)).abs() <= limit).all()


@pytest.mark.cuda
def test_prng_wrappers_reject_what_they_cannot_take(cuda):
    from llm_training_tpu_torch import prng

    with pytest.raises(ValueError, match="float32 logits"):
        prng.categorical(prng.key(0), torch.zeros((2, 5), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.uniform(prng.key(0), (3,), torch.float64, device=cuda)


# ---------------------------------------------------------------- offloaded optimizer state


def _offload_params(device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shapes = {"model.embed_tokens.weight": (512, 256), "lm_head.weight": (512, 256),
              "model.layers.0.mlp.up_proj.weight": (768, 256),
              "model.layers.0.input_layernorm.weight": (256,)}
    return [(n, torch.nn.Parameter(torch.randn(s, generator=gen).to(device)))
            for n, s in shapes.items()]


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,accumulate", [("adamw", 1), ("adamw", 2), ("lion", 1),
                                                  ("adafactor", 2)])
def test_offload_on_the_card_is_placement_only(cuda, optimizer, accumulate, monkeypatch):
    """float32 state in pinned host memory, staged through the copy
    streams in row chunks, updates the parameters bit for bit as the state
    on the card does; the host tensors are pinned; with timing on, the
    split counts every byte moved."""
    from llm_training_tpu_torch.optim import builder
    from llm_training_tpu_torch.optim.builder import OptimConfig, build_optimizer

    monkeypatch.setattr(builder, "_CHUNK", 1 << 14)
    kwargs = {"min_dim_size_to_factor": 8} if optimizer == "adafactor" else {}
    runs = []
    for offload in (False, True):
        named = _offload_params(cuda)
        opt, _ = build_optimizer(OptimConfig(optimizer=optimizer, learning_rate=1e-2,
                                             optimizer_kwargs=kwargs), 10, named,
                                 accumulate=accumulate, offload=offload)
        opt.store.timing = True
        gen = torch.Generator(device="cpu").manual_seed(1)
        for _ in range(3 * accumulate):
            for _, p in named:
                p.grad = torch.randn(p.shape, generator=gen).to(cuda)
            opt.update()
        state = opt.state_dict()
        if offload:
            assert all(t.is_pinned() for k, t in state.items() if k not in ("count", "mini_step"))
            split = opt.store.split
            assert split["bytes_in"] > 0 and split["bytes_in"] == split["bytes_out"]
        runs.append(({n: p.detach().clone() for n, p in named}, state))
    (p0, s0), (p1, s1) = runs
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    for key in s0:
        assert torch.equal(s0[key].cpu(), s1[key].cpu()), key


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sym", "sqrt"])
def test_codec_on_the_card_equals_the_cpu(cuda, kind):
    """The int8 codec's codes and scales on the card equal the CPU's (the
    CPU tests hold the CPU's to JAX's) bit for bit."""
    from llm_training_tpu_torch.optim import quantized_state as tq

    gen = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn((512, 1024), generator=gen)
    x = x if kind == "sym" else x.square() * 10.0 ** torch.empty(512, 1).uniform_(-8, 0,
                                                                                  generator=gen)
    for axis in (0, -1):
        ref = tq.quantize_array(x, kind, 256, axis)
        got = tq.quantize_array(x.to(cuda), kind, 256, axis)
        assert torch.equal(got.q.cpu(), ref.q) and torch.equal(got.scale.cpu(), ref.scale)
        assert torch.equal(tq.dequantize_array(got).cpu(), tq.dequantize_array(ref))


@pytest.mark.cuda
def test_prefetcher_places_batches_on_the_card(cuda):
    """Batches come out on the card, in order, equal to the host arrays."""
    import numpy as np

    from llm_training_tpu_torch.data.prefetch import DevicePrefetcher

    batches = [{"input_ids": np.full((2, 8192), i, dtype=np.int32)} for i in range(5)]
    prefetcher = DevicePrefetcher(iter(batches), cuda, depth=2)
    got = [batch["input_ids"] for batch, _ in prefetcher]
    assert [int(t[0, 0]) for t in got] == list(range(5))
    assert all(t.is_cuda and bool((t == i).all()) for i, t in enumerate(got))


@pytest.mark.cuda
def test_profile_trigger_captures_cuda_kernels(cuda, tmp_path):
    """The serve loop's profile trigger on the card: a `torch.profiler`
    window holding CUDA kernel events, its manifest, no `profile/errors`."""
    import json

    from llm_training_tpu_torch.telemetry.profiling import ProfileTrigger
    from llm_training_tpu_torch.telemetry.registry import TelemetryRegistry

    registry = TelemetryRegistry()
    trigger = ProfileTrigger(run_dir=tmp_path, registry=registry, budget=1, cooldown_s=0.0,
                             window_steps=1, cuda=True)
    assert trigger.request("card")["accepted"]
    trigger.poll(1)
    a = torch.randn(256, 256, device=cuda)
    (a @ a).sum().item()
    trigger.poll(2)
    events = json.loads((tmp_path / "profile-card" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert (tmp_path / "profile-card.json").exists()
    snapshot = registry.snapshot()
    assert snapshot["profile/captures"] == 1.0 and "profile/errors" not in snapshot


@pytest.mark.cuda
def test_engine_sheds_and_decodes_through_the_kernel(cuda):
    """A bounded queue on the card: the queued request ends `overloaded`,
    the admitted one decodes through K4 once a layer a decode step, the
    plain decode path never; the tracer saw the engine's steps."""
    from llm_training_tpu_torch.models.llama.config import LlamaConfig
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops import paged_attention as ops_pa
    from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
    from llm_training_tpu_torch.telemetry import trace

    config = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                         head_dim=64, max_position_embeddings=128, compute_dtype="bfloat16",
                         param_dtype="bfloat16")
    model = Llama(config, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(0))
    engine = ServingEngine(model.eval(), ServeConfig(max_batch=1, max_model_len=64, max_queue=0,
                                                     prefill_chunk=8, eos_token_id=None),
                           device=cuda)
    tracer = trace.TraceRecorder(capacity=1024, sample_every=1, enabled=True)
    previous = trace.set_tracer(tracer)
    plain = [0]
    real = ops_pa._gather_attention

    def gather(q, *args, **kwargs):
        plain[0] += q.shape[1] == 1
        return real(q, *args, **kwargs)

    ops_pa._gather_attention = gather
    before = kernels.paged_decode_attention.launches
    try:
        events = engine.submit("a", [3, 4, 5], max_new_tokens=6)
        events += engine.submit("b", [6, 7], max_new_tokens=6)
        while not engine.scheduler.idle:
            events += engine.step()
    finally:
        ops_pa._gather_attention = real
        trace.set_tracer(previous)
    done = {e["id"]: e["stop_reason"] for e in events if e["type"] == "done"}
    assert done == {"a": "max_tokens", "b": "overloaded"}
    launches = kernels.paged_decode_attention.launches - before
    assert launches == engine.decode_steps * config.num_hidden_layers > 0 and plain[0] == 0
    assert engine.live_stats()["serve/requests_shed"] == 1.0
    assert sum(e["name"] == "engine_step" for e in tracer.snapshot()) == engine.step_index


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,group,seq", [(64, 1, 256), (128, 4, 384)])
@pytest.mark.parametrize("q_offset", [0, 128], ids=["diagonal", "offset"])
def test_flash_forward_fp32_out_rounds_to_its_bf16_out(cuda, head_dim, group, seq, q_offset):
    """K1's fp32 output (the ring's chunk partials) is the accumulator its
    bf16 output rounds: rounded to bf16 it gives the same bits; LSE equal."""
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(head_dim + group)
    q = torch.randn(2, seq, 2 * group, head_dim, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, seq, 2, head_dim, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    seg = torch.ones(2, seq, dtype=torch.int32, device=cuda)
    seg[1, seq // 3:] = 2
    args = (q, k, v, seg, seg, fa.tile_ranges(seg), fa.tile_ranges(seg), None)
    hyper = dict(q_blocks=fa.tile_ranges(seg, fa.BLOCK), causal=q_offset == 0, window=0, cap=0.0,
                 q_offset=q_offset)
    o16, lse16 = fa.flash_fwd_kernel(*args, **hyper)
    o32, lse32 = fa.flash_fwd_kernel(*args, **hyper, out_dtype=torch.float32)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(torch.bfloat16), o16)
    assert torch.equal(lse32, lse16)


@pytest.mark.cuda
@pytest.mark.parametrize("p,window,sinks", [(2, None, False), (4, None, False), (4, 100, True)])
def test_ring_kernels_match_the_ring_of_plain_chunks(cuda, p, window, sinks):
    """The virtual ring through K1-K3 against the ring of plain chunk
    functions in bf16 (limits: `_assert_flash_matches_plain`), S 1024."""
    from llm_training_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device=cuda).manual_seed(p)
    bf = torch.bfloat16
    q = (torch.randn(1, 1024, 8, 128, generator=gen, device=cuda) * 128**-0.5).to(bf)
    k, v = (torch.randn(1, 1024, 2, 128, generator=gen, device=cuda).to(bf) for _ in range(2))
    do = torch.randn(1, 1024, 8, 128, generator=gen, device=cuda).to(bf)
    seg = torch.ones(1, 1024, dtype=torch.int32, device=cuda)
    seg[0, 300:] = 2
    seg[0, -40:] = 0
    s = torch.randn(8, generator=gen, device=cuda) if sinks else None
    runs = {}
    for impl in ("kernel", "torch"):
        o, lse = ra.virtual_ring_forward(q, k, v, seg, p, sinks=s, sliding_window=window, impl=impl)
        dq, dk, dv, _ = ra.virtual_ring_backward(q, k, v, seg, o, lse, do, p, sinks=s,
                                                 sliding_window=window, impl=impl)
        runs[impl] = dict(out=o, lse=lse, dq=dq, dk=dk, dv=dv)
    _assert_flash_matches_plain(runs["kernel"], runs["torch"], {"q_segment_ids": seg}, bf)


# ------------------------------------------------- the grouped GEMM (G1)

GG_LAYOUTS = ("one group", "empty first, middle, last", "ragged (not tile multiples)",
              # the Hopper kernel's edges (`bench_grouped_gemm.edge_layouts`)
              "starts off multiples of 8", "1 row between thousands", "K and N tails (72, 40)",
              "1024 small groups", "one group over five bands")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", GG_LAYOUTS)
@pytest.mark.parametrize("op", ["fwd", "dgrad", "wgrad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_grouped_gemm_matches_plain(cuda, dtype, op, layout):
    """G1's three directions against their plain versions over layouts with
    one group, empty first, middle and last groups, ragged sizes and the
    edge layouts (groups starting off multiples of 8, a 1-row group between
    thousands, K and N tails, 1024 small groups, a group over five bands)
    (the limits of `bench_grouped_gemm.check`: the output's rounding in
    bf16, the order of fp32 sums), two launches bit-equal, and an empty
    group's weight gradient zero."""
    from llm_training_tpu_torch.ops.kernels import bench_grouped_gemm as bench

    sizes, k, n = bench.layouts()[layout]
    err = bench.check(bench.make_case(sizes, k, n, dtype, seed=3), op)
    assert err["ok"], err


@pytest.mark.cuda
def test_grouped_gemm_rejects_what_it_cannot_take(cuda):
    from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg

    x = torch.zeros((6, 12), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((2, 12, 16), dtype=torch.bfloat16, device=cuda)
    offsets = torch.tensor([0, 2, 6], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        gg.grouped_gemm_fwd(x, w, offsets)
    with pytest.raises(ValueError, match="int32"):
        gg.grouped_gemm_fwd(x.float(), w.float(), offsets.long())
    with pytest.raises(ValueError, match="dtypes"):
        gg.grouped_gemm_fwd(x.half(), w.half(), offsets)
    # the bf16 forward's and dgrad's shared prefix holds 2048 groups' tiles
    many = gg.BF16_MAX_GROUPS + 1
    wide = torch.zeros((many, 16, 16), dtype=torch.bfloat16, device=cuda)
    spread = torch.zeros(many + 1, dtype=torch.int32, device=cuda)
    spread[-1] = 6
    with pytest.raises(ValueError, match="at most 2048 groups"):
        gg.grouped_gemm_fwd(torch.zeros((6, 16), dtype=torch.bfloat16, device=cuda), wide, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_moe_model_runs_through_g1(cuda, dtype):
    """A 2-layer MoE Llama (8 experts, 2 a token, a gated shared expert):
    its loss and gradients through G1 (`moe_impl` 'ragged') against the
    exact dense impl on the card (fp32: 1e-4 relative; bf16: within 1.5x of
    the plain bf16 path's distance from fp32 dense), and G1 launched 3
    times a layer forward, 3 dgrad and 3 wgrad."""
    import dataclasses

    from llm_training_tpu_torch.models import moe
    from llm_training_tpu_torch.models.llama.config import LlamaConfig
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg

    fields = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, num_experts=8,
                  num_experts_per_tok=2, moe_intermediate_size=64,
                  shared_expert_intermediate_size=96, initializer_range=0.1,
                  attention_impl="torch", param_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 256, (2, 64), generator=gen, device=cuda)

    def loss_and_grads(config, weights=None, grouped=None):
        model = Llama(config, device=cuda)
        if weights is None:
            model.init_weights(torch.Generator(device=cuda).manual_seed(1))
        else:
            model.load_state_dict(weights)
        real = moe.gg.grouped_gemm
        if grouped is not None:
            moe.gg.grouped_gemm = grouped
        try:
            loss = model(ids).logits.float().logsumexp(-1).mean()
            loss.backward()
        finally:
            moe.gg.grouped_gemm = real
        return model.state_dict(), float(loss), {n: p.grad.float() for n, p in
                                                  model.named_parameters()}

    compute = "float32" if dtype == torch.float32 else "bfloat16"
    base = LlamaConfig(**fields, compute_dtype="float32", moe_impl="dense")
    weights, truth, truth_grads = loss_and_grads(base)
    config = dataclasses.replace(base, compute_dtype=compute, moe_impl="ragged")
    before = [f.launches for f in gg.LAUNCHERS]
    _, loss, grads = loss_and_grads(config, weights)
    torch.cuda.synchronize()
    ran = [f.launches - b for f, b in zip(gg.LAUNCHERS, before)]
    assert ran == [6, 6, 6], ran
    names = [n for n in grads if "experts_" in n or n.endswith("mlp.gate.weight")]
    if dtype == torch.float32:
        assert abs(loss - truth) <= 1e-4 * abs(truth)
        for name in names:
            err = float((grads[name] - truth_grads[name]).norm() / truth_grads[name].norm())
            assert err <= 1e-4, (name, err)
        return
    _, plain_loss, plain_grads = loss_and_grads(config, weights, gg.grouped_gemm_fwd_torch)
    assert abs(loss - truth) <= max(1.5 * abs(plain_loss - truth), 2.0**-8 * abs(truth))
    for name in names:
        err = float((grads[name] - truth_grads[name]).norm())
        plain = float((plain_grads[name] - truth_grads[name]).norm())
        assert err <= 1.5 * plain + 1e-6 * float(truth_grads[name].norm()), (name, err, plain)
