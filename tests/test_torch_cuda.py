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
@pytest.mark.parametrize("head_dim,group,page", [(64, 1, 8), (128, 4, 16), (128, 8, 32)])
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
def test_kernel_rejects_what_it_cannot_take(cuda):
    case = _case(torch.float32, 128, 4, 16, [5, 9], cuda)
    case["q"] = case["q"][:, ::2]  # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        kernels.paged_decode_attention(**case)


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
@pytest.mark.parametrize("head_dim,group", [(64, 1), (128, 4), (128, 8)])
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
@pytest.mark.parametrize("head_dim,group", [(64, 1), (64, 8), (128, 4), (128, 8)])
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
@pytest.mark.parametrize("head_dim,group,seq", [(64, 1, 257), (128, 4, 300), (128, 8, 1024)])
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

    q = torch.zeros((1, 64, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, q, q)
