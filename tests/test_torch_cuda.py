"""Tests of the port that need an NVIDIA card: the CUDA kernel has no CPU
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
