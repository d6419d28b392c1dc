"""Cases, checks, bounds and timing of the grouped GEMM (G1) on the card.

    python -m llm_training_tpu_torch.ops.kernels.bench_grouped_gemm [--timing-only]

checks the three entry points against their plain versions over the group
layouts `chip_smoke.py` holds them to, then times them at Qwen3-30B-A3B's
training shape (4096 tokens x 8 experts a token over 128 experts, K/N
2048/768, the gate projection), its decode shape (8 tokens x 8 over 128,
the forward only) and Mixtral-8x7B's (8192 rows over 8 experts, K/N
4096/14336), and prints one JSON line for each shape and direction: the
kernel's time beside its bound, the plain version's and
`torch._grouped_mm`'s (the yardstick; the port never calls it).

Device time comes from CUDA events around calls enqueued behind a
`torch.cuda._sleep` (`bench_paged_decode.device_ms`), cycling over copies
of the inputs whose bytes exceed the L2 twice, so each call finds them
cold.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg
from llm_training_tpu_torch.ops.kernels.bench_paged_decode import (
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    L2_BYTES,
    card_line,
    device_ms,
)

BF16_FLOPS_PER_S = 989e12
OPS = ("fwd", "dgrad", "wgrad")
# bf16 against the plain version in fp32 on the same values: the output's
# rounding (2^-8 of each element) and fp32 accumulation in another order
# (1e-5 of the largest element); fp32 against fp32: the order only
BF16_RTOL, FP32_RTOL, SUM_ATOL = 2.0**-8, 1e-5, 1e-5


def routed_sizes(tokens: int, top_k: int, experts: int, seed: int, skew: float = 1.0) -> list[int]:
    """Rows a group when `tokens` tokens each pick `top_k` distinct experts,
    drawn with weights falling as 1 / (rank + 1)^skew (0: uniform)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, experts + 1) ** skew
    p = rng.permutation(p / p.sum())
    picks = np.stack([rng.choice(experts, top_k, replace=False, p=p) for _ in range(tokens)])
    return np.bincount(picks.reshape(-1), minlength=experts).tolist()


def layouts() -> dict[str, tuple[list[int], int, int]]:
    """name -> (rows a group, K, N) of the parity cases: the edge layouts
    at small widths, then the path's own shapes."""
    return {
        "one group": ([300], 64, 48),
        "empty first, middle, last": ([0, 130, 0, 7, 256, 0], 64, 48),
        "ragged (not tile multiples)": ([1, 127, 129, 5, 300, 64, 3], 96, 136),
        "decode (64 rows over 128)": (routed_sizes(8, 8, 128, seed=1), 2048, 768),
        "training (32768 rows over 128)": (routed_sizes(4096, 8, 128, seed=2, skew=0.5),
                                           2048, 768),
        "training down projection": (routed_sizes(4096, 8, 128, seed=2, skew=0.5), 768, 2048),
        # Phi-3.5-MoE's SparseMixer: top-2 over 16 experts of width 6400
        "sparsemixer (1024 rows over 16)": (routed_sizes(512, 2, 16, seed=3), 4096, 6400),
        # the bucketed path: every group its capacity, ceil(4096 x 8 / 128 x 1.25)
        "bucketed (128 x 320)": ([320] * 128, 2048, 768),
    }


def make_case(sizes: list[int], k: int, n: int, dtype: torch.dtype, seed: int,
              device: str = "cuda") -> dict:
    """x [M, K], w [G, K, N], dy [M, N] and the offsets, seeded normals
    scaled so the products are O(1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m, groups = sum(sizes), len(sizes)
    on = dict(device=device, generator=gen)
    return dict(
        sizes=sizes,
        x=torch.randn((m, k), **on).to(dtype),
        w=(torch.randn((groups, k, n), **on) / math.sqrt(k)).to(dtype),
        dy=torch.randn((m, n), **on).to(dtype),
        offsets=torch.tensor([0, *np.cumsum(sizes).tolist()], dtype=torch.int32, device=device),
    )


def run(case: dict, op: str, kernel: bool, upcast: bool = False) -> torch.Tensor:
    """One direction through the kernel's wrapper or the plain version."""
    x, w, dy, offsets = case["x"], case["w"], case["dy"], case["offsets"]
    if upcast:
        x, w, dy = x.float(), w.float(), dy.float()
    if op == "fwd":
        return (gg.grouped_gemm_fwd if kernel else gg.grouped_gemm_fwd_torch)(x, w, offsets)
    if op == "dgrad":
        return (gg.grouped_gemm_dgrad if kernel else gg.grouped_gemm_dgrad_torch)(dy, w, offsets)
    fn = gg.grouped_gemm_wgrad if kernel else gg.grouped_gemm_wgrad_torch
    return fn(x, dy, offsets, w.shape[0])


def check(case: dict, op: str) -> dict:
    """The kernel against the plain version on the same inputs (in their
    dtype, and in fp32 on the same values), and two launches bit-equal.
    Returns the errors and `ok`."""
    got = run(case, op, True)
    again = run(case, op, True)
    plain = run(case, op, False).float()
    ref = run(case, op, False, upcast=True)
    torch.cuda.synchronize()
    got32 = got.float()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else FP32_RTOL
    limit = rtol * ref.abs() + SUM_ATOL * scale
    share = float(((got32 - ref).abs() / limit.clamp_min(1e-30)).max()) if ref.numel() else 0.0
    err = dict(max_abs_err=float((got32 - plain).abs().max()) if ref.numel() else 0.0,
               vs_fp32_share=share, identical=bool(torch.equal(got, again)),
               finite=bool(torch.isfinite(got32).all()))
    empty = [g for g, s in enumerate(case["sizes"]) if s == 0]
    if op == "wgrad" and empty:
        err["empty_groups_zero"] = not bool(got[empty].any())
    err["ok"] = (share <= 1.0 and err["identical"] and err["finite"]
                 and err.get("empty_groups_zero", True))
    return err


def work(sizes: list[int], k: int, n: int, op: str, elem: int) -> tuple[float, int]:
    """(FLOPs, bytes) a call must do: each input read once, each output
    written once; fwd and dgrad read only the groups that have rows."""
    m = sum(sizes)
    touched = sum(1 for s in sizes if s)
    flops = 2.0 * m * k * n
    offsets = 4 * (len(sizes) + 1)
    if op == "fwd":
        nbytes = elem * (m * k + touched * k * n + m * n)
    elif op == "dgrad":
        nbytes = elem * (m * n + touched * k * n + m * k)
    else:
        nbytes = elem * (m * k + m * n + len(sizes) * k * n)
    return flops, nbytes + offsets


def bound_ms(sizes, k, n, op, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of the FLOPs at the
    dtype's peak and the bytes at the HBM rate."""
    elem = 2 if dtype == torch.bfloat16 else 4
    flops, nbytes = work(sizes, k, n, op, elem)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    by_ops, by_bytes = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _library(case: dict, op: str):
    """`torch._grouped_mm` for the same direction, or None where this torch
    lacks it or refuses the layout (with the reason)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    if op == "wgrad" and any(size % 8 for size in case["sizes"]):
        # it asserts on the device (which ends the process's CUDA context)
        # unless each group's rows, its wgrad's contraction, are 16 bytes
        return None, "torch._grouped_mm's wgrad takes group sizes of 8-row multiples only"
    x, w, dy, offsets = case["x"], case["w"], case["dy"], case["offsets"]
    ends = offsets[1:].contiguous()
    # its second operand wants the contraction dim contiguous
    w_cols = w.transpose(1, 2).contiguous().transpose(1, 2)
    calls = {"fwd": lambda: fn(x, w_cols, offs=ends),
             "dgrad": lambda: fn(dy, w.transpose(1, 2), offs=ends),
             "wgrad": lambda: fn(x.t(), dy.t().contiguous().t(), offs=ends)}
    try:
        out = calls[op]()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"{type(e).__name__}: {str(e)[:120]}"
    want = run(case, op, False, upcast=True)
    if out.shape != want.shape:
        return None, f"shape {tuple(out.shape)}"
    return calls[op], None


def time_case(sizes: list[int], k: int, n: int, op: str, dtype=torch.bfloat16,
              reps: int = 20) -> dict:
    """Kernel, plain version and `torch._grouped_mm` at one shape and
    direction, cold L2, beside the bound."""
    first = make_case(sizes, k, n, dtype, seed=0)
    elem = first["x"].element_size()
    copies = max(2, math.ceil(2 * L2_BYTES / work(sizes, k, n, op, elem)[1]) + 1)
    cases = [first] + [make_case(sizes, k, n, dtype, seed=s) for s in range(1, copies)]
    err = check(first, op)
    ms = device_ms([lambda c=c: run(c, op, True) for c in cases], reps=reps)
    plain_ms = device_ms([lambda c=c: run(c, op, False) for c in cases], reps=max(3, reps // 4))
    library, why = _library(first, op)
    library_ms = None
    if library is not None:
        libs = [_library(c, op)[0] for c in cases]
        library_ms = device_ms(libs, reps=reps)
    bound, bound_by = bound_ms(sizes, k, n, op, dtype)
    del cases, first
    torch.cuda.empty_cache()
    return dict(op=op, rows=sum(sizes), groups=len(sizes),
                touched=sum(1 for s in sizes if s), k=k, n=n, dtype=str(dtype).split(".")[-1],
                max_abs_err=err["max_abs_err"], ok=err["ok"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                library_note=why, share_of_bound=bound / ms)


def timed_shapes() -> dict[str, tuple[list[int], int, int, tuple[str, ...]]]:
    """name -> (rows a group, K, N, directions) of the timed shapes."""
    return {
        "qwen3-30b-a3b training": (routed_sizes(4096, 8, 128, seed=2, skew=0.5), 2048, 768, OPS),
        "qwen3-30b-a3b decode": (routed_sizes(8, 8, 128, seed=1), 2048, 768, ("fwd",)),
        "mixtral-8x7b": (routed_sizes(4096, 2, 8, seed=4, skew=0.5), 4096, 14336, OPS),
    }


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_grouped_gemm needs a CUDA card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (sizes, k, n) in ({} if "--timing-only" in argv else layouts()).items():
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(sizes, k, n, dtype, seed=7)
            for op in OPS:
                print(json.dumps({"card": card, "layout": name, "dtype": str(dtype), "op": op,
                                  **check(case, op)}), flush=True)
            del case
    for name, (sizes, k, n, ops) in timed_shapes().items():
        for op in ops:
            print(json.dumps({"card": card, "shape": name, **time_case(sizes, k, n, op)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
