"""Device time of the paged-decode kernel on the card, against its bound.

    python -m llm_training_tpu_torch.ops.kernels.bench_paged_decode

Sweeps the GQA group and the cache length at the serving shape of
Llama-3.1-8B (batch 8, Hkv 8, head_dim 128, page 16, bf16), then the cache
length at Phi-3-mini's (Hkv 32, head_dim 96, group 1, window 2047), and
prints one JSON line per point: the kernel's time per call with a cold L2
(and a hot one at Llama's shape), and the HBM-bytes bound. `chip_smoke.py` times the kernel and its
plain version with the same helpers.

Timing: a `torch.cuda._sleep` holds the stream while the host enqueues all
the calls, so the CUDA events around them see device time only and no
host launch gaps. "Cold" cycles over enough copies of the inputs that
their K/V exceed the 50 MB L2 (a decode step finds each layer's pool
cold); "hot" calls one copy again and again.
"""

from __future__ import annotations

import json
import math
import subprocess
import time
from typing import Callable

import numpy as np
import torch

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2**20


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def decode_case(lengths, page, num_kv_heads, group, head_dim, dtype, seed, width=0) -> dict:
    """q, pools and tables for one decode step on the card: each row gets
    its own shuffled blocks (so the table indirection matters); a length of
    1 on a table of zeros is an idle row on the trash block."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pages = [math.ceil(n / page) for n in lengths]
    width = max(width, *pages)
    num_blocks = 1 + sum(pages)
    order = torch.randperm(num_blocks - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros((len(lengths), width), dtype=torch.int32)
    used = 0
    for row, n in enumerate(pages):
        tables[row, :n] = order[used:used + n]
        used += n
    shape = (num_blocks, page, num_kv_heads, head_dim)
    pool_k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pool_v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((len(lengths), num_kv_heads * group, head_dim), generator=gen, device="cuda")
    return dict(
        q=q.to(dtype), k_pages=pool_k, v_pages=pool_v, block_tables=tables.cuda(),
        lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
    )


PHI3_WINDOW = 2047  # Phi-3-mini-4k's sliding window


def phi3_decode_case(lengths, seed) -> dict:
    """One decode step at Phi-3-mini's serving shape: 32 kv heads of 96
    (MHA), page 16, tables of 256 pages (max_model_len 4096), bf16."""
    return decode_case(lengths, 16, 32, 1, 96, torch.bfloat16, seed, width=256)


def decode_bound_ms(case: dict, window: int | None = None) -> tuple[float, str]:
    """Least time for one call, the larger of two: the bytes it needs over
    the HBM rate (K and V of each row's visible slots -- its last `window`
    of `len`, or all `len` -- the table entries of the pages those slots
    lie in, q and lengths read once, out written once), and its fp32 flops
    (scores and p.V) over the fp32 rate. Slots outside the window and a
    page's slots past `len` are never read, so they are not counted."""
    q, pool = case["q"], case["k_pages"]
    _, page, num_kv_heads, head_dim = pool.shape
    lengths = case["lengths"].tolist()
    starts = [max(n - window, 0) if window else 0 for n in lengths]
    visible = sum(n - start for n, start in zip(lengths, starts))
    table_entries = sum(math.ceil(n / page) - start // page for n, start in zip(lengths, starts))
    nbytes = (
        visible * num_kv_heads * head_dim * 2 * pool.element_size()
        + 2 * q.numel() * q.element_size()
        + table_entries * 4 + len(lengths) * 4
    )
    flops = 4 * visible * q.shape[1] * head_dim
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * flops / FP32_FLOPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= flops_ms else (flops_ms, "operations")


def cold_copies(case: dict) -> int:
    """How many copies of a case's pools together exceed twice the L2."""
    nbytes = 2 * case["k_pages"].numel() * case["k_pages"].element_size()
    return max(2, math.ceil(2 * L2_BYTES / nbytes) + 1)


def device_ms(calls: list[Callable[[], object]], reps: int = 30) -> float:
    """Device time per call, median of 3 runs of `reps` calls cycling over
    `calls`, with the host ahead of the stream (see the module note)."""
    for fn in calls:  # warm-up: builds, caches, allocator
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(2 * host_s * 2e9) + 10_000_000  # twice the enqueue time at <= 2 GHz
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(reps):
            calls[i % len(calls)]()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return float(np.median(runs))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_paged_decode needs a CUDA card")
    from llm_training_tpu_torch.ops.kernels import paged_attention as kernels

    card = card_line()
    rng = np.random.default_rng(0)
    for group in (1, 4, 8):
        for mean_len in (128, 512, 1024, 2048):
            lengths = np.clip(rng.integers(mean_len - 64, mean_len + 65, 8), 1, 2048).tolist()
            make = lambda seed: decode_case(  # noqa: E731
                lengths, 16, 8, group, 128, torch.bfloat16, seed, width=128
            )
            first = make(0)
            copies = [first] + [make(s) for s in range(1, cold_copies(first))]
            call = lambda c: (lambda: kernels.paged_decode_attention(**c))  # noqa: E731
            cold = device_ms([call(c) for c in copies])
            hot = device_ms([call(first)])
            bound_ms, bound_by = decode_bound_ms(first)
            print(json.dumps({
                "card": card, "batch": 8, "kv_heads": 8, "group": group, "head_dim": 128,
                "page": 16, "dtype": "bfloat16", "len_min": min(lengths),
                "len_max": max(lengths), "cold_us": 1e3 * cold, "hot_us": 1e3 * hot,
                "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                "share_of_bound_cold": bound_ms / cold,
            }), flush=True)
            del copies, first
            torch.cuda.empty_cache()
    # Phi-3-mini's serving shape: MHA, head_dim 96, its 2047-token window
    # over rows past it, tables of a 4096-token max_model_len
    for mean_len in (1024, 2048, 3072):
        lengths = rng.integers(mean_len - 64, mean_len + 65, 8).tolist()
        copies = [phi3_decode_case(lengths, seed) for seed in range(2)]
        copies += [phi3_decode_case(lengths, s) for s in range(2, cold_copies(copies[0]))]
        call = lambda c: (lambda: kernels.paged_decode_attention(  # noqa: E731
            **c, sliding_window=PHI3_WINDOW))
        cold = device_ms([call(c) for c in copies])
        bound_ms, bound_by = decode_bound_ms(copies[0], PHI3_WINDOW)
        print(json.dumps({
            "card": card, "batch": 8, "kv_heads": 32, "group": 1, "head_dim": 96,
            "page": 16, "window": PHI3_WINDOW, "dtype": "bfloat16",
            "len_min": min(lengths), "len_max": max(lengths), "cold_us": 1e3 * cold,
            "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
            "share_of_bound_cold": bound_ms / cold,
        }), flush=True)
        del copies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
