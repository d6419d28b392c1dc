"""Cases, checks, bounds and timing of the grouped GEMM (G1) on the card.

    python -m llm_training_tpu_torch.ops.kernels.bench_grouped_gemm \
        [--timing-only] [--versus OTHER/grouped_gemm.cu] [--shape NAME]

checks the three entry points against their plain versions over the group
layouts `chip_smoke.py` holds them to, then times them at Qwen3-30B-A3B's
training shape (4096 tokens x 8 experts a token over 128 experts, K/N
2048/768, the gate projection, and 768/2048, the down projection; wgrad
also on a draw whose group sizes are rounded to multiples of 8 rows, the
only layout `torch._grouped_mm` takes for it), its decode shape (8 tokens
x 8 over 128, the forward only) and Mixtral-8x7B's (8192 rows over 8
experts, K/N 4096/14336), and prints one JSON line for each shape and
direction: the kernel's time beside its bound, the plain version's and
`torch._grouped_mm`'s (the yardstick; the port never calls it).

`--versus` builds another version of `csrc/grouped_gemm.cu` (a file with
the same `grouped_gemm_launch` entry point, such as an earlier commit's)
into a library of its own, and times it and the tree's kernel in turns in
this process (other, tree, tree, other) through the same wrappers, each
turn with the host's microseconds a call (the enqueue, the tensor maps'
encoding included).
`--shape` times only the shapes whose name contains NAME.

Device time comes from CUDA events around calls enqueued behind a
`torch.cuda._sleep` (`bench_paged_decode.device_ms`), cycling over copies
of the inputs whose bytes exceed the L2 twice, so each call finds them
cold.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from llm_training_tpu_torch.ops.kernels import build
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
        **edge_layouts(),
    }


def edge_layouts() -> dict[str, tuple[list[int], int, int]]:
    """The layouts that probe the Hopper kernel's edges at small widths
    (the CPU tests hold each to JAX's `ragged_dot`): TMA boxes starting at
    rows off a multiple of 8, a 1-row group between groups of thousands,
    K and N that are tails of the 128-column tile and of the 64-deep
    slice, more tiles than 4 x 132 over 1024 small groups, and one group
    over five bands of 8 row tiles. The two layouts of over 4096 rows
    take 256-column tiles where the output is that wide (fwd and wgrad of
    the first, dgrad of the second), with a tail of 40."""
    small = np.random.default_rng(5).integers(0, 6, 1024).tolist()
    return {
        "starts off multiples of 8": ([3, 5, 13, 250, 7, 1, 130, 9], 64, 48),
        "1 row between thousands": ([3000, 1, 4000], 200, 296),
        "K and N tails (72, 40)": ([100, 37, 0, 200], 72, 40),
        "1024 small groups": (small, 64, 128),
        "one group over five bands": ([40, 4100, 90], 296, 72),
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


def versus_library(source: str) -> ctypes.CDLL:
    """Another version of the kernel's source, built alone (the tree's
    flags) into a library of its own beside the tree's, its entry point
    declared as the tree's is."""
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes() + " ".join(build.COMPILE_FLAGS).encode())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"versus_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        out = subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-I", str(src.parent),
                              "-I", str(build.CSRC), "-o", str(path), str(src)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(path))
    lib.grouped_gemm_launch.argtypes = gg._load().grouped_gemm_launch.argtypes
    lib.grouped_gemm_launch.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def launching(lib: ctypes.CDLL | None):
    """The wrappers launch `lib`'s kernel inside (the tree's when None)."""
    real = gg._load
    if lib is not None:
        gg._load = lambda: lib
    try:
        yield
    finally:
        gg._load = real


def host_us(fn, reps: int = 200) -> float:
    """The host's microseconds a call (the enqueue: the wrapper's checks,
    the output's allocation, the launch function), the stream left to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / reps


def time_case(sizes: list[int], k: int, n: int, op: str, dtype=torch.bfloat16,
              reps: int = 20, versus: ctypes.CDLL | None = None) -> dict:
    """Kernel, plain version and `torch._grouped_mm` at one shape and
    direction, cold L2, beside the bound; with `versus`, that library's
    kernel and the tree's in turns (other, tree, tree, other)."""
    first = make_case(sizes, k, n, dtype, seed=0)
    elem = first["x"].element_size()
    copies = max(2, math.ceil(2 * L2_BYTES / work(sizes, k, n, op, elem)[1]) + 1)
    cases = [first] + [make_case(sizes, k, n, dtype, seed=s) for s in range(1, copies)]
    err = check(first, op)
    kernel_calls = [lambda c=c: run(c, op, True) for c in cases]
    turns = {}
    if versus is not None:
        with launching(versus):
            versus_err = check(first, op)
        for name in ("versus", "tree", "tree", "versus"):
            with launching(versus if name == "versus" else None):
                turns.setdefault(name, []).append(device_ms(kernel_calls, reps=reps))
                turns.setdefault(f"{name}_host_us", []).append(host_us(kernel_calls[0]))
        turns["versus_ok"] = versus_err["ok"]
    ms = turns["tree"][-1] if turns else device_ms(kernel_calls, reps=reps)
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
                library_note=why, share_of_bound=bound / ms, turns=turns)


def round_to_8(sizes: list[int]) -> list[int]:
    """The same draw with each group's rows rounded to a multiple of 8."""
    return [8 * round(size / 8) for size in sizes]


def timed_shapes() -> dict[str, tuple[list[int], int, int, tuple[str, ...]]]:
    """name -> (rows a group, K, N, directions) of the timed shapes."""
    training = routed_sizes(4096, 8, 128, seed=2, skew=0.5)
    return {
        "qwen3-30b-a3b training": (training, 2048, 768, OPS),
        "qwen3-30b-a3b training, sizes rounded to 8": (round_to_8(training), 2048, 768,
                                                        ("wgrad",)),
        "qwen3-30b-a3b training down projection": (training, 768, 2048, OPS),
        "qwen3-30b-a3b decode": (routed_sizes(8, 8, 128, seed=1), 2048, 768, ("fwd",)),
        "mixtral-8x7b": (routed_sizes(4096, 2, 8, seed=4, skew=0.5), 4096, 14336, OPS),
    }


def family_shapes() -> dict[str, tuple[list[int], int, int]]:
    """name -> (rows a group, K, N) of the non-Llama MoE families' expert
    products at their published widths, 1024 tokens routed: gpt-oss-20b's
    fused gate_up (N 5760) and down (N 2880: 22.5 of the 128-column
    tiles), DeepSeek-V2-Lite's and GLM-4.5-Air's 1408-wide experts (11
    tiles of 128), ERNIE-4.5-21B-A3B's 1536 and Hunyuan-A13B's 3072, each
    up and down."""
    shapes = {}
    for name, (hidden, inter, experts, top_k, fused) in {
            "gpt-oss-20b": (2880, 2880, 32, 4, True),
            "deepseek-v2-lite": (2048, 1408, 64, 6, False),
            "glm-4.5-air": (4096, 1408, 128, 8, False),
            "ernie-4.5-21b-a3b": (2560, 1536, 64, 6, False),
            "hunyuan-a13b": (4096, 3072, 64, 8, False)}.items():
        sizes = routed_sizes(1024, top_k, experts, seed=24, skew=0.5)
        shapes[f"{name} {'gate_up' if fused else 'gate'}"] = (
            sizes, hidden, 2 * inter if fused else inter)
        shapes[f"{name} down"] = (sizes, inter, hidden)
    return shapes


def gpt_oss_training_shapes() -> dict[str, tuple[list[int], int, int, tuple[str, ...]]]:
    """name -> (rows a group, K, N, directions) of gpt-oss-20b's expert
    products on one packed 8192-token row (4 of 32 experts a token)."""
    sizes = routed_sizes(8192, 4, 32, seed=24, skew=0.5)
    return {"gpt-oss-20b training gate_up": (sizes, 2880, 5760, OPS),
            "gpt-oss-20b training down": (sizes, 2880, 2880, OPS)}


def qwen3_next_training_shapes() -> dict[str, tuple[list[int], int, int, tuple[str, ...]]]:
    """name -> (rows a group, K, N, directions) of Qwen3-Next-80B-A3B's
    expert products on one packed 8192-token row (10 of 512 experts a
    token): the gate projection (up's is the same product) and down."""
    sizes = routed_sizes(8192, 10, 512, seed=25, skew=0.5)
    return {"qwen3-next-80b-a3b training gate": (sizes, 2048, 512, OPS),
            "qwen3-next-80b-a3b training down": (sizes, 512, 2048, OPS)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_grouped_gemm needs a CUDA card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    versus = versus_library(argv[argv.index("--versus") + 1]) if "--versus" in argv else None
    for name, (sizes, k, n) in ({} if "--timing-only" in argv else layouts()).items():
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(sizes, k, n, dtype, seed=7)
            for op in OPS:
                print(json.dumps({"card": card, "layout": name, "dtype": str(dtype), "op": op,
                                  **check(case, op)}), flush=True)
            del case
    only = argv[argv.index("--shape") + 1] if "--shape" in argv else ""
    for name, (sizes, k, n, ops) in timed_shapes().items():
        if only not in name:
            continue
        for op in ops:
            row = time_case(sizes, k, n, op, versus=versus)
            print(json.dumps({"card": card, "shape": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
