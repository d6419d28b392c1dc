#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from `csrc/` with nvcc;
3. kernel parity: the ragged paged-decode kernel against its plain
   PyTorch version over head_dim x GQA group x window/cap x page size, in
   fp32 and bf16, with ragged lengths (1, a page boundary, ~2000) and an
   idle trash-block row;
4. serving: `ServingEngine` on a full-width, full-depth Llama-3.1-8B in
   bf16 (random weights drawn on the card from a seed) answers 16
   requests, half of them admitted while decode is running; all complete,
   the pool ends leak-free, all logits are finite, and the kernel ran
   once per layer on every decode step;
5. engine-level parity: a 2-layer model of the same width runs one decode
   step from one pool state through the kernel and through the plain path;
6. timing: the kernel against its plain version at the serving shape, in
   bf16 and in fp32, then both timed there (device time from CUDA events,
   cold L2); and the serving metrics of phase 4.

It prints one `{"kernels": [...]}` line, the card's name and power limit,
and as its last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "llm_training_tpu_torch/ops/kernels/csrc/paged_decode.cu"
KERNEL_REPLACES = "llm_training_tpu/ops/pallas/paged_attention.py:48"
FP32_ATOL = 1e-4  # summation order only
# bf16 against the plain version in bf16, which also rounds its
# probabilities to bf16: each row's error over that row's largest |value|
# (at ~1000 tokens a typical |out| is ~0.05, so an absolute limit is loose)
BF16_ROW_RTOL = 1e-2
# bf16 against the plain version in fp32 on the same values: the kernel
# keeps every intermediate in fp32, so only the rounding of its output to
# bf16 (at most 2^-8 of the value) may differ
BF16_VS_FP32_RTOL, BF16_VS_FP32_ATOL = 2.0**-8, 1e-5
# bf16 logits round at 2^-8 of their size: allow eight such steps of the largest
ENGINE_LOGITS_RTOL = 8 * 2.0**-8


class SmokeFailure(RuntimeError):
    pass


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def percentile(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def kernel_vs_plain(kernels, case: dict, **opts) -> dict:
    """The kernel against its plain version on the same inputs and, for
    bf16, against the plain version in fp32 on the same values. Returns
    the errors and whether they are within the limits above."""
    out = kernels.paged_decode_attention(**case, **opts)
    ref = kernels.paged_decode_attention_torch(**case, **opts)
    upcast = {k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}
    ref32 = kernels.paged_decode_attention_torch(**upcast, **opts)
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    err = dict(abs=float(diff.max()), row_rel=0.0, vs_fp32=0.0)
    if case["q"].dtype == torch.float32:
        ok = err["abs"] <= FP32_ATOL
    else:
        rows = diff.flatten(1).amax(1) / ref.abs().flatten(1).amax(1).clamp_min(1e-30)
        # the share of its limit that each element's error uses
        share = (out - ref32).abs() / (BF16_VS_FP32_RTOL * ref32.abs() + BF16_VS_FP32_ATOL)
        err.update(row_rel=float(rows.max()), vs_fp32=float(share.max()))
        ok = err["row_rel"] <= BF16_ROW_RTOL and err["vs_fp32"] <= 1.0
    err["ok"] = ok and bool(torch.isfinite(out).all())
    return err


# ------------------------------------------------------------------ phases


def phase_build(kernels) -> float:
    t0 = time.perf_counter()
    path = kernels.build_library()
    kernels._load()
    seconds = time.perf_counter() - t0
    print(f"build: {path.name} in {seconds:.2f} s")
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")
    return seconds


def phase_kernel_parity(kernels) -> dict[str, float]:
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    worst = {"float32": {}, "bfloat16": {}}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for head_dim in (64, 128):
            for group in (1, 4, 8):
                for window, cap in ((None, None), (100, 5.0)):
                    for page in (16, 32):
                        lengths = [1, page, 3 * page + 5, 2000, 1]
                        case = decode_case(lengths, page, 2, group, head_dim, dtype, n_cases)
                        case["block_tables"][-1] = 0  # the idle row: trash block only
                        err = kernel_vs_plain(
                            kernels, case, sliding_window=window, logits_soft_cap=cap
                        )
                        check(err.pop("ok"), f"kernel parity: {name} D={head_dim} G={group} "
                              f"window={window} cap={cap} page={page}: errors {err}")
                        for key, value in err.items():
                            worst[name][key] = max(worst[name].get(key, 0.0), value)
                        n_cases += 1
    bf16 = worst["bfloat16"]
    print(
        f"kernel parity: {n_cases} cases pass; fp32 max abs err {worst['float32']['abs']:.3e} "
        f"(atol {FP32_ATOL}); bf16 max abs err {bf16['abs']:.3e}, worst row's max err "
        f"over its max |value| {bf16['row_rel']:.3e} (limit {BF16_ROW_RTOL}), vs fp32 plain "
        f"{bf16['vs_fp32']:.3f} of the limit {BF16_VS_FP32_RTOL:.3e} x |value| + "
        f"{BF16_VS_FP32_ATOL}"
    )
    return worst


def phase_serve(kernels, card: str) -> dict:
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

    config = preset("llama-3.1-8b")
    t0 = time.perf_counter()
    model = Llama(config, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: llama-3.1-8b, {n_params} params in bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(
        model,
        ServeConfig(max_batch=8, max_model_len=2048, prefill_chunk=256, block_size=16),
        device="cuda",
    )

    decode_ms, prefill_ms = [], []

    def timed(fn, sink):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            sink.append(1e3 * (time.perf_counter() - t))
            return out
        return run

    engine._run_decode = timed(engine._run_decode, decode_ms)
    engine._run_prefill = timed(engine._run_prefill, prefill_ms)

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(32, 1025, size=16)
    requests = [
        {"id": f"r{i}", "prompt": rng.integers(0, config.vocab_size, n).tolist(),
         "max_new_tokens": 64}
        for i, n in enumerate(prompt_lens)
    ]
    events: list[dict] = []
    late = list(requests[8:])
    kernels.paged_decode_attention.launches = 0
    t_run = time.perf_counter()
    for request in requests[:8]:
        events.extend(engine.submit(**request))
    admitted_mid_decode = 0
    while late or not engine.scheduler.idle:
        if late and engine.decode_steps > 0 and engine.step_index % 8 == 0:
            events.extend(engine.submit(**late.pop(0)))
            admitted_mid_decode += 1
        events.extend(engine.step())
        check(engine.step_index < 20_000, "serve loop did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = kernels.paged_decode_attention.launches

    done = {e["id"]: e for e in events if e["type"] == "done"}
    stats = engine.stats()
    check(len(done) == 16 and all(
        e["stop_reason"] == "max_tokens" and e["n_tokens"] == 64 for e in done.values()
    ), f"serve: not every request completed: {[(k, v['stop_reason']) for k, v in done.items()]}")
    check(engine.peak_running >= 2, f"serve: peak_running {engine.peak_running}")
    check(admitted_mid_decode == 8, "serve: late requests were not submitted mid-decode")
    check(engine.allocator.blocks_in_use == 0, "serve: pool blocks leaked")
    check(engine.logits_finite, "serve: non-finite logits")
    check(
        launches == engine.decode_steps * config.num_hidden_layers and launches > 0,
        f"serve: {launches} kernel launches for {engine.decode_steps} decode steps "
        f"x {config.num_hidden_layers} layers",
    )
    result = dict(
        launches=launches,
        decode_steps=engine.decode_steps,
        prefill_chunks=engine.prefill_chunks,
        tokens=int(stats["serve/tokens_generated"]),
        wall_s=wall,
        tokens_per_s=stats["serve/tokens_generated"] / wall,
        decode_step_ms_p50=percentile(decode_ms, 50),
        prefill_chunk_ms_p50=percentile(prefill_ms, 50),
        ttft_ms_p50=stats["serve/ttft_p50_ms"],
        tpot_ms_p50=stats["serve/tpot_p50_ms"],
        peak_running=engine.peak_running,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print(
        f"serve: 16/16 requests completed ({admitted_mid_decode} admitted mid-decode), "
        f"peak_running {engine.peak_running}, {engine.decode_steps} decode steps, "
        f"{engine.prefill_chunks} prefill chunks, {launches} kernel launches, pool leak-free"
    )
    print(
        f"serve timing [{card}]: decode step p50 {result['decode_step_ms_p50']:.3f} ms, "
        f"prefill chunk (256 tokens) p50 {result['prefill_chunk_ms_p50']:.3f} ms, "
        f"{result['tokens_per_s']:.1f} tokens/s over {wall:.2f} s, "
        f"TTFT p50 {result['ttft_ms_p50']:.1f} ms, TPOT p50 {result['tpot_ms_p50']:.3f} ms, "
        f"peak memory {result['peak_memory_gb']:.2f} GB"
    )
    result.update(profile_decode(engine, card, rng))
    return result


def profile_decode(engine, card: str, rng) -> dict:
    """Pure decode steps of 8 rows at ~512 tokens, after the counted run:
    4 untraced (wall time of each, synchronised), then 4 traced with
    torch.profiler (device-busy time per step by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(8):
        engine.submit(f"p{i}", rng.integers(0, 1000, 512).tolist(), max_new_tokens=16)
    engine.step()  # admits all 8
    while engine.scheduler.next_prefill() is not None:
        engine.step()
    steps = 4
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    wall_ms = percentile(walls, 50)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()

    def device_us(event) -> float:
        return float(getattr(event, "self_device_time_total", 0.0)
                     or getattr(event, "self_cuda_time_total", 0.0))

    # device-side events only: the kernels (operators on the host side
    # also carry their kernels' time, which would count it twice)
    kernels_by_name = sorted(
        (
            (device_us(e), e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0
        ),
        reverse=True,
    )
    busy_ms = sum(t for t, _, _ in kernels_by_name) / 1e3 / steps
    launches = sum(n for _, n, _ in kernels_by_name) / steps
    while not engine.scheduler.idle:
        engine.step()
    check(busy_ms > 0, "profile: the trace shows no device time")
    # a step cannot keep the device busy longer than it lasts: more busy
    # time than wall time means the trace counted some kernels twice
    check(busy_ms <= wall_ms,
          f"profile: device busy {busy_ms:.3f} ms/step exceeds the step wall {wall_ms:.3f} ms")
    top = "; ".join(
        f"{key[:60]} {t / 1e3 / steps:.3f} ms x{n // steps}"
        for t, n, key in kernels_by_name[:6]
    )
    print(f"decode profile [{card}]: device busy {busy_ms:.3f} ms/step in "
          f"{launches:.0f} kernels; untraced step wall p50 {wall_ms:.3f} ms; "
          f"device idle share {100 * (1 - busy_ms / wall_ms):.1f}% of that p50; top: {top}")
    return dict(profile_busy_ms_per_step=busy_ms, profile_kernels_per_step=launches,
                profile_step_wall_ms=wall_ms)


def phase_engine_parity(kernels) -> float:
    """One decode step of a 2-layer full-width model from one pool state,
    through the kernel and through the plain gather path."""
    from llm_training_tpu_torch.models.base import PagedDecodeState
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama

    config = preset("llama-3.1-8b", num_hidden_layers=2)
    model = Llama(config, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(1))
    model.eval()
    lengths = [1023, 17, 1500, 0, 256, 640, 1, 2000]  # 0: an idle slot
    page = 16
    width = 2048 // page
    gen = torch.Generator(device="cuda").manual_seed(2)
    num_blocks = 1 + sum(math.ceil((n + 1) / page) for n in lengths)
    tables = torch.zeros((8, width), dtype=torch.int32)
    used = 1
    for row, n in enumerate(lengths):
        if n:
            need = math.ceil((n + 1) / page)
            tables[row, :need] = torch.arange(used, used + need)
            used += need
    shape = (2, num_blocks, page, config.num_key_value_heads, config.resolved_head_dim)
    pool_k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    pool_v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    tokens = torch.randint(0, config.vocab_size, (8, 1), generator=gen, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    logits = {}
    with torch.no_grad():
        # bf16 through the kernel, bf16 through the plain path, then the
        # plain path with the same weights and cache in fp32 as the truth
        for name, impl in (("kernel", "auto"), ("plain", "torch"), ("fp32", "torch")):
            if name == "fp32":
                weights = model.state_dict()
                model = Llama(
                    preset("llama-3.1-8b", num_hidden_layers=2, compute_dtype="float32",
                           param_dtype="float32"),
                    device="cuda",
                )
                model.load_state_dict(weights)
                del weights
            dtype = next(model.parameters()).dtype
            before = kernels.paged_decode_attention.launches
            state = PagedDecodeState(
                k=pool_k.to(dtype), v=pool_v.to(dtype), block_tables=tables.cuda(),
                lengths=lens,
            )
            out = model(tokens, position_ids=lens[:, None].long(), decode_state=state,
                        paged_impl=impl)
            logits[name] = out.logits.float()
            ran = kernels.paged_decode_attention.launches - before
            check(ran == (2 if impl == "auto" else 0), f"engine parity: {name} ran {ran} kernels")
    torch.cuda.synchronize()
    live = [row for row, n in enumerate(lengths) if n]

    def max_err(a, b):
        return float((logits[a][live] - logits[b][live]).abs().max())

    err = max_err("kernel", "plain")
    kernel_vs_fp32, plain_vs_fp32 = max_err("kernel", "fp32"), max_err("plain", "fp32")
    scale = float(logits["fp32"][live].abs().max())
    check(bool(torch.isfinite(logits["kernel"]).all()), "engine parity: non-finite logits")
    check(err <= ENGINE_LOGITS_RTOL * scale,
          f"engine parity: kernel vs plain logits differ by {err} "
          f"(> {ENGINE_LOGITS_RTOL} x |logits| {scale})")
    check(kernel_vs_fp32 <= 1.5 * plain_vs_fp32,
          f"engine parity: kernel is further from fp32 ({kernel_vs_fp32}) than the "
          f"plain bf16 path ({plain_vs_fp32})")
    print(f"engine parity: 2-layer full-width decode step, bf16 logits max abs err kernel vs "
          f"plain {err:.3e} (tolerance {ENGINE_LOGITS_RTOL} x |logits| {scale:.3f}); vs fp32: "
          f"kernel {kernel_vs_fp32:.3e}, plain {plain_vs_fp32:.3e}")
    del model, pool_k, pool_v
    return err


def phase_timing(kernels, card: str) -> dict:
    """The kernel and its plain version at the serving shape: batch 8, Hq
    32, Hkv 8, D 128, page 16, lengths ~1024, bf16. Device time per call
    with a cold L2, cycling over copies of the inputs."""
    from llm_training_tpu_torch.ops.kernels import bench_paged_decode as bench

    rng = np.random.default_rng(3)
    lengths = rng.integers(960, 1089, size=8).tolist()
    # table width 128: the serving engine's 2048-token rows of 16-token pages
    def make(seed):
        return bench.decode_case(lengths, 16, 8, 4, 128, torch.bfloat16, seed, width=128)

    cases = [make(99)]
    cases += [make(99 + i) for i in range(1, bench.cold_copies(cases[0]))]
    # the serving shape in bf16 (the timed case) and in fp32 on the same values
    err = kernel_vs_plain(kernels, cases[0])
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in cases[0].items()}
    err32 = kernel_vs_plain(kernels, as_fp32)
    check(err.pop("ok") and err32.pop("ok"),
          f"timing shape: kernel vs plain errors bf16 {err}, fp32 {err32}")
    print(
        f"kernel parity at the serving shape: bf16 max abs err {err['abs']:.3e}, worst row "
        f"{err['row_rel']:.3e} of its max |value|, vs fp32 plain {err['vs_fp32']:.3f} of the "
        f"limit; fp32 max abs err {err32['abs']:.3e} (atol {FP32_ATOL})"
    )
    kernel_ms = bench.device_ms([
        (lambda c=c: kernels.paged_decode_attention(**c)) for c in cases
    ])
    plain_ms = bench.device_ms([
        (lambda c=c: kernels.paged_decode_attention_torch(**c)) for c in cases
    ])
    bound_ms, bound_by = bench.decode_bound_ms(cases[0])
    print(
        f"kernel timing [{card}]: paged_decode B8 Hq32 Hkv8 D128 page16 lengths "
        f"{min(lengths)}-{max(lengths)} bf16, cold L2: kernel {1e3 * kernel_ms:.2f} us, "
        f"plain {1e3 * plain_ms:.2f} us, bound {1e3 * bound_ms:.2f} us ({bound_by} at "
        f"{bench.HBM_BYTES_PER_S / 1e12} TB/s), {100 * bound_ms / kernel_ms:.1f}% of bound"
    )
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err["abs"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from llm_training_tpu_torch.ops.kernels import paged_attention as kernels
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import card_line

    card = card_line()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(kernels)
    phase_kernel_parity(kernels)
    serve = phase_serve(kernels, card)
    gc.collect()  # the engine's timing wrappers form a reference cycle
    torch.cuda.empty_cache()
    phase_engine_parity(kernels)
    torch.cuda.empty_cache()
    timing = phase_timing(kernels, card)
    print(f"serve summary [{card}]: " + json.dumps(serve))
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": serve["launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
