"""Cases, checks, bounds and timing of the flash kernels on the card.

    python -m llm_training_tpu_torch.ops.kernels.bench_flash

times K1 (forward) and K2 + K3 (backward) at the training shape of
Llama-3.1-8B (B 1, S 8192, Hq 32, Hkv 8, D 128, bf16, one row packed from
documents of 256-4096 tokens with a padding tail), at S 2048, and at
Phi-3-mini's DPO shape (B 8, S 2048, Hq = Hkv = 32, D 96 padded to 128 by
the wrapper, window 2047), and prints one JSON line for each.
`chip_smoke.py` uses the same helpers for its parity and timing phases.

Device time comes from CUDA events around calls enqueued behind a
`torch.cuda._sleep` (`bench_paged_decode.device_ms`), over several copies
of the inputs so each call finds them cold in L2.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from llm_training_tpu_torch.data.pre_training.packing import best_fit_bin_packing_py
from llm_training_tpu_torch.ops.kernels import flash_attention as fa
from llm_training_tpu_torch.ops.kernels.bench_paged_decode import (
    HBM_BYTES_PER_S,
    L2_BYTES,
    PHI3_WINDOW,
    card_line,
    device_ms,
)

# H100 SXM data sheet: dense bf16 tensor-core rate (the timed shapes are bf16)
BF16_FLOPS_PER_S = 989e12
# flops per visible (q, k) pair per q head per unit of head_dim
FLOPS_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8}


def packed_row(rng: np.random.Generator, seq: int, min_doc: int, max_doc: int,
               tail: int) -> np.ndarray:
    """Segment ids of one packed row: seeded documents best-fit-decreasing
    packed into rows of `seq - tail` tokens; of those rows, the one with
    the median number of documents (ids 1..N in order), then its padding."""
    lengths = sorted(rng.integers(min_doc, max_doc + 1, size=8 * seq // min_doc).tolist(),
                     reverse=True)
    groups = best_fit_bin_packing_py(seq - tail, lengths)
    group = sorted(groups, key=len)[len(groups) // 2]
    row = np.zeros(seq, np.int32)
    pos = 0
    for doc, index in enumerate(group, start=1):
        row[pos:pos + lengths[index]] = doc
        pos += lengths[index]
    return row


def layout(name: str, seq: int, rng: np.random.Generator) -> np.ndarray:
    """Segment ids `[seq]` for the parity layouts. Each ends in padding, so
    every case has fully masked rows."""
    row = np.zeros(seq, np.int32)
    if name == "one_doc":
        row[:seq - 3] = 1
    elif name == "packed":
        # a 64-aligned boundary, then unaligned ones
        cuts = [64, 192, 192 + 37, 192 + 37 + int(rng.integers(20, 60))]
        bounds = [0, *[c for c in cuts if c < seq - 5], seq - 5]
        for doc, (lo, hi) in enumerate(zip(bounds, bounds[1:]), start=1):
            row[lo:hi] = doc
    elif name == "padding_tail":
        row[:seq // 2] = 1
    else:
        raise ValueError(name)
    return row


def flash_case(seq, hq, hkv, head_dim, dtype, seg_rows, seed, q_len=None) -> dict:
    """Inputs of one attention call on the card (q already scaled): `q_len`
    < `seq` makes q the last `q_len` rows of the kv sequence (a chunk at
    q_offset = seq - q_len)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_len = seq if q_len is None else q_len
    batch = len(seg_rows)
    seg = torch.as_tensor(np.stack(seg_rows), device="cuda")

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    return dict(
        q=randn(batch, q_len, hq, head_dim, scale=head_dim**-0.5),
        k=randn(batch, seq, hkv, head_dim), v=randn(batch, seq, hkv, head_dim),
        segment_ids=seg, q_segment_ids=seg[:, seq - q_len:].contiguous(),
        q_offset=seq - q_len, dout=randn(batch, q_len, hq, head_dim),
    )


def flat_inputs(case: dict) -> dict:
    """The kernels' own inputs: sequences padded to the 128-row block."""
    padded = fa.pad_inputs(case["q"], case["k"], case["v"], case["q_segment_ids"],
                           case["segment_ids"])
    return dict(zip(("q", "k", "v", "seg_q", "seg_kv"), padded))


def run_case(case: dict, *, kernel: bool, upcast: bool = False, **opts) -> dict:
    """O, LSE and the gradients (q, k, v, sinks) of one case, through the
    kernels or through the plain version (optionally in fp32 on the same
    values). `opts`: causal, sliding_window, logits_soft_cap, sinks."""
    cast = (lambda t: t.float()) if upcast else (lambda t: t)
    leaves = {n: cast(case[n]).detach().requires_grad_() for n in ("q", "k", "v")}
    sinks = opts.pop("sinks", None)
    if sinks is not None:
        leaves["sinks"] = sinks.detach().clone().requires_grad_()
    fn = fa.flash_attention if kernel else fa.flash_attention_torch
    out = fn(
        leaves["q"], leaves["k"], leaves["v"], segment_ids=case["segment_ids"],
        q_segment_ids=case["q_segment_ids"], scale=1.0, q_offset=case["q_offset"],
        sinks=leaves.get("sinks"), **opts,
    )
    out.backward(cast(case["dout"]))
    flat = flat_inputs({**case, **{n: cast(case[n]) for n in ("q", "k", "v")}})
    window = opts.get("sliding_window") or 0
    cap = opts.get("logits_soft_cap") or 0.0
    hyper = dict(causal=opts.get("causal", True), window=window, cap=cap,
                 q_offset=case["q_offset"])
    sinks32 = None if sinks is None else sinks.float()
    with torch.no_grad():
        if kernel:
            _, lse = fa.flash_fwd_kernel(
                **flat, q_ranges=fa.tile_ranges(flat["seg_q"]),
                k_ranges=fa.tile_ranges(flat["seg_kv"]), sinks=sinks32,
                q_blocks=fa.tile_ranges(flat["seg_q"], fa.BLOCK), **hyper,
            )
        else:
            _, lse = fa.flash_fwd_torch(**flat, sinks=sinks32, **hyper)
    result = {"out": out.detach(), "lse": lse[:, :, :case["q"].shape[1]]}
    result.update({f"d{n}": t.grad for n, t in leaves.items()})
    return result


def kv_head_slice(case: dict, h: int) -> dict:
    """The part of a case that kv head `h` and its q heads see (the heads
    of attention are independent, so the plain version can run one kv head
    at a time and hold S^2 scores for one group only)."""
    group = case["q"].shape[2] // case["k"].shape[2]
    q_heads = slice(h * group, (h + 1) * group)
    return {**case, "q": case["q"][:, :, q_heads].contiguous(),
            "k": case["k"][:, :, h:h + 1].contiguous(), "v": case["v"][:, :, h:h + 1].contiguous(),
            "dout": case["dout"][:, :, q_heads].contiguous()}


def run_plain_by_kv_head(case: dict, upcast: bool = False, **opts) -> dict:
    """`run_case(kernel=False)` one kv head at a time, joined: the plain
    version at the training shape, where its S^2 scores for all heads at
    once would not fit."""
    parts = [run_case(kv_head_slice(case, h), kernel=False, upcast=upcast, **dict(opts))
             for h in range(case["k"].shape[2])]
    head_dim = {"out": 2, "lse": 1, "dq": 2, "dk": 2, "dv": 2}
    return {name: torch.cat([p[name] for p in parts], head_dim[name]) for name in parts[0]}


def visible_pairs(seg_q, seg_kv, *, causal=True, window=None, q_offset=0) -> int:
    """(q, k) pairs the mask lets through, summed over the batch (per head)."""
    total = 0
    kv_pos = torch.arange(seg_kv.shape[1], device=seg_kv.device)
    for b in range(seg_q.shape[0]):
        for lo in range(0, seg_q.shape[1], 1024):
            rows = seg_q[b, lo:lo + 1024]
            q_pos = torch.arange(lo, lo + rows.shape[0], device=rows.device) + q_offset
            mask = (rows[:, None] == seg_kv[b][None, :]) & (rows[:, None] > 0)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            total += int(mask.sum())
    return total


def bound_ms(kind: str, pairs: int, hq: int, head_dim: int, nbytes: int) -> tuple[float, str]:
    """Least time for one call: the larger of its tensor-core flops over
    the bf16 rate and its bytes (inputs read once, outputs written once)
    over the HBM rate."""
    flops_ms = 1e3 * FLOPS_PER_PAIR[kind] * head_dim * pairs * hq / BF16_FLOPS_PER_S
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return (flops_ms, "operations") if flops_ms >= bytes_ms else (bytes_ms, "bytes")


def io_bytes(flat: dict, kind: str) -> int:
    """Bytes K1 (fwd) or K2/K3 (dq, dkv) must read and write once, for the
    tensors given: the kernels' padded inputs, or a case's own (`case_io`),
    whose head_dim is what the work needs."""
    q, k = flat["q"], flat["k"]
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rows = q.shape[0] * q.shape[2] * q.shape[1] * 4  # one fp32 per q row and head
    segs = 4 * (flat["seg_q"].numel() + flat["seg_kv"].numel())
    if kind == "fwd":  # q, k, v in; out, lse out
        return 2 * qb + 2 * kb + rows + segs
    if kind == "dq":  # q, k, v, dout, lse, delta in; dq out
        return 3 * qb + 2 * kb + 2 * rows + segs
    return 2 * qb + 4 * kb + 2 * rows + segs  # dkv: q, k, v, dout, lse, delta in; dk, dv out


def training_case(seq: int = 8192) -> list[dict]:
    """The training shape: Hq 32, Hkv 8, D 128 (Llama-3.1-8B), one packed
    row of `seq` tokens (documents of 256-4096 tokens, or up to the row, and
    a padding tail), bf16, in enough copies to run cold in L2."""
    hq, hkv, head_dim = 32, 8, 128
    tail = seq // 64
    row = packed_row(np.random.default_rng(0), seq, 256, min(4096, seq - tail), tail=tail)
    per_copy = 2 * seq * (hq + 2 * hkv) * head_dim * 2  # q, k, v and dout
    copies = max(2, math.ceil(2 * L2_BYTES / per_copy) + 1)
    return [flash_case(seq, hq, hkv, head_dim, torch.bfloat16, [row], seed)
            for seed in range(copies)]


def case_io(case: dict) -> dict:
    """A case's own tensors under `io_bytes`' names (no padding)."""
    return dict(q=case["q"], k=case["k"], seg_q=case["q_segment_ids"],
                seg_kv=case["segment_ids"])


def dpo_case(seq: int = 2048, rows: int = 8) -> list[dict]:
    """Phi-3-mini's DPO shape: 8 right-padded rows of one sequence each (a
    prompt and a response, 1/2 to all of `seq` tokens), Hq = Hkv = 32,
    D 96, bf16, in enough copies to run cold in L2."""
    hq, head_dim = 32, 96
    rng = np.random.default_rng(2)
    segs = []
    for _ in range(rows):
        row = np.zeros(seq, np.int32)
        row[:int(rng.integers(seq // 2, seq + 1))] = 1
        segs.append(row)
    per_copy = 2 * rows * seq * 3 * hq * head_dim * 2  # q, k, v and dout
    copies = max(2, math.ceil(2 * L2_BYTES / per_copy) + 1)
    return [flash_case(seq, hq, hq, head_dim, torch.bfloat16, segs, seed)
            for seed in range(copies)]


HYPER = dict(causal=True, window=0, cap=0.0, q_offset=0)  # the timed calls: causal, packed


def kernel_inputs(case: dict, hyper: dict = HYPER) -> tuple[dict, dict, dict]:
    """The direct inputs of K1 and of K2/K3 for a case at q_offset 0: the
    flat padded tensors with their tile ranges; those plus dO, and LSE and
    delta from one run of K1; and the launchers' own 128-row block ranges."""
    flat = flat_inputs(case)
    flat["q_ranges"] = fa.tile_ranges(flat["seg_q"])
    flat["k_ranges"] = fa.tile_ranges(flat["seg_kv"])
    blocks = dict(q_blocks=fa.tile_ranges(flat["seg_q"], fa.BLOCK),
                  k_blocks=fa.tile_ranges(flat["seg_kv"], fa.BLOCK))
    out, lse = fa.flash_fwd_kernel(**flat, sinks=None, q_blocks=blocks["q_blocks"], **hyper)
    dout = fa._pad_to(fa._pad_to(case["dout"], 1, flat["q"].shape[1]), 3,
                      flat["q"].shape[3]).contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return flat, dict(**flat, dout=dout, lse=lse, delta=delta), blocks


def forward_twice_identical(case: dict) -> bool:
    """K1 launched twice on one input: O and LSE must come out with the
    same bits (each block writes its own rows once, in a fixed order)."""
    flat, _, blocks = kernel_inputs(case)
    runs = [fa.flash_fwd_kernel(**flat, sinks=None, q_blocks=blocks["q_blocks"], **HYPER)
            for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def backward_twice_identical(case: dict) -> bool:
    """K2 and K3 launched twice on one input: dq, dk and dv must come out
    with the same bits (each block sums its own rows in a fixed order)."""
    _, bwd, blocks = kernel_inputs(case)
    runs = [(fa.flash_dq_kernel(**bwd, q_blocks=blocks["q_blocks"], **HYPER),
             *fa.flash_dkv_kernel(**bwd, k_blocks=blocks["k_blocks"], **HYPER))
            for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def time_kernels(cases: list[dict], window: int = 0) -> dict:
    """Device ms of K1, K2 and K3 on the cases' flat inputs (causal, with
    the window given)."""
    hyper = {**HYPER, "window": window}
    inputs = [kernel_inputs(c, hyper) for c in cases]
    fwd_ms = device_ms([lambda f=f, r=r: fa.flash_fwd_kernel(**f, sinks=None,
                                                          q_blocks=r["q_blocks"], **hyper)
                        for f, _, r in inputs])
    dq_ms = device_ms([lambda b=b, r=r: fa.flash_dq_kernel(**b, q_blocks=r["q_blocks"], **hyper)
                       for _, b, r in inputs], reps=10)
    dkv_ms = device_ms([lambda b=b, r=r: fa.flash_dkv_kernel(**b, k_blocks=r["k_blocks"], **hyper)
                        for _, b, r in inputs], reps=10)
    return dict(fwd_ms=fwd_ms, dq_ms=dq_ms, dkv_ms=dkv_ms)


def _fwd_bwd_ms(forward, cases: list[dict], reps: int) -> dict:
    """Device ms of `forward(case, q, k, v)` (returning O) and of its
    backward (forward + backward, less the forward) through autograd."""
    leaves = [tuple(c[n].detach().clone().requires_grad_() for n in ("q", "k", "v"))
              for c in cases]
    fwd = device_ms([lambda c=c, l=l: forward(c, *l) for c, l in zip(cases, leaves)], reps=reps)
    both = device_ms([
        lambda c=c, l=l: torch.autograd.grad(forward(c, *l), l, c["dout"])
        for c, l in zip(cases, leaves)
    ], reps=reps)
    return dict(fwd_ms=fwd, bwd_ms=both - fwd)


def time_plain(cases: list[dict], reps: int = 3, window: int = 0) -> dict:
    """The plain versions: K1's (`flash_fwd_torch`, O and LSE) and the
    backward's (autograd through it, dq, dk and dv together), one kv head
    at a time as `run_plain_by_kv_head` runs them."""
    def forward(case, q, k, v):
        group = q.shape[2] // k.shape[2]
        return torch.cat([
            fa.flash_fwd_torch(
                q[:, :, h * group:(h + 1) * group], k[:, :, h:h + 1], v[:, :, h:h + 1],
                case["q_segment_ids"], case["segment_ids"], causal=True, window=window,
                q_offset=case["q_offset"],
            )[0]
            for h in range(k.shape[2])
        ], 2)

    return _fwd_bwd_ms(forward, cases, reps)


def time_sdpa(cases: list[dict], reps: int = 10, window: int = 0) -> dict:
    """The library call that computes the same function:
    `F.scaled_dot_product_attention` with the packed boolean mask and
    `enable_gqa=True` (scale 1: q is pre-scaled), forward and backward.
    A yardstick only; the port never calls it."""
    import torch.nn.functional as F

    from llm_training_tpu_torch.ops.attention import make_attention_mask

    masks = [make_attention_mask(c["q_segment_ids"], c["segment_ids"], c["q"].shape[1],
                                 c["k"].shape[1], causal=True, q_offset=c["q_offset"],
                                 sliding_window=window or None)
             for c in cases]
    by_case = {id(c): m for c, m in zip(cases, masks)}

    def forward(case, q, k, v):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=by_case[id(case)], scale=1.0, enable_gqa=True,
        )
        return out.transpose(1, 2)

    return _fwd_bwd_ms(forward, cases, reps)


def kernel_record(seq: int | None = None, cases: list[dict] | None = None,
                  window: int = 0) -> dict:
    """Times and bounds of K1-K3 on `cases` (default: the training shape
    cut to `seq` tokens), causal with `window`. The bound counts the
    case's own head_dim and bytes: a head_dim the kernels pad (96 to 128)
    shows as the padding's cost."""
    cases = training_case(seq) if cases is None else cases
    case = cases[0]
    pairs = visible_pairs(case["q_segment_ids"], case["segment_ids"], window=window or None)
    times = time_kernels(cases, window)
    batch, seq, hq, head_dim = case["q"].shape
    record = {"card": card_line(), "batch": batch, "seq": seq, "hq": hq,
              "hkv": case["k"].shape[2], "head_dim": head_dim, "window": window,
              "dtype": "bfloat16", "visible_pairs_per_head": pairs}
    for kind in ("fwd", "dq", "dkv"):
        bound, by = bound_ms(kind, pairs, hq, head_dim, io_bytes(case_io(case), kind))
        record.update({f"{kind}_ms": times[f"{kind}_ms"], f"{kind}_bound_ms": bound,
                       f"{kind}_bound_by": by})
    return record


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs a CUDA card")
    for seq in (8192, 2048):
        print(json.dumps(kernel_record(seq)))
    print(json.dumps(kernel_record(cases=dpo_case(), window=PHI3_WINDOW)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
