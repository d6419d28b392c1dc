#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from `csrc/` with nvcc, one
   process per source, all started together;
3. kernel parity (K4): the ragged paged-decode kernel against its plain
   PyTorch version over head_dim x GQA group x window/cap x page size x
   four row layouts (ragged lengths to 2000, one long row, short rows, 65
   rows), in fp32 and bf16, each with an idle trash-block row; in bf16 the
   split planner reaches 1, an intermediate count and 16 blocks a row;
4. flash parity (K1-K3): the flash forward (O, LSE) and backward (dq, dk,
   dv, d_sinks) kernels against their plain versions over head_dim x GQA
   group x {causal, window, cap, sinks} x {one document, packed, padding
   tail}, in fp32 and bf16, at S 300, and at S 64 and 257 (lengths that
   cross the backward kernels' 128-row block, with a packed boundary at row
   64 inside a block), and as q_offset chunks of 100 and 170 rows (Sq != Skv,
   not block multiples); every case has fully masked rows (O = 0, LSE =
   -inf or the sink, dq = 0); then K1, K2 and K3 launched twice on one
   input give the same bits;
5. serving: `ServingEngine` on a full-width, full-depth Llama-3.1-8B in
   bf16 (random weights drawn on the card from a seed) answers 16
   requests, half of them admitted while decode is running; all complete,
   the pool ends leak-free, all logits are finite, and K4 ran once per
   layer on every decode step;
6. engine-level parity: a 2-layer model of the same width runs one decode
   step from one pool state through K4 and through the plain path;
7. K4 timing at the serving shape (device time from CUDA events, cold L2),
   then at batch 1 (lengths ~1024) and at batch 8 with lengths ~2000;
8. training: the CLM `Trainer` fits a Llama-3.1-8B of 8 layers at full
   width (fp32 params, bf16 compute, selective recompute, AdamW with clip
   and cosine warmup, random weights from seed 0) for 8 optimizer steps of
   2 micro-batches of one packed 8192-token row; losses and grad norms are
   finite and the loss falls, K1 ran once and K2/K3 once per layer per
   micro-step, the plain attention path never; then one traced step;
9. train-step parity: a 2-layer full-width model runs one forward and
   backward on one packed row through the kernels in bf16, the plain path
   in bf16 and the plain path in fp32 (the truth): the kernel path is no
   further from fp32 than the plain bf16 path (within 1.5x);
10. flash timing: K1, K2 and K3 at the training shape, held against the
   plain versions (and K1-K3 twice for identical bits), then timed beside
   their bound, the plain versions and `scaled_dot_product_attention` (the
   yardstick); then the kernels and their bounds at S 2048;
11. random streams: the kernels of `prng.py` (NEFTune's uniform, the
   sampler's Gumbel draw) against their plain versions at the fit's and
   the serving shapes (uniform bits equal, tokens equal), then timed;
12. lifecycle (run after the training phase freed its memory): at
   Llama-3.1-8B widths cut to 2 layers (fp32 params, bf16 compute; the
   fit phase's data, AdamW with clip, cosine/warmup over 4 steps, 2
   micro-batches a step), through the CLI's own builders and commands: an
   uninterrupted 4-step fit; the same run checkpointed (async, every 2
   steps, keeping 1) and stopped after step 2, then resumed by a new
   Trainer to step 4 -- every restored tensor, the counters and the data
   cursor equal the saved ones bit for bit, and steps 3-4 follow the
   uninterrupted losses within 1e-3 relative, K1-K3 launched in both legs;
   then `validate` and `evaluate` from the checkpoint (the same batches:
   `eval/nll_per_token` equals `val_loss` within 1e-6 relative; K1 only),
   `generate` (4 left-padded prompts of 64-512 tokens, 32 new, greedy, bf16
   cache; the prefill's last-column logits against the full forward within
   1e-2 of max |logit| on the same batch and plain attention path, and the
   engine-parity limit through K1) and `serve --config` (the same prompts: every
   request done, the pool empty, K4 launched once per layer per decode
   step; the share of tokens equal to `generate`'s is printed). It prints
   the checkpoint's bytes, the save's blocking and commit seconds, the
   restore's seconds and the decode rate;
13. preference tuning (run after the lifecycle phase freed its memory):
   DPO, then ORPO, each built from a JSON model node by the CLI's
   `instantiate_from_config` and driven by the `Trainer` at Llama-3.1-8B
   widths cut to 8 layers (fp32 params, bf16 compute, selective recompute,
   random weights from seed 0) for 6 steps of 8 synthetic pairs (prompts
   of 64-1024 tokens, responses of 32-1024, pairs over 2048 tokens
   dropped, collated by the port's collator to a multiple of 128), both at
   a peak learning rate of 5e-5 (the examples' 5e-7 and 8e-6 move no bf16
   product in 6 steps). DPO
   (beta 0.1, AdamW with clip, linear schedule with warmup): step 1's loss
   is ln 2 (policy == reference) with reward accuracy 0, the loss falls
   below ln 2, the reference ends bit-equal to its initial weights while
   the policy moved, the optimizer holds 0 bytes for the reference, K1 ran
   4 x layers times a step and K2/K3 2 x layers, the plain path never.
   ORPO (beta 0.1, cosine with warmup): the loss is or_loss + ce_loss,
   finite and falling, K1/K2/K3 2 x layers a step. Each prints step p50,
   tokens/s, peak memory and MFU. Then a parity step on the first batch at
   its width (8 right-padded rows a side): DPO's loss and backward with a
   2-layer full-width policy (the reference plus seeded noise) and
   reference, through the kernels in bf16 (K1 4 x layers, K2/K3 2 x
   layers, the plain path never), the plain path in bf16 and in fp32; the
   per-row log-probs of both models, DPO's per-row logits and policy
   gradients of the kernel path are no further from fp32 than 1.5 x the
   plain bf16 path's, and the loss no further than 1.5 x the plain path's
   row errors of DPO's logits carried through the loss's weights.
14. optimizer (run after the preference phase freed its memory): the CLM
   `Trainer` at Llama-3.1-8B widths (fp32 params, bf16 compute, selective
   recompute, random weights from seed 0) on the fit phase's first two
   packed 8192-token rows in turn, the example's AdamW (cosine, clip 1.0,
   accumulation 1) at the fit phase's peak. First it reads MemAvailable
   and fails if the pinned state would not fit, and times a plain 1 GiB
   pinned copy each way. At 8 layers, 3 steps each: AdamW with its state
   on the card, prefetching 2 batches and 0 (losses equal; the device idle
   share of one traced step of each); AdamW with its state offloaded to
   pinned host memory as float32 (parameters and losses bit-equal to the
   on-card run), bfloat16 and int8 (blocks of 256), within the stated
   limits of the on-card run. Then at full depth (32 layers), 4 steps:
   AdamW with int8 state offloaded, and Adafactor with its state on the
   card; step 1's loss near ln(vocab), the loss on each row lower at its
   second visit. Then Lion at 8 layers. Every run: K1, K2 and K3 once a
   layer a step (128 each at full depth), the plain path never, peak
   memory under the card's; it prints step and update ms, tokens/s, MFU,
   peak memory, pinned host bytes and, offloaded, the update's split
   into copy-in, update and codec, and copy-out (CUDA events) with the
   link's rate beside the plain copy's.
15. telemetry and resilience around `fit` (run after phase 14 freed its
   memory), in three legs. a: the `Trainer` at Llama-3.1-8B widths cut to 8
   layers on phase 14's two packed rows, AdamW on the card, accumulation 1,
   6 steps, once with health on every step, `NanGuard(spike_zscore=6)`,
   `TrainingTimeEstimator`, `JsonlLogger` and a 300 s watchdog, once with
   all of them off: losses and final parameters bit-equal, the health keys
   JAX's set for this layout (`telemetry/health_keys.json`, which the CPU
   tests hold to JAX's), every norm finite, the goodput phases summing to
   the total within 1% of the fit's wall time, `hbm/peak_bytes_in_use`
   equal to `torch.cuda.max_memory_allocated` within 1%, K1-K3 once a
   layer a step, the plain path never; it prints step p50 with and without
   health, the overhead, and the estimator's tokens/s and MFU beside the
   smoke's own. b: the lifecycle's 2-layer full-width model under plain SGD
   (a checkpoint of the parameters only), one committed save at step 2;
   chaos NaN at step 3 and spike at step 4: NanGuard raises, the trainer
   rolls back in-process twice, skips both windows and finishes, its
   losses bit-equal step for step to a clean run configured with the same
   skip windows; with `max_rollbacks` 1 the CLI exits 76. c: the CLI's
   `fit` in processes of its own (three at once, then a relaunch), 2
   layers, 4 steps: SIGTERM at step 2 exits 75 after the emergency save
   and the relaunch resumes bit-equal to the uninterrupted run; a 20 s
   stall against a 15 s watchdog writes a hang dump naming the open phase
   and the main thread's stack while the run completes; a data error at
   batch 2 with `data_retries` 2 counts `data/retries` 1, losses equal.
16. checkpoint durability, `supervise` and the `ckpt` command (run after
   phase 15 freed its memory), on phase 15's 2-layer full-width model under
   SGD (checkpoints of 5.95 GB), 4 steps, saves at 2 and 4 with `verify:
   full`, in three legs. a: in one process, the clean fit commits steps 2
   and 4 with manifests, the mirror (on the same disk) drains and both
   copies verify in full; one flipped byte in the primary step 4 is healed
   from the mirror by a new `Trainer`'s restore, every tensor bit-equal to
   the saved one; with both copies of step 4 rotten the fit falls back to
   step 2, deletes step 4 and re-runs steps 3-4, their losses within 1e-3
   relative of the clean run's (bit-equal where the scatter-add allows);
   each time the ladder's counters are checked. b: `supervise` in processes
   of its own with `LLMT_CHAOS_SIGKILL_STEP=3`: the child dies on SIGKILL,
   the relaunch restores step 2 and exits 0, `supervisor.jsonl` shows
   launch, exit (SIGKILL), restart, launch, exit, complete, and the final
   parameters equal the clean run's; then a forced final save killed inside
   its swap (`LLMT_CHAOS_CKPT_KILL_IN_SWAP`) is promoted from `.stale/` by
   the relaunch, its bytes unchanged. c: `ckpt verify --mode full` exits 0,
   `ls`, `gc --dry-run` and `mirror` run, a flipped byte makes `verify`
   exit 1 naming the step and the file, a missing root exits 2. K1-K3
   launch in leg a's fits. It prints the manifest seconds and hashing rate,
   the mirror, verify, heal and fallback seconds, and each process's wall
   time and restarts.
The allocator runs with expandable segments (set before torch is
imported) for phase 14's full-depth runs.
It prints one `{"kernels": [...]}` line, the card's name and power limit,
and as its last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import os

# phase 14 holds 64 GB of float32 parameters and gradients of the full-depth
# model beside activations and the optimizer's staging buffers: segments
# that grow in place keep the allocator's fragmentation from failing it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import contextlib
import gc
import io
import json
import logging
import math
import shutil
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "llm_training_tpu_torch/ops/kernels/csrc/"
PALLAS = "llm_training_tpu/ops/pallas/"
KERNEL_SOURCE = CSRC + "paged_decode.cu"
KERNEL_REPLACES = PALLAS + "paged_attention.py:48"
# flash kernels: launcher name, source, the Pallas kernel it replaces
FLASH_KERNELS = (
    ("flash_fwd_kernel", CSRC + "flash_fwd.cu", PALLAS + "flash_attention.py:372"),
    ("flash_dq_kernel", CSRC + "flash_bwd.cu", PALLAS + "flash_attention.py:481"),
    ("flash_dkv_kernel", CSRC + "flash_bwd.cu", PALLAS + "flash_attention.py:563"),
)
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
# flash, bf16 O against the fp32 plain version on the same values, per row
# over the row's largest |value|: O's rounding to bf16 (up to 2^-8 of a
# value) plus P's, which the kernel rounds to bf16 before P V as the Pallas
# kernel does
FLASH_OUT_VS_FP32 = 4 * 2.0**-8
# flash, bf16 gradients: the backward takes delta = rowsum(dO * O) from the
# bf16 O, as the Pallas kernels and FlashAttention-2 do, and the plain bf16
# path rounds dP to bf16; two bf16 approximations of one gradient differ
# per element by more than either is off the fp32 truth, so the gradients
# are held per tensor: within 1e-2 x max|ref| of the plain bf16 version
# (d_sinks, a sum of cancelling row terms, against fp32 only) and within
# 4 x 2^-8 x max|ref| of the fp32 plain version. The plain bf16 version's
# own distance from fp32 is printed beside them.
FLASH_GRAD_VS_BF16 = 1e-2
FLASH_GRAD_VS_FP32 = 4 * 2.0**-8
# train-step parity: the kernel path's distance from the fp32 truth over the
# plain bf16 path's
NO_FURTHER = 1.5
TRAIN_LAYERS = 8
TRAIN_SEQ = 8192
# the lifecycle phase: its depth, steps, and where its checkpoints go
LIFE_LAYERS = 2
LIFE_STEPS = 4
LIFE_DIR = ROOT / ".smoke_lifecycle"
LIFE_DEVICE = "cuda"
# the resumed losses against the uninterrupted ones: the embedding's
# backward (a CUDA scatter-add) is not bit-stable from run to run
RESUME_RTOL = 1e-3
# eval NLL against val_loss: the same kernel on the same batches
EVAL_RTOL = 1e-6
# the preference phase: depth, steps, pairs a batch, the longest pair, and
# the collator's padding multiple
PREF_LAYERS = 8
PREF_STEPS = 6
PREF_PAIRS = 8
PREF_MAX_LENGTH = 2048
PREF_MULTIPLE = 128
PREF_DEVICE = "cuda"
PREF_BAND = 512  # token ids a response side draws from
# the peak learning rate of both, raised from the examples' 5e-7 (DPO) and 8e-6
# (ORPO), which suit pretrained weights over 1000 steps: an AdamW step of
# 5e-7 moves a fp32 weight of ~0.02 by 1/240 of a bf16 step (8e-6: 1/15),
# so the bf16 products barely change in 6 steps; DPO's loss then drifts
# above ln 2 on rounding noise and ORPO's does not fall
PREF_PEAK_LR = 5e-5
# the loss against ln 2 at step 1, where the policy is the reference
LN2_RTOL = 1e-4
# the preference parity step: its depth, and the policy's seeded offset from
# the reference (a tenth of the initialiser's std), so that the two differ
PREF_PARITY_LAYERS = 2
PREF_PARITY_NOISE = 0.1
PREF_BETA = 0.1  # the examples' beta, of both objectives
# generate's bf16 prefill logits against the model's full forward on the
# same batch and the same plain attention path, over max |logit|. Against
# the full forward through K1 the limit is ENGINE_LOGITS_RTOL, bf16 kernel
# against plain
PREFILL_RTOL = 1e-2

# the optimizer phase: placement parity, prefetch and Lion at OPT_LAYERS for
# OPT_STEPS steps; AdamW with int8 state offloaded, and Adafactor, at full
# depth for OPT_FULL_STEPS steps; one packed 8192-token row a step
OPT_LAYERS = 8
OPT_STEPS = 3
OPT_FULL_LAYERS = 32
OPT_FULL_STEPS = 4
OPT_BLOCK = 256  # the int8 codec's block (JAX's default)
# rows of the fit phase's data the steps cycle over: step 3 sees step 1's
# row again, so "the loss falls" compares the same row
OPT_ROWS = 2
OPT_DEVICE = "cuda"
# the example's optimizer (config/examples/llama-3.1/llama-3.1-8b_pt.yaml:
# AdamW, cosine to 0.1 of the peak, clip 1.0, accumulation 1); its warmup
# of 10% of the run is 0 steps of 3-4. Its peak of 1e-5 suits pretrained
# weights over 10,000 steps: an AdamW step of 1e-5 moves a fp32 weight of
# ~0.02 by 1/8 of a bf16 step, so the bf16 products barely change in 4
# steps (phase 13 found the same at 8e-6); the peak is the fit phase's
# 3e-4, for Lion too (its first steps move each weight by lr, as AdamW's
# do). Adafactor scales its step by the weights' RMS (~0.02 here), so its
# peak is 1e-2, a step of ~2e-4 a weight
OPT_ADAMW = dict(optimizer="adamw", learning_rate=3e-4, lr_scheduler="cosine",
                 warmup_steps=0, min_lr_ratio=0.1, grad_clip_norm=1.0)
OPT_LION = {**OPT_ADAMW, "optimizer": "lion"}
OPT_ADAFACTOR = {**OPT_ADAMW, "optimizer": "adafactor", "learning_rate": 1e-2}
# step 1's loss against ln(vocab) at random init: logits of a random head
# spread by ~1 nat (phase 13's ORPO started 0.86 above it)
OPT_LN_V_ATOL = 1.5
# bfloat16 and int8 offload against the state on the card after OPT_STEPS
# steps, as the JAX tests hold compressed state against float32 state
# (tests/test_quantized_state.py: one step, within atol 2e-4 and rtol 1e-3).
# The first update reads the zero initial state, which every codec stores
# exactly, so it is the float32 update: the parameters after it, hence the
# losses of steps 1 and 2, are bit-equal to the on-card run's. After that,
# step 3's loss within `loss` relative, and the parameters' distance from
# the on-card run's within `params` of that run's travel from the start
# (Euclidean, all parameters). The bf16 cast rounds mu and nu at 2^-9
# relative: a step's error ~2^-9 of the step. The int8 codec's error is at
# most half a grid step of its block's largest |value| (1/254 of it), and
# the sqrt codec's ceil floors a nu far under its block's largest at the
# grid's first step, which shrinks that element's step: in lm_head, whose
# blocks run along the vocabulary, a block of 256 rows holds ~16 of an
# 8192-token row's tokens, and the other rows' gradients are tiny. The
# int8 limits were 1e-3 and 0.1 before the first chip run, from a CPU
# rehearsal at hidden 256 and vocabulary 2,048 (1.3e-2 of the travel),
# where the blocks hold no such sparse rows; that run measured 1.70e-3
# and 0.130 (PERF.md, PR 7)
OFFLOAD_LIMITS = {"bfloat16": {"loss": 1e-3, "params": 1e-2},
                  "int8": {"loss": 5e-3, "params": 0.3}}
# phase 15: telemetry and resilience around fit
RES_LAYERS = 8  # leg a: health at phase 14's 8-layer width
RES_STEPS = 6
RES_DIR = ROOT / ".smoke_resilience"
RES_DEVICE = "cuda"
# legs b and c: the lifecycle's 2-layer model; plain SGD keeps a checkpoint to
# the parameters (5.9 GB): AdamW's moments would triple every save and restore
# of these legs at the ~0.7 GB/s the card's disk commits (phase 12 measures it)
RES_SGD = dict(optimizer="sgd", learning_rate=3e-4, lr_scheduler="constant",
               grad_clip_norm=1.0)
# NanGuard of leg b: warm after 2 log steps; only the injected x1000 spike
# trips it (z ~ 1e5 at the std floor of 1% of the mean; a natural 10x swing
# of the grad norm scores ~900)
RES_SPIKE_Z = 1000.0
# leg c: the watchdog's timeout above the warm-up step, the injected stall
# above the timeout
RES_WATCHDOG_S = 15.0
RES_STALL_S = 20.0
RES_MAX_DOC = 4096  # the packed rows' longest document (packed_batches' default)
# phase 16: durability, supervise and the ckpt command, on phase 15's 2-layer
# model under SGD (a checkpoint of the parameters, 5.95 GB)
DUR_DIR = ROOT / ".smoke_durability"
DUR_STEPS = 4
DUR_COUNTERS = ("checkpoint/verify_failures", "checkpoint/mirror_restores",
                "resilience/restore_fallbacks")
# the supervised run's final parameters against the clean run's, per tensor
# over its largest |value|, where they are not bit-equal: the embedding's
# backward (a CUDA scatter-add) sums in no fixed order (RESUME_RTOL's
# reason), which moves a 3e-4 SGD step in its last bits
DUR_PARAM_RTOL = 1e-6


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


def phase_build() -> float:
    from llm_training_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    path = build.build_library()
    build.load()
    seconds = time.perf_counter() - t0
    print(f"build: {path.name} in {seconds:.2f} s (nvcc {build.build_info.get('seconds', 0):.2f} s)")
    function = ""
    for line in build.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1][:90]
        if "registers" in line or "spill" in line:
            print(f"build: {function}: {line.strip()}")
    return seconds


def k4_layouts(page: int) -> dict[str, list[int]]:
    """Row lengths of the K4 parity cases (Hkv 2; the last row of each is
    idle: length 1 on the trash block). With 132 SMs the bf16 kernel's
    planner splits `ragged` 13 ways (an intermediate count), `batch1_long`
    16 ways (the largest cluster), and `short` and `many_rows` once."""
    rng = np.random.default_rng(page)
    return {
        "ragged": [1, page, 3 * page + 5, 2000, 1],
        "batch1_long": [1500, 1],
        "short": [1, 9, 40, 63, 1],
        "many_rows": [*rng.integers(1, 700, size=65).tolist(), 1],
    }


def phase_kernel_parity(kernels) -> dict[str, float]:
    from llm_training_tpu_torch.ops.kernels.bench_paged_decode import decode_case

    worst = {"float32": {}, "bfloat16": {}}
    n_cases = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits_seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for head_dim in (64, 128):
            for group in (1, 4, 8):
                for window, cap in ((None, None), (100, 5.0)):
                    for page in (16, 32):
                        for layout, lengths in k4_layouts(page).items():
                            case = decode_case(lengths, page, 2, group, head_dim, dtype, n_cases)
                            case["block_tables"][-1] = 0  # the idle row: trash block only
                            err = kernel_vs_plain(
                                kernels, case, sliding_window=window, logits_soft_cap=cap
                            )
                            check(err.pop("ok"), f"kernel parity: {name} D={head_dim} G={group} "
                                  f"window={window} cap={cap} page={page} {layout}: errors {err}")
                            for key, value in err.items():
                                worst[name][key] = max(worst[name].get(key, 0.0), value)
                            if dtype == torch.bfloat16:  # what the wrapper planned
                                tables = case["block_tables"]
                                splits_seen.add(kernels.plan_splits(
                                    tables.shape[1] * page, 2 * len(lengths), sms))
                            n_cases += 1
    check({1, kernels.MAX_SPLITS} <= splits_seen and len(splits_seen) >= 3,
          f"kernel parity: the bf16 cases split {sorted(splits_seen)} ways; they must reach 1, "
          f"an intermediate count and {kernels.MAX_SPLITS}")
    bf16 = worst["bfloat16"]
    print(
        f"kernel parity: {n_cases} cases pass (D 64/128 x G 1/4/8 x window 100 + cap 5 or "
        f"neither x page 16/32 x {'/'.join(k4_layouts(16))}; bf16 split "
        f"{sorted(splits_seen)} ways); fp32 max abs err {worst['float32']['abs']:.3e} "
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


def device_profile(step, steps: int) -> tuple[float, float, list]:
    """`steps` calls of `step()` traced with torch.profiler: device-busy ms
    per call, kernels per call, and (us, count, name) by kernel. Only
    device-side events count (operators on the host side also carry their
    kernels' time, which would count it twice)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    def device_us(event) -> float:
        return float(getattr(event, "self_device_time_total", 0.0)
                     or getattr(event, "self_cuda_time_total", 0.0))

    kernels_by_name = sorted(
        (
            (device_us(e), e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0
        ),
        reverse=True,
    )
    busy_ms = sum(t for t, _, _ in kernels_by_name) / 1e3 / steps
    launches = sum(n for _, n, _ in kernels_by_name) / steps
    return busy_ms, launches, kernels_by_name


def check_busy(name: str, busy_ms: float, wall_ms: float) -> None:
    check(busy_ms > 0, f"{name}: the trace shows no device time")
    # a step cannot keep the device busy longer than it lasts: more busy
    # time than wall time means the trace counted some kernels twice
    check(busy_ms <= wall_ms,
          f"{name}: device busy {busy_ms:.3f} ms/step exceeds the step wall {wall_ms:.3f} ms")


def top_kernels(kernels_by_name: list, steps: int, n: int = 6) -> str:
    return "; ".join(
        f"{key[:60]} {t / 1e3 / steps:.3f} ms x{n_calls // steps}"
        for t, n_calls, key in kernels_by_name[:n]
    )


def profile_decode(engine, card: str, rng) -> dict:
    """Pure decode steps of 8 rows at ~512 tokens, after the counted run:
    4 untraced (wall time of each, synchronised), then 4 traced with
    torch.profiler (device-busy time per step by kernel)."""
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
    busy_ms, launches, kernels_by_name = device_profile(engine.step, steps)
    while not engine.scheduler.idle:
        engine.step()
    check_busy("decode profile", busy_ms, wall_ms)
    print(f"decode profile [{card}]: device busy {busy_ms:.3f} ms/step in "
          f"{launches:.0f} kernels; untraced step wall p50 {wall_ms:.3f} ms; "
          f"device idle share {100 * (1 - busy_ms / wall_ms):.1f}% of that p50; "
          f"top: {top_kernels(kernels_by_name, steps)}")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(
        f"kernel timing [{card}]: paged_decode B8 Hq32 Hkv8 D128 page16 lengths "
        f"{min(lengths)}-{max(lengths)} bf16 ({kernels.plan_splits(128 * 16, 64, sms)} "
        f"splits), cold L2: kernel {1e3 * kernel_ms:.2f} us, "
        f"plain {1e3 * plain_ms:.2f} us, bound {1e3 * bound_ms:.2f} us ({bound_by} at "
        f"{bench.HBM_BYTES_PER_S / 1e12} TB/s), {100 * bound_ms / kernel_ms:.1f}% of bound"
    )
    del cases
    # batch 1 (a lone request) and batch 8 near the serving max_model_len
    for batch, low, high in ((1, 960, 1089), (8, 1900, 2049)):
        lens = rng.integers(low, high, size=batch).tolist()
        def make_case(seed, lens=lens):
            return bench.decode_case(lens, 16, 8, 4, 128, torch.bfloat16, seed, width=128)

        more = [make_case(0)]
        more += [make_case(seed) for seed in range(1, bench.cold_copies(more[0]))]
        ms = bench.device_ms([
            (lambda c=c: kernels.paged_decode_attention(**c)) for c in more
        ])
        bound, _ = bench.decode_bound_ms(more[0])
        print(f"kernel timing [{card}]: paged_decode B{batch} lengths {min(lens)}-{max(lens)} "
              f"({kernels.plan_splits(128 * 16, 8 * batch, sms)} splits), cold L2: kernel "
              f"{1e3 * ms:.2f} us, bound {1e3 * bound:.2f} us, {100 * bound / ms:.1f}% of bound")
        del more
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err["abs"])


# ------------------------------------------------------------ flash phases


def _max_rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """max |a - r| over max |r|, on the entries where r is finite."""
    finite = torch.isfinite(r)
    a, r = a[finite].float(), r[finite].float()
    return float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)


def _row_rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """The worst row's max |a - r| over that row's max |r| (last dim)."""
    a, r = a.float().flatten(0, -2), r.float().flatten(0, -2)
    diff = (a - r).abs().amax(-1)
    scale = r.abs().amax(-1)
    # a row whose reference is all zero must be all zero
    return float(torch.where(scale > 0, diff / scale.clamp_min(1e-30), diff * 1e30).max())


def flash_case_errors(got: dict, ref: dict, ref32: dict | None, case: dict,
                      sinks: torch.Tensor | None) -> tuple[dict, list[str]]:
    """Errors of one flash case against the limits of the module header;
    returns (errors by name, the limits it broke)."""
    errors, broken = {}, []
    finite = torch.isfinite(ref["lse"])
    if not torch.equal(torch.isfinite(got["lse"]), finite):
        broken.append("LSE is -inf on other rows than the plain version's")
    errors["lse"] = _max_rel(got["lse"], ref["lse"])
    if errors["lse"] > FP32_ATOL:
        broken.append(f"lse {errors['lse']:.3e}")
    padding = case["q_segment_ids"] == 0  # [B, Sq]: fully masked q rows
    if not bool((got["out"][padding] == 0).all() and (got["dq"][padding] == 0).all()):
        broken.append("a fully masked row has O or dq != 0")
    pad_lse = got["lse"].transpose(1, 2)[padding]  # [rows, Hq]
    expect = torch.full_like(pad_lse, -math.inf) if sinks is None else sinks.float().expand_as(pad_lse)
    if not torch.equal(pad_lse, expect):
        broken.append("a fully masked row's LSE is not -inf (or its sink)")
    grads = [n for n in got if n.startswith("d")]
    if ref32 is None:  # fp32
        for name in ["out", *grads]:
            errors[name] = _max_rel(got[name], ref[name])
            if errors[name] > FP32_ATOL:
                broken.append(f"{name} {errors[name]:.3e} > {FP32_ATOL} x max|ref|")
        return errors, broken
    errors["out_row"] = _row_rel(got["out"], ref["out"])
    errors["out_row_vs_fp32"] = _row_rel(got["out"], ref32["out"])
    if errors["out_row"] > BF16_ROW_RTOL:
        broken.append(f"out row {errors['out_row']:.3e} > {BF16_ROW_RTOL}")
    if errors["out_row_vs_fp32"] > FLASH_OUT_VS_FP32:
        broken.append(f"out vs fp32 row {errors['out_row_vs_fp32']:.3e} > {FLASH_OUT_VS_FP32:.3e}")
    for name in grads:
        errors[name] = _max_rel(got[name], ref[name])
        errors[name + "_vs_fp32"] = _max_rel(got[name], ref32[name])
        errors[name + "_plain_vs_fp32"] = _max_rel(ref[name], ref32[name])
        # d_sinks sums row terms that cancel: the plain bf16 version's own
        # error there is above 1e-2, so it is held against fp32 only
        if name != "dsinks" and errors[name] > FLASH_GRAD_VS_BF16:
            broken.append(f"{name} {errors[name]:.3e} > {FLASH_GRAD_VS_BF16} x max|ref|")
        if errors[name + "_vs_fp32"] > FLASH_GRAD_VS_FP32:
            broken.append(f"{name} vs fp32 {errors[name + '_vs_fp32']:.3e} > {FLASH_GRAD_VS_FP32:.3e}")
    return errors, broken


def phase_flash_parity() -> dict:
    from llm_training_tpu_torch.ops.kernels import bench_flash

    worst = {"float32": {}, "bfloat16": {}}
    cases, failures = [], []
    variants = ("causal", "window", "cap", "sinks")
    for dtype in (torch.float32, torch.bfloat16):
        for head_dim in (64, 128):
            for group in (1, 4, 8):
                for variant in variants:
                    # 300 tokens: not a multiple of the tile nor of the block
                    for layout in ("one_doc", "packed", "padding_tail"):
                        cases.append((dtype, head_dim, group, variant, layout, 300, None))
        for variant in variants:  # a chunk at q_offset 200: Sq != Skv
            cases.append((dtype, 128, 4, variant, "packed", 300, 100))
    # after those (a case's number seeds its inputs): lengths that cross the
    # backward kernels' 128-row block
    for dtype in (torch.float32, torch.bfloat16):
        for head_dim in (64, 128):
            for group in (1, 4, 8):
                # half a block, and two blocks and a row; the variants in turn
                for seq in (64, 257):
                    cases.append((dtype, head_dim, group, variants[len(cases) % 4], "packed", seq,
                                  None))
        for variant in variants:  # a chunk at q_offset 130, no block multiple
            cases.append((dtype, 64, 8, variant, "packed", 300, 170))
    for n, (dtype, head_dim, group, variant, layout, seq, q_len) in enumerate(cases):
        rng = np.random.default_rng(n)
        other = "packed" if layout != "packed" else "one_doc"
        case = bench_flash.flash_case(
            seq, 2 * group, 2, head_dim, dtype,
            [bench_flash.layout(layout, seq, rng), bench_flash.layout(other, seq, rng)],
            seed=n, q_len=q_len,
        )
        opts = dict(causal=True)
        sinks = None
        if variant == "window":
            opts["sliding_window"] = 100
        elif variant == "cap":
            opts["logits_soft_cap"] = 30.0
        elif variant == "sinks":
            sinks = torch.randn(2 * group, generator=torch.Generator("cuda").manual_seed(n),
                                device="cuda")
            opts["sinks"] = sinks
        got = bench_flash.run_case(case, kernel=True, **dict(opts))
        ref = bench_flash.run_case(case, kernel=False, **dict(opts))
        ref32 = (bench_flash.run_case(case, kernel=False, upcast=True, **dict(opts))
                 if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        errors, broken = flash_case_errors(got, ref, ref32, case, sinks)
        name = str(dtype).removeprefix("torch.")
        if broken:
            failures.append(f"{name} D={head_dim} G={group} {variant} {layout} S={seq} "
                            f"q_len={q_len or seq}: {broken}")
        for key, value in errors.items():
            worst[name][key] = max(worst[name].get(key, 0.0), value)
    fp32 = ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst["float32"].items()))
    bf16 = ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst["bfloat16"].items()))
    check(not failures, f"flash parity: {len(failures)} of {len(cases)} cases fail: "
                        f"{failures[:6]}; worst fp32 {fp32}; worst bf16 {bf16}")
    # the same bits twice: a packed row with a window, two blocks and a row long
    rng = np.random.default_rng(len(cases))
    twice = bench_flash.flash_case(
        257, 8, 2, 128, torch.bfloat16,
        [bench_flash.layout("packed", 257, rng), bench_flash.layout("one_doc", 257, rng)], seed=1)
    check(bench_flash.forward_twice_identical(twice),
          "flash determinism: K1 gave other bits on a second launch (S 257)")
    check(bench_flash.backward_twice_identical(twice),
          "flash determinism: K2 or K3 gave other bits on a second launch (S 257)")
    print(f"flash parity: {len(cases)} cases pass (D 64/128 x G 1/4/8 x causal/window 100/"
          f"cap 30/sinks x one_doc/packed/padding_tail at S 300; S 64 and 257; q_offset chunks "
          f"of 100 and 170 rows; fully masked rows exact; K1, K2 and K3 twice: identical "
          f"bits); "
          f"fp32 worst error over max|ref| (limit {FP32_ATOL}): {fp32}")
    print(f"flash parity: bf16 worst (out_row limit {BF16_ROW_RTOL}, out_row_vs_fp32 "
          f"{FLASH_OUT_VS_FP32:.3e}, grads {FLASH_GRAD_VS_BF16} / vs fp32 "
          f"{FLASH_GRAD_VS_FP32:.3e} x max|ref|): {bf16}")
    return worst


@contextlib.contextmanager
def count_plain_attention():
    """Count calls of the plain attention path (`_xla_attention` as
    `dot_product_attention` reaches it)."""
    from llm_training_tpu_torch.ops import attention

    real = attention._xla_attention
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    attention._xla_attention = counted
    try:
        yield calls
    finally:
        attention._xla_attention = real


def packed_batches(seed: int, seq: int, rows: int, vocab: int, max_doc: int = 4096) -> list[dict]:
    """Collated batches of one row each: seeded documents of 256..max_doc
    random tokens, best-fit-decreasing packed into `seq - 64` tokens by the
    port's packer, padded to `seq` (segment id 0) by its collator; rows
    spread over the packed set."""
    import types

    from llm_training_tpu_torch.data.pre_training import packing
    from llm_training_tpu_torch.data.pre_training.collator import PreTrainingDataCollator

    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, max_doc + 1, size=rows * 2 * seq // 1024).tolist()
    docs = {"source": ["s"] * len(lengths), "length": lengths,
            "input_ids": [rng.integers(0, vocab, n).tolist() for n in lengths]}
    packed = packing.best_fit_decreasing(docs, seq - 64)
    config = types.SimpleNamespace(
        tokenizer=types.SimpleNamespace(pad_token_id=0, bos_token_id=None), pad_to_multiple_of=seq,
    )
    collate = PreTrainingDataCollator(config)
    n = len(packed["input_ids"])
    return [
        collate([{"input_ids": packed["input_ids"][i], "segment_ids": packed["segment_ids"][i]}])
        for i in (n * (j + 1) // (rows + 1) for j in range(rows))
    ]


def phase_train(card: str) -> dict:
    """The CLM Trainer at Llama-3.1-8B widths, 8 layers (see the header)."""
    from dataclasses import asdict

    from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
    from llm_training_tpu_torch.lms.base import ModelProvider
    from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.optim.builder import OptimConfig
    from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

    config = preset("llama-3.1-8b", num_hidden_layers=TRAIN_LAYERS, param_dtype="float32",
                    compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                    recompute_granularity="selective")
    batches = packed_batches(0, TRAIN_SEQ, 4, config.vocab_size)
    steps, accumulate = 8, 2

    class Repeated(BaseDataModule):
        def setup(self):
            pass

        def train_batches(self, start_step=0):
            for i in range(start_step, 10**9):
                yield batches[i % len(batches)]

    class StepClock:
        def __init__(self):
            self.step_s, self.losses, self.grad_norms, self.t = [], [], [], None

        def on_fit_start(self, trainer, *args):
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_train_step(self, trainer, step):
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.step_s.append(now - self.t)
            self.t = now

        def on_step_end(self, trainer, step, metrics):
            self.losses.append(metrics["loss"])
            self.grad_norms.append(metrics["grad_norm"])

    clock = StepClock()
    trainer = Trainer(
        TrainerConfig(max_steps=steps, seed=0, accumulate_grad_batches=accumulate,
                      log_every_n_steps=1),
        callbacks=[clock], device="cuda",
    )
    # the example's AdamW, clip and cosine/warmup, with the schedule cut to 8 steps
    optim = OptimConfig(optimizer="adamw", learning_rate=3e-4, lr_scheduler="cosine",
                        warmup_steps=2, min_lr_ratio=0.1, grad_clip_norm=1.0)
    objective = CLM(CLMConfig(model=ModelProvider("Llama", asdict(config)), optim=optim))
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_plain_attention() as plain:
        for launcher in launchers:
            launcher.launches = 0
        state = trainer.fit(objective, Repeated(BaseDataModuleConfig()))
        torch.cuda.synchronize()
        launches = [launcher.launches for launcher in launchers]
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    micro = steps * accumulate
    check(all(math.isfinite(x) for x in clock.losses + clock.grad_norms),
          f"train: non-finite loss or grad norm: {clock.losses}, {clock.grad_norms}")
    check(len(clock.losses) == steps and clock.losses[-1] < clock.losses[0],
          f"train: the loss did not fall: {clock.losses}")
    expected_k1 = TRAIN_LAYERS * micro  # selective recompute saves K1's outputs
    check(launches == [expected_k1, TRAIN_LAYERS * micro, TRAIN_LAYERS * micro],
          f"train: K1/K2/K3 launched {launches} times; expected {expected_k1} / "
          f"{TRAIN_LAYERS * micro} / {TRAIN_LAYERS * micro} ({TRAIN_LAYERS} layers x {micro} "
          f"micro-steps, selective recompute)")
    check(plain[0] == 0, f"train: the plain attention path ran {plain[0]} times")

    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.model.embed_tokens.weight.numel()
    head_dim, hq = config.resolved_head_dim, config.num_attention_heads
    flops_batch = []
    for batch in batches:
        seg = torch.as_tensor(batch["segment_ids"], device="cuda")
        pairs = bench_flash.visible_pairs(seg, seg)
        tokens = int((batch["segment_ids"] > 0).sum())
        # 6 N per token for the products (N without the input embedding,
        # a lookup), 12 D per visible pair per head per layer for attention
        # (QK^T and PV forward, twice that backward); recompute not counted
        flops_batch.append((tokens, 6 * n_matmul * tokens + 12 * head_dim * hq * TRAIN_LAYERS * pairs))
    timed = clock.step_s[1:]  # step 1 carries the warm-up
    step_ids = range(1, steps)
    tokens = sum(flops_batch[(s * accumulate + m) % 4][0] for s in step_ids for m in range(accumulate))
    flops = sum(flops_batch[(s * accumulate + m) % 4][1] for s in step_ids for m in range(accumulate))
    result = dict(
        layers=TRAIN_LAYERS, params=n_params, seq=TRAIN_SEQ, micro_steps=micro,
        launches=dict(zip(("fwd", "dq", "dkv"), launches)), plain_calls=plain[0],
        losses=clock.losses, grad_norms=clock.grad_norms, wall_s=wall,
        step_ms_p50=1e3 * percentile(timed, 50), step_ms=[1e3 * t for t in clock.step_s],
        tokens_per_s=tokens / sum(timed), mfu=flops / sum(timed) / bench_flash.BF16_FLOPS_PER_S,
        peak_memory_gb=peak_gb,
    )
    print(f"train [{card}]: llama-3.1-8b widths x {TRAIN_LAYERS} layers ({n_params} params, fp32 "
          f"master, bf16 compute, selective recompute), {steps} steps x {accumulate} micro-batches "
          f"of 1 x {TRAIN_SEQ} packed tokens; loss {clock.losses[0]:.4f} -> {clock.losses[-1]:.4f}; "
          f"launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}, plain path 0; "
          f"optimizer step p50 {result['step_ms_p50']:.1f} ms, {result['tokens_per_s']:.0f} "
          f"tokens/s, MFU {100 * result['mfu']:.2f}% of 989 TFLOPS, peak memory {peak_gb:.2f} GB")

    # one more optimizer step twice untraced (wall), then once traced
    def optimizer_step():
        for m in range(accumulate):
            trainer.train_micro_step(objective, state, batches[m])

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        optimizer_step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    wall_ms = percentile(walls, 50)
    busy_ms, kernels, by_name = device_profile(optimizer_step, 1)
    check_busy("train profile", busy_ms, wall_ms)
    # the port's own flash kernels in that step, by name: (ms, launches)
    flash = {key.split("flash_")[1].split("(")[0]: (t / 1e3, n) for t, n, key in by_name
             if "flash_" in key}
    result.update(profile_busy_ms=busy_ms, profile_step_wall_ms=wall_ms,
                  profile_kernels=kernels, profile_idle_share=1 - busy_ms / wall_ms,
                  profile_flash_ms=sum(t for t, _ in flash.values()), profile_flash=flash,
                  profile_top=[(key[:80], t / 1e3, n) for t, n, key in by_name[:8]])
    print(f"train profile [{card}]: one optimizer step ({accumulate} micro-batches): device busy "
          f"{busy_ms:.1f} ms in {kernels:.0f} kernels; untraced wall p50 {wall_ms:.1f} ms; device "
          f"idle share {100 * (1 - busy_ms / wall_ms):.1f}%; flash kernels "
          f"{result['profile_flash_ms']:.1f} ms ("
          + ", ".join(f"{name} {t:.1f} ms x{n}" for name, (t, n) in sorted(flash.items()))
          + f"); top: {top_kernels(by_name, 1, 8)}")
    del objective, state, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_train_parity() -> dict:
    """One forward and backward of a 2-layer full-width model on one packed
    2048-token row: kernels in bf16, plain in bf16, plain in fp32."""
    from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    kw = dict(num_hidden_layers=2, param_dtype="float32")
    model = Llama(preset("llama-3.1-8b", **kw), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(1))
    host = packed_batches(5, 2048, 1, model.config.vocab_size, max_doc=1000)[0]
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    names = ("model.layers.0.self_attn.q_proj.weight", "model.layers.1.self_attn.k_proj.weight",
             "model.embed_tokens.weight")
    results = {}
    for name, impl in (("kernel", "auto"), ("plain", "torch"), ("fp32", "torch")):
        if name == "fp32":
            weights = model.state_dict()
            model = Llama(preset("llama-3.1-8b", compute_dtype="float32", **kw), device="cuda")
            model.load_state_dict(weights)
            del weights
        model.config.attention_impl = impl
        before = fa.flash_fwd_kernel.launches + fa.flash_dq_kernel.launches + fa.flash_dkv_kernel.launches
        model.zero_grad(set_to_none=True)
        loss = CLM(CLMConfig(), model=model).loss_and_metrics(batch, train=False)[0]
        loss.backward()
        torch.cuda.synchronize()
        ran = fa.flash_fwd_kernel.launches + fa.flash_dq_kernel.launches + fa.flash_dkv_kernel.launches - before
        check(ran == (6 if name == "kernel" else 0), f"train parity: {name} ran {ran} flash kernels")
        params = dict(model.named_parameters())
        results[name] = dict(loss=float(loss.detach()), **{n: params[n].grad.float() for n in names})
    del model
    truth = results["fp32"]
    errors = {}
    for path in ("kernel", "plain"):
        errors[path] = {"loss": abs(results[path]["loss"] - truth["loss"])}
        for n in names:
            errors[path][n] = _max_rel(results[path][n], truth[n])
    for key in errors["kernel"]:
        # the scalar loss's plain error can vanish by chance: a floor of
        # 2^-8 of the loss there
        floor = 2.0**-8 * abs(truth["loss"]) if key == "loss" else 0.0
        check(errors["kernel"][key] <= max(NO_FURTHER * errors["plain"][key], floor),
              f"train parity: {key}: the kernel path is further from fp32 "
              f"({errors['kernel'][key]:.3e}) than the plain bf16 path ({errors['plain'][key]:.3e})")
    print("train parity: 2-layer full width, 1 x 2048 packed tokens, vs fp32 (loss: |error|, grads: "
          "max error over max|fp32|): " + "; ".join(
              f"{key.removeprefix('model.')} kernel {errors['kernel'][key]:.3e} plain "
              f"{errors['plain'][key]:.3e}" for key in errors["kernel"]))
    gc.collect()
    torch.cuda.empty_cache()
    return errors


def phase_flash_timing(card: str) -> dict:
    """K1, K2, K3 at the training shape (B 1, S 8192, Hq 32, Hkv 8, D 128,
    bf16, one packed row): held against the plain versions (one kv head at
    a time), then timed with them and with SDPA, beside the bound."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    cases = bench_flash.training_case(seq=TRAIN_SEQ)
    case = cases[0]
    got = bench_flash.run_case(case, kernel=True, causal=True)
    ref = bench_flash.run_plain_by_kv_head(case, causal=True)
    ref32 = bench_flash.run_plain_by_kv_head(case, upcast=True, causal=True)
    torch.cuda.synchronize()
    errors, broken = flash_case_errors(got, ref, ref32, case, None)
    check(not broken, f"flash timing shape: kernels vs plain: {broken}")
    abs_err = {
        "fwd": float((got["out"].float() - ref["out"].float()).abs().max()),
        "dq": float((got["dq"].float() - ref["dq"].float()).abs().max()),
        "dkv": max(float((got[n].float() - ref[n].float()).abs().max()) for n in ("dk", "dv")),
    }
    del got, ref, ref32
    check(bench_flash.forward_twice_identical(case),
          "flash determinism: K1 gave other bits on a second launch (training shape)")
    check(bench_flash.backward_twice_identical(case),
          "flash determinism: K2 or K3 gave other bits on a second launch (training shape)")
    flat = bench_flash.flat_inputs(case)
    pairs = bench_flash.visible_pairs(flat["seg_q"], flat["seg_kv"])
    kernel = bench_flash.time_kernels(cases)
    plain = bench_flash.time_plain(cases)
    library = bench_flash.time_sdpa(cases)
    hq, head_dim = flat["q"].shape[2], flat["q"].shape[3]
    out = {}
    for kind in ("fwd", "dq", "dkv"):
        bound, by = bench_flash.bound_ms(kind, pairs, hq, head_dim, bench_flash.io_bytes(flat, kind))
        side = "fwd_ms" if kind == "fwd" else "bwd_ms"
        out[kind] = dict(ms=kernel[f"{kind}_ms"], plain_ms=plain[side], library_ms=library[side],
                         bound_ms=bound, bound_by=by, max_abs_err=abs_err[kind])
    print(f"flash parity at the training shape: bf16 vs plain (one kv head at a time): "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errors.items())))
    print(
        f"flash timing [{card}]: B1 S{TRAIN_SEQ} Hq{hq} Hkv{flat['k'].shape[2]} D{head_dim} bf16, "
        f"causal packed ({pairs} visible pairs per head), cold L2: "
        + "; ".join(
            f"{kind} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f} ms by {v['bound_by']}, "
            f"{100 * v['bound_ms'] / v['ms']:.1f}%)" for kind, v in out.items()
        )
        + f"; plain fwd {plain['fwd_ms']:.3f} ms, bwd {plain['bwd_ms']:.3f} ms (one kv head at a "
        f"time); SDPA (bool mask, enable_gqa) fwd {library['fwd_ms']:.3f} ms, bwd "
        f"{library['bwd_ms']:.3f} ms"
    )
    del cases, flat
    gc.collect()
    torch.cuda.empty_cache()
    short = bench_flash.kernel_record(2048)
    print(f"flash timing [{card}]: the same row cut to S 2048 ({short['visible_pairs_per_head']} "
          f"visible pairs per head), cold L2: " + "; ".join(
              f"{kind} {short[kind + '_ms']:.3f} ms (bound {short[kind + '_bound_ms']:.3f} ms, "
              f"{100 * short[kind + '_bound_ms'] / short[kind + '_ms']:.1f}%)"
              for kind in ("fwd", "dq", "dkv")))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_random_streams(card: str) -> dict:
    """The random-stream kernels (`prng.py`, `csrc/prng.cu`) against their
    plain versions at the shapes their paths give them: NEFTune's bf16
    uniform over one 8192 x 4096 row of embeddings (bits equal), the fp32
    uniform and the categorical draw over [rows, 128256] logits (tokens
    equal, perturbed logits within 4 fp32 ulps); then timed beside the
    plain versions and the bytes they must write (and read) over HBM's
    rate. Neither runs on the smoke's main path (greedy serving, a fit
    without NEFTune); `bench_turns.py` measures what they do end to end."""
    from llm_training_tpu_torch import prng
    from llm_training_tpu_torch.ops.kernels import bench_paged_decode as bench

    vocab = 128256
    mag = 5.0 / math.sqrt(TRAIN_SEQ * 4096)  # NEFTune alpha 5 at the fit's row
    key = prng.fold_in(prng.key(7), 3)
    for shape, dtype, low, high in (((1, TRAIN_SEQ, 4096), torch.bfloat16, -mag, mag),
                                    ((1, TRAIN_SEQ, 4096), torch.float32, -mag, mag),
                                    ((8, vocab), torch.float32, 1.1754943508222875e-38, 1.0),
                                    ((3, 5, 17), torch.bfloat16, -0.3, 0.7)):
        got = prng.uniform(key, shape, dtype, low, high, device="cuda")
        want = prng.uniform_torch(key, shape, dtype, low, high, device="cuda")
        check(torch.equal(got, want),
              f"random streams: uniform {shape} {dtype}: {int((got != want).sum())} values differ")
    worst_ulps = 0.0
    for rows in (1, 8):
        logits = 3 * torch.randn((rows, vocab), generator=torch.Generator(device="cuda")
                                 .manual_seed(rows), device="cuda")
        for call in range(4):
            k = prng.fold_in(prng.key(1), call)
            tokens = prng.categorical(k, logits)
            check(torch.equal(tokens, prng.categorical_torch(k, logits)),
                  f"random streams: categorical [{rows}, {vocab}] call {call}: tokens differ")
        perturbed = torch.empty_like(logits)
        err = prng._load().prng_gumbel_logits_launch(
            k[0], k[1], logits.numel(), logits.data_ptr(), perturbed.data_ptr(),
            prng._stream(logits.device))
        check(err == 0, f"random streams: gumbel launch failed ({err})")
        noise = prng.gumbel(k, logits.shape, device="cuda")
        # in ulps of the larger addend (what one rounding of the sum moves)
        scale = torch.maximum(noise.abs(), logits.abs()) * 2.0**-23
        ulps = float(((perturbed - (noise + logits)).abs() / scale).max())
        worst_ulps = max(worst_ulps, ulps)
    check(worst_ulps <= 4, f"random streams: perturbed logits {worst_ulps:.1f} ulps from plain")

    logits = torch.randn((8, vocab), device="cuda")
    neftune = ((1, TRAIN_SEQ, 4096), torch.bfloat16, -mag, mag)
    out = dict(
        uniform_ms=bench.device_ms([lambda: prng.uniform(key, *neftune, device="cuda")]),
        uniform_plain_ms=bench.device_ms([lambda: prng.uniform_torch(key, *neftune,
                                                                     device="cuda")], reps=5),
        categorical_ms=bench.device_ms([lambda: prng.categorical(key, logits)]),
        categorical_plain_ms=bench.device_ms([lambda: prng.categorical_torch(key, logits)],
                                             reps=10),
        uniform_bytes_ms=1e3 * TRAIN_SEQ * 4096 * 2 / bench.HBM_BYTES_PER_S,
        categorical_bytes_ms=1e3 * (2 * 8 * vocab * 4 + 8 * 8) / bench.HBM_BYTES_PER_S,
        perturbed_max_ulps=worst_ulps,
    )
    print(f"random streams: uniform bit-identical to the plain version (bf16 and fp32 NEFTune "
          f"rows, fp32 [8, {vocab}], bf16 [3, 5, 17]); categorical tokens identical at "
          f"[1|8, {vocab}], perturbed logits within {worst_ulps:.2f} ulps")
    print(f"random streams timing [{card}]: NEFTune bf16 uniform 1 x {TRAIN_SEQ} x 4096: kernel "
          f"{out['uniform_ms']:.4f} ms, plain {out['uniform_plain_ms']:.3f} ms, bytes "
          f"{out['uniform_bytes_ms']:.4f} ms; categorical [8, {vocab}] fp32: kernel + argmax "
          f"{out['categorical_ms']:.4f} ms, plain {out['categorical_plain_ms']:.3f} ms, bytes "
          f"{out['categorical_bytes_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return out


@dataclass
class PackedRowsConfig:
    """The fit phase's data as a config node: `seed` picks the documents,
    `rows` training rows of `seq` tokens (one a micro-batch) and
    `val_rows` validation rows from the next seed."""

    seq: int = TRAIN_SEQ
    rows: int = 4
    val_rows: int = 2
    vocab: int = 128256
    seed: int = 0
    batch_size: int = 1


class PackedRows:
    """A datamodule the CLI builds from `{"class_path":
    "chip_smoke.PackedRows"}`: `packed_batches` rows, the training stream
    cycling over them from any micro-step."""

    def __init__(self, config: PackedRowsConfig):
        self.config = config
        self.train, self.val = None, None

    def setup(self):
        if self.train is None:
            c = self.config
            self.train = packed_batches(c.seed, c.seq, c.rows, c.vocab)
            self.val = packed_batches(c.seed + 1, c.seq, c.val_rows, c.vocab)

    def train_batches(self, start_step=0):
        for i in range(start_step, 10**9):
            yield self.train[i % len(self.train)]

    def val_batches(self):
        yield from self.val


def lifecycle_config(model_kwargs: dict, checkpoint: bool) -> dict:
    trainer = {"max_steps": LIFE_STEPS, "seed": 0, "accumulate_grad_batches": 2,
               "log_every_n_steps": 1, "limit_val_batches": 2}
    if checkpoint:
        trainer.update(checkpoint_every_n_steps=2, checkpoint={
            "dirpath": str(LIFE_DIR / "ckpt"), "async_save": True, "max_to_keep": 1})
    return {
        "seed_everything": 0,
        "trainer": trainer,
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": model_kwargs},
            # the example's AdamW, clip and cosine/warmup, cut to 4 steps
            "optim": {"optimizer": "adamw", "learning_rate": 3e-4, "lr_scheduler": "cosine",
                      "warmup_steps": 1, "min_lr_ratio": 0.1, "grad_clip_norm": 1.0}}},
        "data": {"class_path": "chip_smoke.PackedRows",
                 "init_args": {"vocab": model_kwargs["vocab_size"]}},
    }


class LossLog:
    def __init__(self):
        self.losses = {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = metrics["loss"]


def fit_leg(config: dict, callbacks=()) -> tuple[dict, object, list[int], int]:
    """One `fit` through the CLI's builder: (losses by step, trainer, K1/K2/K3
    launches, plain-attention calls), the counts set to 0 just before."""
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    trainer, objective, datamodule = build_fit(config, LIFE_DEVICE)
    log = LossLog()
    trainer.callbacks += [log, *callbacks]
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    with count_plain_attention() as plain:
        for launcher in launchers:
            launcher.launches = 0
        trainer.fit(objective, datamodule)
        torch.cuda.synchronize()
        launches = [launcher.launches for launcher in launchers]
    return log.losses, trainer, launches, plain[0]


def run_command(argv: list[str]) -> list[dict]:
    """A CLI command as a user runs it; its JSON records from stdout."""
    from llm_training_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main([*argv, "--device", LIFE_DEVICE])
    check(rc == 0, f"lifecycle: {argv[0]} exited {rc}")
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def free_bytes(path: Path) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def phase_lifecycle(card: str) -> dict:
    """Checkpoint, loss-exact resume, and validate / evaluate / generate /
    serve from the checkpoint (see the header)."""
    from dataclasses import asdict

    from llm_training_tpu_torch.cli.main import build_parser, run_serve
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.ops.kernels import paged_attention as k4

    # the CLI configures logging once per process: keep its INFO records
    # off the smoke's stdout
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    model_config = preset("llama-3.1-8b", num_hidden_layers=LIFE_LAYERS, param_dtype="float32",
                          compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                          recompute_granularity="selective")
    kwargs = asdict(model_config)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in Llama(model_config).parameters())
    # fp32 parameters, AdamW's mu and nu, the accumulator of 2 micro-batches
    expected_bytes = 4 * 4 * n_params
    shutil.rmtree(LIFE_DIR, ignore_errors=True)
    LIFE_DIR.mkdir()
    config_path = LIFE_DIR / "config.json"
    config_path.write_text(json.dumps(lifecycle_config(kwargs, checkpoint=True)))
    result = dict(layers=LIFE_LAYERS, params=n_params)
    try:
        free = free_bytes(LIFE_DIR)
        print(f"lifecycle: {n_params} params, a checkpoint of ~{expected_bytes / 1e9:.2f} GB; "
              f"{free / 1e9:.2f} GB free in {LIFE_DIR}")
        # with max_to_keep 1 the second step is written before the first goes
        check(free >= 2 * expected_bytes,
              f"lifecycle: {free} bytes free in {LIFE_DIR}, the phase needs twice the "
              f"checkpoint's {expected_bytes}")

        full, trainer, launches, plain = fit_leg(lifecycle_config(kwargs, checkpoint=False))
        check(min(launches) > 0 and plain == 0,
              f"lifecycle: the uninterrupted fit launched K1/K2/K3 {launches}, plain path {plain}")
        full = {step: float(loss) for step, loss in full.items()}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        class StopAfter2:
            def on_train_step(self, trainer, step):
                trainer.should_stop = step == 2

        config = lifecycle_config(kwargs, checkpoint=True)
        first, saver, launches_a, plain_a = fit_leg(config, [StopAfter2()])
        save_a = dict(saver.checkpointer.last_save)
        saver.checkpointer.close()  # releases the pinned staging buffers
        saved = saver.state.state_dict()
        saved_counters = dict(saver.counters)
        check(sorted(first) == [1, 2] and saver.checkpointer.all_steps() == [2],
              f"lifecycle: the interrupted run logged {sorted(first)}, committed "
              f"{saver.checkpointer.all_steps()}")

        compared = {}

        class CompareRestored:
            """Right after the restore: the live state against the saved one."""

            def on_fit_start(self, trainer, objective, datamodule, start_step):
                restored = trainer.state.state_dict()
                check(restored.keys() == saved.keys(), "lifecycle: restored keys differ")
                differ = [k for k in saved if not torch.equal(saved[k], restored[k])]
                meta = trainer.checkpointer.read_meta(2)
                compared.update(tensors=len(saved), differ=differ, start_step=start_step,
                                counters=trainer.counters == saved_counters,
                                cursor=meta["data_state"]["sample_cursor"])
                saved.clear()
                gc.collect()
                torch.cuda.empty_cache()

        del saver
        gc.collect()
        torch.cuda.empty_cache()
        resumed, trainer, launches_b, plain_b = fit_leg(config, [CompareRestored()])
        restore = dict(trainer.checkpointer.last_restore)
        save_b = dict(trainer.checkpointer.last_save)
        trainer.checkpointer.close()
        check(not compared["differ"] and compared["counters"] and compared["start_step"] == 2
              and compared["cursor"] == 2 * 2,
              f"lifecycle: the restore differs from the save: {compared}")
        check(sorted(resumed) == [3, 4], f"lifecycle: the resumed run logged {sorted(resumed)}")
        rel = {s: abs(float(resumed[s]) - full[s]) / abs(full[s]) for s in (3, 4)}
        rel.update({s: abs(float(first[s]) - full[s]) / abs(full[s]) for s in (1, 2)})
        check(max(rel.values()) <= RESUME_RTOL,
              f"lifecycle: losses {first} + {resumed} against uninterrupted {full}")
        check(min(launches_a) > 0 and min(launches_b) > 0 and plain_a == plain_b == 0,
              f"lifecycle: K1/K2/K3 launched {launches_a} before and {launches_b} after the "
              f"restore (plain path {plain_a}, {plain_b})")
        check(save_b.get("pruned") == [2] and trainer.checkpointer.all_steps() == [4],
              f"lifecycle: step 4's save pruned {save_b.get('pruned')}, left "
              f"{trainer.checkpointer.all_steps()}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        result.update(losses=full, resumed=resumed, max_rel_loss_diff=max(rel.values()),
                      launches_before=launches_a, launches_after=launches_b,
                      restored_tensors=compared["tensors"], save_step2=save_a, save_step4=save_b,
                      restore=restore)
        print(f"lifecycle: resume restored {compared['tensors']} tensors bit for bit (parameters, "
              f"mu, nu, acc, count, mini_step, key, step), counters and cursor equal; losses "
              f"uninterrupted {[round(full[s], 6) for s in sorted(full)]}, interrupted + resumed "
              f"{[round(float(first[s]), 6) for s in (1, 2)]} + "
              f"{[round(float(resumed[s]), 6) for s in (3, 4)]}, largest relative difference "
              f"{max(rel.values()):.3e} (limit {RESUME_RTOL}); K1/K2/K3 {launches_a} before, "
              f"{launches_b} after the restore")
        print(f"lifecycle timing [{card}]: checkpoint {save_a['bytes']} bytes on disk "
              f"({save_a['tensor_bytes']} tensor bytes); save of step 2: blocking (device -> "
              f"pinned host, first save) {save_a['blocking_s']:.3f} s, committed after "
              f"{save_a['commit_s']:.3f} s; save of step 4: blocking {save_b['blocking_s']:.3f} "
              f"s, committed after {save_b['commit_s']:.3f} s, pruned {save_b['pruned']}; "
              f"restore {restore['seconds']:.3f} s")

        # validate and evaluate from the checkpoint, through the CLI
        for launcher in (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel):
            launcher.launches = 0
        (val,) = run_command(["validate", "--config", str(config_path)])
        (evaluation,) = run_command(["evaluate", "--config", str(config_path),
                                     "--limit-batches", "2"])
        eval_launches = [fa.flash_fwd_kernel.launches, fa.flash_dq_kernel.launches,
                         fa.flash_dkv_kernel.launches]
        nll = evaluation["eval/nll_per_token"]
        check(abs(nll - val["val_loss"]) <= EVAL_RTOL * abs(val["val_loss"]),
              f"lifecycle: eval/nll_per_token {nll} against val_loss {val['val_loss']}")
        check(eval_launches[0] > 0 and eval_launches[1:] == [0, 0],
              f"lifecycle: validate + evaluate launched K1/K2/K3 {eval_launches}")
        result.update(val_loss=val["val_loss"], eval=evaluation, eval_launches=eval_launches)
        print(f"lifecycle: validate val_loss {val['val_loss']:.6f}, evaluate nll/token "
              f"{nll:.6f} (perplexity {evaluation['eval/perplexity']:.2f}) over 2 packed rows; "
              f"K1/K2/K3 {eval_launches}")

        # generate from the checkpoint: 4 left-padded prompts, greedy, bf16 cache
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, model_config.vocab_size, n).tolist() for n in (64, 200, 380, 512)]
        *rows, stats = run_command(
            ["generate", "--config", str(config_path), "--max-new-tokens", "32",
             "--cache-dtype", "bfloat16"]
            + [f"--prompt-tokens={','.join(map(str, p))}" for p in prompts])
        stats = stats["stats"]
        check(len(rows) == 4 and all(r["prompt"] == p for r, p in zip(rows, prompts)),
              "lifecycle: generate did not answer every prompt")
        check(all(r["n_tokens"] == len(r["tokens"]) and r["stop_reason"] in ("eos", "max_tokens")
                  for r in rows), f"lifecycle: generate rows {[r['stop_reason'] for r in rows]}")
        prefill_err, prefill_vs_k1, prefill_scale = prefill_vs_full_forward(config_path, prompts)
        check(prefill_err <= PREFILL_RTOL * prefill_scale,
              f"lifecycle: prefill logits {prefill_err} from the full forward on the plain path "
              f"(limit {PREFILL_RTOL} x {prefill_scale})")
        check(prefill_vs_k1 <= ENGINE_LOGITS_RTOL * prefill_scale,
              f"lifecycle: prefill logits {prefill_vs_k1} from the full forward through K1 "
              f"(limit {ENGINE_LOGITS_RTOL} x {prefill_scale})")
        result.update(generate=stats, prefill_err=prefill_err, prefill_vs_k1=prefill_vs_k1,
                      prefill_scale=prefill_scale)
        print(f"lifecycle: generate, 4 prompts of 64-512 tokens, 32 new, greedy, bf16 cache; "
              f"prefill last-column logits max err {prefill_err:.4f} against the full forward on "
              f"the same plain attention path (limit {PREFILL_RTOL} x max |logit| "
              f"{prefill_scale:.3f}), {prefill_vs_k1:.4f} against it through K1 (limit "
              f"{ENGINE_LOGITS_RTOL:.4f} x max |logit|)")
        print(f"lifecycle timing [{card}]: generate decode/prefill_time_s "
              f"{stats['decode/prefill_time_s']:.4f}, decode/tokens_per_sec "
              f"{stats['decode/tokens_per_sec']:.1f}, decode/cache_bytes "
              f"{stats['decode/cache_bytes']}")

        # serve --config: the same prompts as JSONL requests
        args = build_parser().parse_args(
            ["serve", "--config", str(config_path), "--max-new-tokens", "32", "--max-batch", "4",
             "--max-model-len", "1024", "--prefill-chunk", "256", "--block-size", "16",
             "--device", LIFE_DEVICE])
        requests = "".join(json.dumps({"id": f"r{i}", "prompt": p}) + "\n"
                           for i, p in enumerate(prompts))
        out = io.StringIO()
        k4.paged_decode_attention.launches = 0
        check(run_serve(args, stdin=io.StringIO(requests), stdout=out) == 0,
              "lifecycle: serve failed")
        serve_launches = k4.paged_decode_attention.launches
        events = [json.loads(line) for line in out.getvalue().splitlines()]
        done = {e["id"]: e for e in events if e["type"] == "done"}
        serve_stats = events[-1]["stats"]
        check(sorted(done) == [f"r{i}" for i in range(4)]
              and serve_stats["decode/cache_blocks_in_use"] == 0,
              f"lifecycle: serve answered {sorted(done)}, blocks in use "
              f"{serve_stats['decode/cache_blocks_in_use']}")
        steps = int(serve_stats["serve/decode_steps"])
        check(serve_launches == steps * LIFE_LAYERS and serve_launches > 0,
              f"lifecycle: serve launched K4 {serve_launches} times for {steps} decode steps")
        pairs = [(a, b) for i, row in enumerate(rows)
                 for a, b in zip(done[f"r{i}"]["tokens"], row["tokens"])]
        share = sum(a == b for a, b in pairs) / max(len(pairs), 1)
        result.update(serve_launches=serve_launches, serve_decode_steps=steps,
                      serve_tokens_equal_share=share)
        print(f"lifecycle: serve --config, 4 requests done, pool empty, K4 {serve_launches} "
              f"launches ({steps} decode steps x {LIFE_LAYERS} layers); {100 * share:.1f}% of "
              f"tokens equal generate's (bf16 paths may part at a near tie)")
    finally:
        shutil.rmtree(LIFE_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return result


def preference_batches(seed: int, steps: int, vocab: int) -> list[dict]:
    """`steps` batches of PREF_PAIRS synthetic pairs from `seed`: a prompt of
    64-1024 random tokens (labels -100) and two responses of 32-1024; the
    chosen one draws from one set of PREF_BAND token ids and the rejected one
    from another, so each id recurs across batches and the preference
    generalises from one batch to the next (responses over the whole
    vocabulary would share almost no id, and an unseen batch's DPO logits
    would follow the responses' lengths instead). Pairs whose
    longer side exceeds PREF_MAX_LENGTH are dropped, as the JAX data module
    drops them; the rest are collated by the port's collator to a multiple
    of PREF_MULTIPLE."""
    import types

    from llm_training_tpu_torch.data.preference_tuning.collator import (
        PreferenceTuningDataCollator,
    )

    rng = np.random.default_rng(seed)
    collate = PreferenceTuningDataCollator(types.SimpleNamespace(
        tokenizer=types.SimpleNamespace(pad_token_id=0), pad_to_multiple_of=PREF_MULTIPLE))
    pairs = []
    while len(pairs) < steps * PREF_PAIRS:
        prompt = rng.integers(1, vocab, int(rng.integers(64, 1025)))
        pair = {}
        for side, low in (("chosen", 1000), ("rejected", 1000 + PREF_BAND)):
            high = low + PREF_BAND
            ids = np.concatenate([prompt, rng.integers(low, high, int(rng.integers(32, 1025)))])
            labels = ids.copy()
            labels[:len(prompt)] = -100
            pair.update({f"{side}_input_ids": ids, f"{side}_labels": labels,
                         f"{side}_length": len(ids)})
        if max(pair["chosen_length"], pair["rejected_length"]) <= PREF_MAX_LENGTH:
            pairs.append(pair)
    return [collate(pairs[i:i + PREF_PAIRS]) for i in range(0, len(pairs), PREF_PAIRS)]


def preference_node(kind: str, model_kwargs: dict) -> dict:
    """The objective's model node as a JSON config holds it: the examples'
    beta (and DPO's label smoothing), AdamW with clip, DPO's linear and
    ORPO's cosine schedule (peak PREF_PEAK_LR), warmup cut to 1 of 6
    steps; the log-prob chunk of 128 positions of each of the 8 rows (1024 tokens
    of fp32 logits at a time, the fit phase's CE chunk)."""
    optim = {"optimizer": "adamw", "grad_clip_norm": 1.0, "warmup_steps": 1}
    if kind == "DPO":
        optim.update(learning_rate=PREF_PEAK_LR, lr_scheduler="linear")
        extra = {"label_smoothing": 0.0}
    else:
        optim.update(learning_rate=PREF_PEAK_LR, lr_scheduler="cosine")
        extra = {}
    return json.loads(json.dumps({
        "class_path": f"llm_training_tpu.lms.{kind}",
        "init_args": {"model": {"model_class": "Llama", "model_kwargs": model_kwargs},
                      "beta": PREF_BETA, "logps_chunk_size": 128, "optim": optim, **extra},
    }))


def phase_preference(card: str) -> dict:
    """DPO and ORPO through the Trainer at Llama-3.1-8B widths (see the
    header)."""
    from dataclasses import asdict

    from llm_training_tpu_torch.cli.config import instantiate_from_config
    from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

    class PreferenceData(BaseDataModule):
        """The phase's batches, in order, from any micro-step (the smoke's
        harness, not a data module of the package)."""

        def setup(self):
            pass

        def train_batches(self, start_step=0):
            yield from batches[start_step:]

    config = preset("llama-3.1-8b", num_hidden_layers=PREF_LAYERS, param_dtype="float32",
                    compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                    recompute_granularity="selective")
    batches = preference_batches(0, PREF_STEPS, config.vocab_size)
    head_dim, hq = config.resolved_head_dim, config.num_attention_heads
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    out = {}
    for kind in ("DPO", "ORPO"):
        objective = instantiate_from_config(preference_node(kind, asdict(config)))

        class Watch:
            """Step clock, host metrics, and the reference's initial weights
            (host copies) with a slice of the policy's, taken at fit start."""

            def __init__(self):
                self.step_s, self.metrics, self.t = [], [], None
                self.ref0, self.policy0 = None, None

            def on_fit_start(self, trainer, *args):
                model = trainer.state.model
                policy = model.policy if kind == "DPO" else model
                self.policy0 = policy.lm_head.weight[:64].detach().to("cpu", copy=True)
                if kind == "DPO":
                    self.ref0 = {n: p.detach().to("cpu", copy=True)
                                 for n, p in model.ref.named_parameters()}
                torch.cuda.synchronize()
                self.t = time.perf_counter()

            def on_train_step(self, trainer, step):
                torch.cuda.synchronize()
                now = time.perf_counter()
                self.step_s.append(now - self.t)
                self.t = now

            def on_step_end(self, trainer, step, metrics):
                self.metrics.append(metrics)

        watch = Watch()
        trainer = Trainer(
            TrainerConfig(max_steps=PREF_STEPS, seed=0, log_every_n_steps=1),
            callbacks=[watch], device=PREF_DEVICE,
        )
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with count_plain_attention() as plain:
            for launcher in launchers:
                launcher.launches = 0
            state = trainer.fit(objective, PreferenceData(BaseDataModuleConfig()))
            torch.cuda.synchronize()
            launches = [launcher.launches for launcher in launchers]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [m["loss"] for m in watch.metrics]
        name = kind.lower()
        model = state.model
        policy = model.policy if kind == "DPO" else model

        # 6 N per policy token (N without the input embedding table), 2 N per
        # reference token; attention 12 D per visible pair per head per layer
        # for the policy (forward and backward), 4 D for the reference's
        # forward; recompute not counted
        n_matmul = sum(p.numel() for p in policy.parameters()) - policy.model.embed_tokens.weight.numel()
        per_token = 6 * n_matmul + (2 * n_matmul if kind == "DPO" else 0)
        per_pair = (12 + (4 if kind == "DPO" else 0)) * head_dim * hq * PREF_LAYERS
        tokens, flops = [], []
        for batch in batches:
            n, f = 0, 0
            for side in ("chosen", "rejected"):
                seg = torch.as_tensor(batch[f"{side}_segment_ids"], device=PREF_DEVICE)
                side_tokens = int((batch[f"{side}_segment_ids"] > 0).sum())
                n += side_tokens
                f += per_token * side_tokens + per_pair * bench_flash.visible_pairs(seg, seg)
            tokens.append(n)
            flops.append(f)
        timed = watch.step_s[1:]  # step 1 carries the warm-up
        result = dict(
            layers=PREF_LAYERS, steps=PREF_STEPS, pairs=PREF_PAIRS,
            widths=[b["chosen_input_ids"].shape[1] for b in batches], tokens=tokens,
            launches=dict(zip(("fwd", "dq", "dkv"), launches)), plain_calls=plain[0],
            losses=losses, metrics_first=watch.metrics[0], metrics_last=watch.metrics[-1],
            step_ms_p50=1e3 * percentile(timed, 50), step_ms=[1e3 * t for t in watch.step_s],
            tokens_per_s=sum(tokens[1:]) / sum(timed),
            mfu=sum(flops[1:]) / sum(timed) / bench_flash.BF16_FLOPS_PER_S,
            peak_memory_gb=peak_gb,
        )
        print(f"{name} [{card}]: llama-3.1-8b widths x {PREF_LAYERS} layers, {PREF_STEPS} steps "
              f"of {PREF_PAIRS} pairs (widths {result['widths']}); losses "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f"; launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}, plain path "
              f"{plain[0]}; step p50 {result['step_ms_p50']:.1f} ms, "
              f"{result['tokens_per_s']:.0f} tokens/s (non-padding, both sides), MFU "
              f"{100 * result['mfu']:.2f}% of 989 TFLOPS (6N a policy token"
              + (", 2N a reference token" if kind == "DPO" else "")
              + f", attention {per_pair // (head_dim * hq * PREF_LAYERS)} D a visible pair a head "
              f"a layer), peak memory {peak_gb:.2f} GB", flush=True)

        check(len(losses) == PREF_STEPS and all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        forwards = 4 if kind == "DPO" else 2  # K1 per layer a step: policy (and reference) x 2 sides
        expected = [forwards * PREF_LAYERS * PREF_STEPS] + [2 * PREF_LAYERS * PREF_STEPS] * 2
        check(launches == expected and plain[0] == 0,
              f"{name}: K1/K2/K3 launched {launches} times, expected {expected}; plain path "
              f"{plain[0]} times")
        moved = not torch.equal(policy.lm_head.weight[:64].detach().cpu(), watch.policy0)
        check(moved, f"{name}: the policy did not move")
        if kind == "DPO":
            check(abs(losses[0] - math.log(2)) <= LN2_RTOL * math.log(2)
                  and watch.metrics[0]["reward_accuracy"] == 0.0,
                  f"dpo: step 1 loss {losses[0]} (ln 2 = {math.log(2)}), reward accuracy "
                  f"{watch.metrics[0]['reward_accuracy']}")
            check(losses[-1] < math.log(2), f"dpo: the loss did not fall below ln 2: {losses}")
            changed = [n for n, p in model.ref.named_parameters()
                       if not torch.equal(p.detach().cpu(), watch.ref0[n])]
            check(not changed, f"dpo: reference parameters changed: {changed[:4]}")
            ref_state = sum(t.numel() * t.element_size()
                            for k, t in state.optimizer.state_dict().items() if ".ref." in k)
            check(ref_state == 0, f"dpo: {ref_state} bytes of optimizer state for the reference")
        else:
            sums = [m["or_loss"] + m["ce_loss"] for m in watch.metrics]
            check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(losses, sums)),
                  f"orpo: loss {losses} is not or_loss + ce_loss {sums}")
            check(losses[-1] < losses[0], f"orpo: the loss did not fall: {losses}")
        out[name] = result
        del objective, state, trainer, model, policy, watch
        gc.collect()
        torch.cuda.empty_cache()
    out["parity"] = preference_parity(batches[0])
    return out


def preference_parity(host: dict) -> dict:
    """DPO's loss and backward on one preference batch at its own width
    (PREF_PAIRS right-padded rows a side) with a PREF_PARITY_LAYERS-layer
    full-width policy and reference: kernels in bf16, plain in bf16, plain
    in fp32. The per-row log-probs of both models, the loss and policy
    gradients of the kernel path may be no further from fp32 than
    NO_FURTHER x the plain bf16 path's."""
    from llm_training_tpu_torch.lms.dpo import DPO, DPOConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    layers = PREF_PARITY_LAYERS
    kw = dict(num_hidden_layers=layers, param_dtype="float32", enable_gradient_checkpointing=True,
              recompute_granularity="selective")
    ref = Llama(preset("llama-3.1-8b", **kw), device=PREF_DEVICE)
    ref.init_weights(torch.Generator(device=PREF_DEVICE).manual_seed(1))
    policy = Llama(preset("llama-3.1-8b", **kw), device=PREF_DEVICE)
    policy.load_state_dict(ref.state_dict())
    noise = torch.Generator(device=PREF_DEVICE).manual_seed(2)
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(torch.randn(p.shape, generator=noise, device=p.device),
                   alpha=PREF_PARITY_NOISE * policy.config.initializer_range)
    ref.requires_grad_(False)
    batch = {k: torch.as_tensor(v, device=PREF_DEVICE) for k, v in host.items()}
    width = batch["chosen_input_ids"].shape[1]
    rows = ("policy_chosen", "policy_rejected", "ref_chosen", "ref_rejected")
    names = ("model.layers.0.self_attn.q_proj.weight", "model.layers.1.self_attn.k_proj.weight",
             "model.layers.1.self_attn.v_proj.weight", "model.embed_tokens.weight")
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    results = {}
    for path, impl in (("kernel", "auto"), ("plain", "torch"), ("fp32", "torch")):
        if path == "fp32":
            fp32 = []
            for model in (policy, ref):
                twin = Llama(preset("llama-3.1-8b", compute_dtype="float32", **kw), device=PREF_DEVICE)
                twin.load_state_dict(model.state_dict())
                fp32.append(twin)
            policy, ref = fp32
            ref.requires_grad_(False)
            del fp32, twin, model
        for model in (policy, ref):
            model.config.attention_impl = impl
        objective = DPO(DPOConfig(beta=PREF_BETA, logps_chunk_size=128), model=policy, ref_model=ref)
        logps, real = [], objective._logps

        def recorded(model, batch, side, real=real, logps=logps):
            out = real(model, batch, side)
            logps.append(out[0].detach())
            return out

        objective._logps = recorded  # in the order of `rows`
        before = [launcher.launches for launcher in launchers]
        policy.zero_grad(set_to_none=True)
        with count_plain_attention() as plain:
            loss = objective.loss_and_metrics(batch)[0]
            loss.backward()
            torch.cuda.synchronize()
        ran = [launcher.launches - b for launcher, b in zip(launchers, before)]
        expected = [4 * layers, 2 * layers, 2 * layers] if path == "kernel" else [0, 0, 0]
        check(ran == expected and (plain[0] == 0) == (path == "kernel"),
              f"preference parity: {path} launched K1/K2/K3 {ran} (expected {expected}) and "
              f"the plain path {plain[0]} times")
        check(all(p.grad is None for p in ref.parameters()),
              f"preference parity: {path}: the reference got gradients")
        params = dict(policy.named_parameters())
        results[path] = dict(loss=float(loss.detach()), **dict(zip(rows, logps)),
                             **{n: params[n].grad for n in names})
        policy.zero_grad(set_to_none=True)
        del objective, recorded, logps, real, loss, params
    del policy, ref
    for result in results.values():
        # DPO's logits: the policy's log-ratio of chosen over rejected less
        # the reference's, per row
        result["margin"] = (result["policy_chosen"] - result["policy_rejected"]
                            - result["ref_chosen"] + result["ref_rejected"])
    truth = results["fp32"]
    errors, row_errors = {}, {}
    for path in ("kernel", "plain"):
        errors[path] = {"loss": abs(results[path]["loss"] - truth["loss"])}
        for key in (*rows, "margin", *names):
            errors[path][key] = _max_rel(results[path][key], truth[key])
        row_errors[path] = {key: (results[path][key] - truth[key]).abs().tolist()
                            for key in (*rows, "margin")}
    # the loss is a signed mean of per-row terms whose rounding errors are
    # independent between the two bf16 paths, so one path's scalar error
    # may cancel by chance where the other's does not: the loss is held to
    # the plain path's row errors of DPO's logits, propagated with the
    # loss's weights |dL/d logit| (beta sigmoid(-beta m) / rows) and no
    # cancellation; every other quantity to its own plain error
    weight = PREF_BETA * torch.sigmoid(-PREF_BETA * truth["margin"]) / PREF_PAIRS
    plain_rows = torch.tensor(row_errors["plain"]["margin"], device=weight.device)
    errors["plain"]["loss_budget"] = float((weight * plain_rows).sum())
    print(f"preference parity: DPO, {layers}-layer full width, {PREF_PAIRS} pairs x {width} "
          f"tokens a side, loss fp32 {truth['loss']:.6f}, vs fp32 (loss: |error|; log-probs and "
          "DPO's logits (margin) per row, grads: max error over max|fp32|): " + "; ".join(
              f"{key.removeprefix('model.')} kernel {errors['kernel'][key]:.3e} plain "
              f"{errors['plain'][key]:.3e}" for key in errors["kernel"])
          + "; |error| of DPO's logits per row: kernel "
          + " ".join(f"{x:.3f}" for x in row_errors["kernel"]["margin"]) + ", plain "
          + " ".join(f"{x:.3f}" for x in row_errors["plain"]["margin"])
          + f"; the loss's limit, the plain rows propagated: {errors['plain']['loss_budget']:.3e}",
          flush=True)
    for key in errors["kernel"]:
        limit = errors["plain"]["loss_budget" if key == "loss" else key]
        check(errors["kernel"][key] <= NO_FURTHER * limit,
              f"preference parity: {key}: the kernel path is further from fp32 "
              f"({errors['kernel'][key]:.3e}) than {NO_FURTHER} x the plain bf16 path's "
              f"({limit:.3e})")
    loss_fp32 = truth["loss"]
    del results, truth
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=layers, width=width, loss_fp32=loss_fp32, errors=errors,
                row_errors=row_errors)


@torch.no_grad()
def prefill_vs_full_forward(config_path: Path, prompts: list[list[int]]):
    """The restored model's left-padded prefill through a bf16 dense cache
    against its full (training) forward on the same batch, on the plain
    attention path (the cache's own) and through K1: (max |difference| of
    the last-column logits for each, max |logit|)."""
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.infer.cache import init_decode_state
    from llm_training_tpu_torch.infer.engine import _left_pad

    trainer, objective, _ = build_fit(load_config(config_path), LIFE_DEVICE)
    model = trainer.restore_for_inference(objective).model
    ids, pad_lens = _left_pad(prompts, 0)
    width = ids.shape[1]
    state = init_decode_state(model.config, len(prompts), width, "bfloat16", device=LIFE_DEVICE)
    columns = np.arange(width)[None, :]

    def tensor(array):
        return torch.as_tensor(np.asarray(array), device=LIFE_DEVICE)

    inputs = dict(
        input_ids=tensor(ids).long(),
        segment_ids=tensor((columns >= pad_lens[:, None]).astype(np.int32)),
        position_ids=tensor(np.maximum(columns - pad_lens[:, None], 0)).long(),
    )
    out = model(**inputs, decode_state=state)
    prefill = out.logits[:, -1].float()
    check(bool(torch.isfinite(prefill).all()), "lifecycle: non-finite prefill logits")
    errors = {}
    for impl in ("torch", "auto"):  # the plain path, as the cache's; then K1
        model.config.attention_impl = impl
        # the same left-padded batch as a training forward: pads are
        # segment 0, so every product has the prefill's shapes
        full = model(input_ids=inputs["input_ids"], segment_ids=inputs["segment_ids"],
                     position_ids=inputs["position_ids"]).logits[:, -1].float()
        errors[impl] = float((prefill - full).abs().max())
    scale = float(full.abs().max())
    del model, state, out
    gc.collect()
    torch.cuda.empty_cache()
    return errors["torch"], errors["auto"], scale

# ------------------------------------------------------------ optimizer phase


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SmokeFailure("optimizer: /proc/meminfo has no MemAvailable")


def offload_bytes(config, dtype: str) -> int:
    """Host bytes of AdamW's offloaded mu and nu for a model of `config`:
    4, 2 or 1 byte an element, and int8's float32 scales (one a block)."""
    from llm_training_tpu_torch.models.llama.model import Llama

    n = sum(p.numel() for p in Llama(config, device="meta").parameters())
    per = {"float32": 4, "bfloat16": 2, "int8": 1 + 4 / OPT_BLOCK}[dtype]
    return int(2 * n * per)


def pinned_copy_rate(nbytes: int = 1 << 30) -> dict:
    """A plain copy of 1 GiB between pinned host memory and the card, each
    way (device time, CUDA events): the yardstick of the offloaded round
    trip's rate."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=OPT_DEVICE)
    out = {}
    for name, (dst, src) in (("h2d", (dev, host)), ("d2h", (host, dev))):
        dst.copy_(src, non_blocking=True)  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        out[f"{name}_gb_s"] = 4 * nbytes / (start.elapsed_time(end) / 1e3) / 1e9
    del host, dev
    return out


def optimizer_run(card: str, name: str, layers: int, steps: int, optim: dict,
                  prefetch: int = 2, profile: bool = False, inspect=None, **offload) -> dict:
    """One fit of the optimizer phase through the Trainer: Llama-3.1-8B
    widths at `layers` layers, bf16 compute, selective recompute, random
    weights from seed 0, one packed 8192-token row a step. Times each step
    (synchronized) and each optimizer update (CUDA events), and with
    offload the update's split (copy in, update and codec, copy out).
    `inspect(state, start)` reads what a check needs from the final state
    (`start`: host copies of the initial parameters) before the run's
    objects are freed."""
    from dataclasses import asdict

    from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
    from llm_training_tpu_torch.lms.base import ModelProvider
    from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.optim.builder import OptimConfig
    from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

    config = preset("llama-3.1-8b", num_hidden_layers=layers, param_dtype="float32",
                    compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                    recompute_granularity="selective")
    batches = packed_batches(0, TRAIN_SEQ, 4, config.vocab_size)[:OPT_ROWS]

    class Repeated(BaseDataModule):
        def setup(self):
            pass

        def train_batches(self, start_step=0):
            for i in range(start_step, 10**9):
                yield batches[i % OPT_ROWS]

    class Clock:
        def __init__(self):
            self.step_s, self.losses, self.update_ms, self.splits, self.t = [], [], [], [], None

        def on_fit_start(self, trainer, *args):
            if inspect is not None:
                self.start = {n: p.detach().to("cpu", copy=True)
                              for n, p in trainer.state.model.named_parameters()}
            optimizer = trainer.state.optimizer
            optimizer.store.timing = True
            update = optimizer.update

            def timed_update():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                changed = update()
                end.record()
                end.synchronize()
                self.update_ms.append(start.elapsed_time(end))
                if optimizer.store.split is not None:
                    self.splits.append(dict(optimizer.store.split))
                return changed

            optimizer.update = timed_update
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_train_step(self, trainer, step):
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.step_s.append(now - self.t)
            self.t = now

        def on_step_end(self, trainer, step, metrics):
            self.losses.append(metrics["loss"])

    clock = Clock()
    trainer = Trainer(
        TrainerConfig(max_steps=steps, seed=0, log_every_n_steps=1, prefetch_batches=prefetch,
                      **offload),
        callbacks=[clock], device=OPT_DEVICE,
    )
    objective = CLM(CLMConfig(model=ModelProvider("Llama", asdict(config)),
                              optim=OptimConfig(**optim)))
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with count_plain_attention() as plain:
        for launcher in launchers:
            launcher.launches = 0
        state = trainer.fit(objective, Repeated(BaseDataModuleConfig()))
        torch.cuda.synchronize()
        launches = [launcher.launches for launcher in launchers]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.model.embed_tokens.weight.numel()
    head_dim, hq = config.resolved_head_dim, config.num_attention_heads
    work = []
    for batch in batches:
        seg = torch.as_tensor(batch["segment_ids"], device=OPT_DEVICE)
        tokens = int((batch["segment_ids"] > 0).sum())
        work.append((tokens, 6 * n_matmul * tokens
                     + 12 * head_dim * hq * layers * bench_flash.visible_pairs(seg, seg)))
    timed = range(1, steps)  # step 1 carries the warm-up
    seconds = sum(clock.step_s[s] for s in timed)
    split = {}
    if clock.splits:
        for key in clock.splits[0]:
            split[key] = percentile([s[key] for s in clock.splits[1:] or clock.splits], 50)
        moved = split["bytes_in"] + split["bytes_out"]
        split["link_gb_s"] = moved / ((split["copy_in_ms"] + split["copy_out_ms"]) / 1e3) / 1e9
    result = dict(
        name=name, layers=layers, steps=steps, params=n_params, optimizer=optim["optimizer"],
        offload=state.optimizer.offload, prefetch_batches=prefetch,
        launches=dict(zip(("fwd", "dq", "dkv"), launches)), plain_calls=plain[0],
        losses=clock.losses, step_ms=[1e3 * t for t in clock.step_s],
        step_ms_p50=1e3 * percentile([clock.step_s[s] for s in timed], 50),
        update_ms_p50=percentile(clock.update_ms[1:], 50),
        tokens_per_s=sum(work[s % OPT_ROWS][0] for s in timed) / seconds,
        mfu=sum(work[s % OPT_ROWS][1] for s in timed) / seconds / bench_flash.BF16_FLOPS_PER_S,
        peak_memory_gb=peak_gb, host_bytes=state.optimizer.store.host_bytes(), split=split,
    )
    if inspect is not None:  # the state after the fit, before the traced steps
        result["inspect"] = inspect(state, clock.start)
    if profile:
        stream = trainer.train_stream(Repeated(BaseDataModuleConfig()), steps)

        def step():
            batch, _ = next(stream)
            trainer.train_micro_step(objective, state, batch)

        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
        wall_ms = percentile(walls, 50)
        busy_ms, kernels, _ = device_profile(step, 1)
        if hasattr(stream, "close"):
            stream.close()
        check_busy(f"optimizer {name} profile", busy_ms, wall_ms)
        result.update(profile_busy_ms=busy_ms, profile_wall_ms=wall_ms,
                      profile_idle_share=1 - busy_ms / wall_ms, profile_kernels=kernels)
    print(f"optimizer {name} [{card}]: {layers} layers ({n_params} params), {steps} steps of 1 x "
          f"{TRAIN_SEQ} packed tokens, {optim['optimizer']} lr {optim['learning_rate']}, "
          f"offload {state.optimizer.offload}, prefetch {prefetch}; losses "
          + ", ".join(f"{x:.6f}" for x in clock.losses)
          + f"; K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}, plain {plain[0]}; step p50 "
          f"{result['step_ms_p50']:.1f} ms, update p50 {result['update_ms_p50']:.1f} ms, "
          f"{result['tokens_per_s']:.0f} tokens/s, MFU {100 * result['mfu']:.2f}%, peak "
          f"{peak_gb:.2f} GB, pinned host {result['host_bytes']} bytes"
          + (f"; split (p50 over steps 2-{steps}) copy in {split['copy_in_ms']:.1f} ms, update "
             f"and codec {split['update_ms']:.1f} ms, copy out {split['copy_out_ms']:.1f} ms, "
             f"{split['bytes_in'] + split['bytes_out']} bytes at {split['link_gb_s']:.2f} GB/s"
             if split else "")
          + (f"; traced step: busy {result['profile_busy_ms']:.1f} of {result['profile_wall_ms']:.1f}"
             f" ms, idle {100 * result['profile_idle_share']:.2f}%" if profile else ""),
          flush=True)
    check(len(clock.losses) == steps and all(math.isfinite(x) for x in clock.losses),
          f"optimizer {name}: losses {clock.losses}")
    expected = [layers * steps] * 3  # selective recompute: K1 once a layer a step
    check(launches == expected and plain[0] == 0,
          f"optimizer {name}: K1/K2/K3 launched {launches}, expected {expected}; plain path "
          f"{plain[0]} times")
    check(peak_gb * 1e9 < torch.cuda.get_device_properties(0).total_memory,
          f"optimizer {name}: peak {peak_gb:.2f} GB")
    del state, trainer, objective, model, clock
    release()
    return result


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:  # the pinned blocks the previous run cached
        empty_host()


def phase_optimizer(card: str) -> dict:
    """Optimizer placement, full depth, Lion and prefetch (see the header)."""
    from llm_training_tpu_torch.models.llama.config import preset

    full = preset("llama-3.1-8b", num_hidden_layers=OPT_FULL_LAYERS)
    needed = max(offload_bytes(preset("llama-3.1-8b", num_hidden_layers=OPT_LAYERS), "float32"),
                 offload_bytes(full, "int8"))
    available = mem_available()
    print(f"optimizer: MemAvailable {available} bytes; the largest pinned state {needed} bytes "
          f"(x2 for the pinned allocator's power-of-two blocks)", flush=True)
    check(available >= 2 * needed,
          f"optimizer: MemAvailable {available} bytes, the phase pins up to {needed} bytes")
    rate = pinned_copy_rate()
    print(f"optimizer [{card}]: plain 1 GiB pinned copy: host to card {rate['h2d_gb_s']:.2f} GB/s, "
          f"card to host {rate['d2h_gb_s']:.2f} GB/s", flush=True)
    out = {"pinned_copy": rate}

    # 1. placement parity at OPT_LAYERS, and prefetch 2 against 0
    def keep(state, start):
        """The final parameters (host copies) and their travel from the start."""
        final = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
        travel = sum(float((final[n].double() - start[n].double()).pow(2).sum())
                     for n in final) ** 0.5
        return final, travel

    ref = optimizer_run(card, "adamw_card", OPT_LAYERS, OPT_STEPS, OPT_ADAMW, profile=True,
                        inspect=keep)
    p_ref, travel = ref.pop("inspect")
    out["adamw_card"] = ref
    run = optimizer_run(card, "adamw_card_prefetch0", OPT_LAYERS, OPT_STEPS, OPT_ADAMW,
                        prefetch=0, profile=True)
    check(run["losses"] == ref["losses"],
          f"optimizer: prefetch 0 losses {run['losses']} != prefetch 2 {ref['losses']}")
    out["adamw_card_prefetch0"] = run

    def against_ref(state, start):
        """The parameters that differ from the on-card run's; the distance
        from them over that run's travel, in all and by parameter."""
        differ, by_name = [], {}
        for n, p in state.model.named_parameters():
            p = p.detach().to("cpu")
            if not torch.equal(p, p_ref[n]):
                differ.append(n)
            by_name[n] = float((p.double() - p_ref[n].double()).pow(2).sum())
        worst = sorted(by_name, key=by_name.get, reverse=True)[:3]
        return differ, sum(by_name.values()) ** 0.5 / travel, {
            n: by_name[n] ** 0.5 / travel for n in worst}

    for dtype in ("float32", "bfloat16", "int8"):
        name = f"adamw_offload_{dtype}"
        run = optimizer_run(card, name, OPT_LAYERS, OPT_STEPS, OPT_ADAMW, inspect=against_ref,
                            offload_optimizer_state=True, offload_state_dtype=dtype,
                            offload_quant_block=OPT_BLOCK)
        differ, run["param_rel_err"], run["param_rel_err_worst"] = run.pop("inspect")
        run["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
        out[name] = run
        if dtype == "float32":
            check(run["losses"] == ref["losses"] and not differ,
                  f"optimizer: float32 offload is not bit-equal to the state on the card: "
                  f"losses {run['losses']} vs {ref['losses']}, parameters differ {differ[:4]}")
            continue
        limit = OFFLOAD_LIMITS[dtype]
        print(f"optimizer {name}: against the state on the card, losses of steps 1-2 "
              f"{'bit-equal' if run['losses'][:2] == ref['losses'][:2] else 'DIFFERENT'}, "
              f"within {run['loss_rel_err']:.3e} (limit {limit['loss']}); parameters "
              f"{run['param_rel_err']:.3e} of the update's travel (limit {limit['params']}), "
              "largest shares " + ", ".join(f"{n} {e:.3e}" for n, e in
                                            run["param_rel_err_worst"].items()), flush=True)
        check(run["losses"][:2] == ref["losses"][:2] and run["loss_rel_err"] <= limit["loss"]
              and run["param_rel_err"] <= limit["params"],
              f"optimizer: {dtype} offload left its limits")
    del p_ref
    release()

    # 2-3. full depth: AdamW with int8 state in pinned host memory; Adafactor on the card
    for name, optim, offload in (
        ("adamw_int8_full", OPT_ADAMW, dict(offload_optimizer_state=True,
                                            offload_state_dtype="int8",
                                            offload_quant_block=OPT_BLOCK)),
        ("adafactor_full", OPT_ADAFACTOR, {}),
    ):
        run = optimizer_run(card, name, OPT_FULL_LAYERS, OPT_FULL_STEPS, optim, **offload)
        losses = run["losses"]
        check(abs(losses[0] - math.log(full.vocab_size)) <= OPT_LN_V_ATOL
              and losses[2] < losses[0] and losses[3] < losses[1],
              f"optimizer {name}: losses {losses} (ln V = {math.log(full.vocab_size):.4f})")
        check((run["host_bytes"] > 0) == bool(offload),
              f"optimizer {name}: {run['host_bytes']} bytes of state in host memory")
        out[name] = run

    # 4. Lion with its state on the card
    run = optimizer_run(card, "lion_card", OPT_LAYERS, OPT_STEPS, OPT_LION)
    check(run["losses"][2] < run["losses"][0], f"optimizer lion: losses {run['losses']}")
    out["lion_card"] = run
    return out


@dataclass
class SkipRowsConfig:
    seq: int = TRAIN_SEQ
    rows: int = 4
    vocab: int = 128256
    seed: int = 0
    max_doc: int = RES_MAX_DOC


class SkipRows:
    """The packed rows through the port's seeded `BaseDataModule` stream,
    one row a batch, so a fit under recovery can hand it its skip list (a
    config node builds it: `{"class_path": "chip_smoke.SkipRows"}`)."""

    def __init__(self, config: SkipRowsConfig | None = None):
        self.config = config or SkipRowsConfig()
        self.module = None

    def setup(self):
        if self.module is None:
            from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig

            c = self.config
            self.module = BaseDataModule(BaseDataModuleConfig(batch_size=1, seed=c.seed))
            self.module.train_dataset = packed_batches(c.seed, c.seq, c.rows, c.vocab, c.max_doc)
            self.module.collate = lambda examples: examples[0]

    def train_batches(self, start_step=0, skip_list=None):
        return self.module.train_batches(start_step, skip_list)

    def val_batches(self):
        return iter(())


class FitClock:
    """Synchronized step times, losses and health of a fit."""

    def __init__(self):
        self.step_s, self.losses, self.health, self.t = [], {}, [], None

    def on_fit_start(self, trainer, *args):
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def on_train_step(self, trainer, step):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.step_s.append(now - self.t)
        self.t = now
        if trainer.last_health is not None:
            self.health.append(dict(trainer.last_health))

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = metrics["loss"]


def res_model_kwargs(layers: int) -> dict:
    from dataclasses import asdict

    from llm_training_tpu_torch.models.llama.config import preset

    return asdict(preset("llama-3.1-8b", num_hidden_layers=layers, param_dtype="float32",
                         compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                         recompute_granularity="selective"))


def res_rows(rows: int = 4) -> dict:
    """SkipRows' config node for this run's row length and vocabulary."""
    return dict(seq=TRAIN_SEQ, rows=rows, vocab=res_model_kwargs(LIFE_LAYERS)["vocab_size"],
                max_doc=RES_MAX_DOC)


def res_fit(trainer_config, callbacks, layers: int, optim: dict, data, checkpointer=None):
    """One `Trainer.fit` with the K1/K2/K3 counts set to 0 just before:
    (trainer, state, launches, plain calls, wall seconds)."""
    from llm_training_tpu_torch.lms.base import ModelProvider
    from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.optim.builder import OptimConfig
    from llm_training_tpu_torch.trainer.trainer import Trainer

    trainer = Trainer(trainer_config, callbacks=callbacks, device=RES_DEVICE,
                      checkpointer=checkpointer)
    objective = CLM(CLMConfig(model=ModelProvider("Llama", res_model_kwargs(layers)),
                              optim=OptimConfig(**optim)))
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    release()
    torch.cuda.reset_peak_memory_stats()
    with count_plain_attention() as plain:
        for launcher in launchers:
            launcher.launches = 0
        t0 = time.perf_counter()
        state = trainer.fit(objective, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [launcher.launches for launcher in launchers]
    return trainer, state, launches, plain[0], wall


def res_health(card: str) -> dict:
    """Leg a: health every step, NanGuard, the time estimator, the JSONL
    logger and the watchdog on, against all of them off (see the header)."""
    from llm_training_tpu_torch.callbacks.loggers import JsonlLogger, JsonlLoggerConfig
    from llm_training_tpu_torch.callbacks.nan_guard import NanGuard, NanGuardConfig
    from llm_training_tpu_torch.callbacks.time_estimator import (
        TrainingTimeEstimator,
        TrainingTimeEstimatorConfig,
    )
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.resilience import ResilienceConfig
    from llm_training_tpu_torch.telemetry import PHASES, HealthConfig
    from llm_training_tpu_torch.trainer.trainer import TrainerConfig

    keys_file = ROOT / "llm_training_tpu_torch" / "telemetry" / "health_keys.json"
    expected_keys = json.loads(keys_file.read_text())[f"llama-3.1-8b, {RES_LAYERS} layers"]
    rows = SkipRowsConfig(**res_rows(OPT_ROWS))  # phase 14's two rows
    runs = {}
    for name in ("health", "plain"):
        on = name == "health"
        clock = FitClock()
        callbacks = [clock]
        estimator = None
        if on:
            estimator = TrainingTimeEstimator(TrainingTimeEstimatorConfig(
                num_steps=RES_STEPS - 2, skip_first_n_steps=1))
            callbacks += [NanGuard(NanGuardConfig(spike_zscore=6.0)), estimator,
                          JsonlLogger(JsonlLoggerConfig(save_dir=str(RES_DIR), project="a",
                                                        name="health"))]
        config = TrainerConfig(
            max_steps=RES_STEPS, seed=0, log_every_n_steps=1,
            health=HealthConfig(every_n_steps=1 if on else None),
            resilience=ResilienceConfig(watchdog_timeout_s=300.0 if on else None))
        trainer, state, launches, plain, wall = res_fit(config, callbacks, RES_LAYERS, OPT_ADAMW,
                                                        SkipRows(rows))
        peak = torch.cuda.max_memory_allocated()
        params = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
        runs[name] = dict(clock=clock, launches=launches, plain=plain, wall=wall, peak=peak,
                          params=params, record=trainer.last_telemetry,
                          estimator=estimator.result if estimator else None,
                          n_params=sum(p.numel() for p in params.values()),
                          n_embed=state.model.model.embed_tokens.weight.numel())
        expected = [RES_LAYERS * RES_STEPS] * 3
        check(launches == expected and plain == 0,
              f"resilience health ({name}): K1/K2/K3 launched {launches}, expected {expected}; "
              f"plain path {plain}")
        del trainer, state
        release()
    on, off = runs["health"], runs["plain"]
    losses_on = [on["clock"].losses[s] for s in sorted(on["clock"].losses)]
    losses_off = [off["clock"].losses[s] for s in sorted(off["clock"].losses)]
    differ = [n for n in on["params"] if not torch.equal(on["params"][n], off["params"][n])]
    check(losses_on == losses_off and not differ,
          f"resilience health: health on changed the math: losses {losses_on} vs {losses_off}, "
          f"parameters differ {differ[:4]}")
    n_tensors = len(on["params"])
    del on["params"], off["params"]
    health = on["clock"].health
    check(len(health) == RES_STEPS and all(sorted(h) == expected_keys for h in health),
          f"resilience health: {len(health)} health steps; keys "
          f"{sorted(set(health[-1]) ^ set(expected_keys)) if health else 'none'} differ from "
          f"JAX's set ({keys_file.name})")
    check(all(math.isfinite(v) for h in health for v in h.values()),
          "resilience health: a norm is not finite")
    record = on["record"]
    phases = {p: record[f"goodput/{p}_s"] for p in (*PHASES, "other")}
    total = record["goodput/total_s"]
    check(abs(sum(phases.values()) - total) <= 1e-6 * total
          and abs(total - on["wall"]) <= 0.01 * on["wall"],
          f"resilience health: goodput phases {phases} sum {sum(phases.values()):.3f} s, total "
          f"{total:.3f} s, the fit's wall {on['wall']:.3f} s")
    hbm_peak = record["hbm/peak_bytes_in_use"]
    check(abs(hbm_peak - on["peak"]) <= 0.01 * on["peak"],
          f"resilience health: hbm/peak_bytes_in_use {hbm_peak} against "
          f"torch.cuda.max_memory_allocated {on['peak']}")
    # the smoke's own MFU: N without the embedding table, attention over the
    # visible (q, k) pairs; the two rows alternate, so a step is their mean
    batches = packed_batches(0, rows.seq, rows.rows, rows.vocab, rows.max_doc)
    kw = res_model_kwargs(RES_LAYERS)
    tokens = [int((b["segment_ids"] > 0).sum()) for b in batches]
    flops = [6 * (on["n_params"] - on["n_embed"]) * t
             + 12 * kw["num_attention_heads"] * kw["head_dim"] * RES_LAYERS
             * bench_flash.visible_pairs(
                 *(torch.as_tensor(b["segment_ids"], device=RES_DEVICE),) * 2)
             for b, t in zip(batches, tokens)]
    out = {f"step_ms_p50_{name}": 1e3 * percentile(run["clock"].step_s[1:], 50)
           for name, run in runs.items()}
    step_s = out["step_ms_p50_plain"] / 1e3
    out.update(
        overhead_pct=100 * (out["step_ms_p50_health"] / out["step_ms_p50_plain"] - 1),
        smoke_tokens_per_s=sum(tokens) / len(tokens) / step_s,
        smoke_mfu=sum(flops) / len(flops) / step_s / bench_flash.BF16_FLOPS_PER_S,
        estimator=on["estimator"], goodput=phases, goodput_pct=record["goodput/goodput_pct"],
        wall_s=on["wall"], hbm_peak=hbm_peak, losses=losses_on, launches=on["launches"],
        health_keys=len(expected_keys),
        health_last={k: v for k, v in health[-1].items() if "layers_00" in k or "lm_head" in k},
    )
    est = on["estimator"] or {}
    print(f"resilience health [{card}]: {RES_LAYERS} layers ({on['n_params']} params), "
          f"{RES_STEPS} steps of 1 x {TRAIN_SEQ} packed tokens, AdamW on the card; health every "
          f"step + NanGuard + TrainingTimeEstimator + JsonlLogger + watchdog 300 s against all "
          f"off: losses and {n_tensors} parameters bit-equal; {len(expected_keys)} health keys = "
          f"JAX's, all finite; K1/K2/K3 {on['launches']}, plain 0; step p50 "
          f"{out['step_ms_p50_health']:.1f} ms with health, {out['step_ms_p50_plain']:.1f} ms "
          f"without (overhead {out['overhead_pct']:.2f}%)", flush=True)
    print(f"resilience goodput [{card}]: wall {on['wall']:.3f} s, total {total:.3f} s; "
          + ", ".join(f"{p} {v:.3f} s" for p, v in phases.items())
          + f"; goodput {record['goodput/goodput_pct']:.2f}%; hbm/peak {hbm_peak:.0f} B, "
          f"max_memory_allocated {on['peak']} B", flush=True)
    print(f"resilience MFU [{card}]: TrainingTimeEstimator {est.get('tokens_per_sec', 0):.0f} "
          f"tokens/s, MFU {100 * est.get('mfu', float('nan')):.2f}% (6 N T with N every "
          f"parameter, the embedding table included, plus 12 L H S T: every (q, k) pair of the "
          f"full row); the smoke's own {out['smoke_tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * out['smoke_mfu']:.2f}% (N without the embedding table, attention over the "
          f"visible pairs of the packed rows, the health-off step)", flush=True)
    return out


def res_rollback(card: str) -> dict:
    """Leg b: NaN then spike injected, rolled back in-process and skipped,
    against a clean run with the same skip windows; then the CLI's exit 76
    (see the header)."""
    from llm_training_tpu_torch.callbacks.nan_guard import NanGuard, NanGuardConfig
    from llm_training_tpu_torch.cli.main import main as cli_main
    from llm_training_tpu_torch.resilience import ChaosConfig, RecoveryConfig, ResilienceConfig
    from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
    from llm_training_tpu_torch.trainer.trainer import TrainerConfig

    class SaveOnce:
        """Veto every save after step 2's (the rollback target)."""

        def on_train_step(self, trainer, step):
            if step > 2:
                trainer.abort_final_save = True

    def guard():
        return NanGuard(NanGuardConfig(spike_zscore=RES_SPIKE_Z, spike_warmup_steps=2))

    steps = 6
    faulty = FitClock()
    checkpointer = Checkpointer(CheckpointConfig(dirpath=str(RES_DIR / "b"), async_save=False))
    config = TrainerConfig(
        max_steps=steps, seed=0, log_every_n_steps=1, checkpoint_every_n_steps=2,
        resilience=ResilienceConfig(chaos=ChaosConfig(nan_step=3, spike_step=4),
                                    recovery=RecoveryConfig(max_rollbacks=2)))
    trainer, state, launches, plain, _ = res_fit(
        config, [faulty, guard(), SaveOnce()], LIFE_LAYERS, RES_SGD,
        SkipRows(SkipRowsConfig(**res_rows())), checkpointer)
    checkpointer.close()
    rollbacks = [dict(r) for r in trainer.rollbacks]
    windows = list(trainer._recovery.skip_list.windows)
    snapshot = trainer.telemetry.snapshot()
    check(state.step == steps and [(r["failed_step"], r["failure"], r["restored_micro"])
                                   for r in rollbacks]
          == [(3, "NonFiniteLossError", 2), (4, "LossSpikeError", 2)]
          and windows == [(2, 1), (3, 1)] and checkpointer.all_steps() == [2],
          f"resilience rollback: step {state.step}, rollbacks {rollbacks}, windows {windows}, "
          f"committed {checkpointer.all_steps()}")
    check(min(launches) > 0 and plain == 0,
          f"resilience rollback: K1/K2/K3 launched {launches}, plain path {plain}")
    del trainer, state
    release()
    clean = FitClock()
    config = TrainerConfig(max_steps=steps, seed=0, log_every_n_steps=1, resilience=(
        ResilienceConfig(recovery=RecoveryConfig(max_rollbacks=2, skip_windows=tuple(windows)))))
    trainer, state, launches_clean, plain_clean, _ = res_fit(
        config, [clean, guard()], LIFE_LAYERS, RES_SGD, SkipRows(SkipRowsConfig(**res_rows())))
    del trainer, state
    release()
    check(faulty.losses == clean.losses and sorted(clean.losses) == list(range(1, steps + 1)),
          f"resilience rollback: healed losses {faulty.losses} against the clean run's with the "
          f"same skip windows {clean.losses}")
    check(launches_clean == [LIFE_LAYERS * steps] * 3 and plain_clean == 0,
          f"resilience rollback: the clean run launched K1/K2/K3 {launches_clean}")

    # the CLI: max_rollbacks 1 and a second fault exits 76 (no checkpointer: the
    # rollback rebuilds the model from the seed, nothing goes to disk)
    cli_config = {
        "seed_everything": 0,
        "trainer": {"max_steps": 5, "seed": 0, "log_every_n_steps": 1,
                    "callbacks": [{"class_path": "llm_training_tpu.callbacks.NanGuard",
                                   "init_args": {"spike_zscore": RES_SPIKE_Z,
                                                 "spike_warmup_steps": 2}}],
                    "resilience": {"chaos": {"nan_step": 3, "spike_step": 4},
                                   "recovery": {"max_rollbacks": 1}}},
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": res_model_kwargs(LIFE_LAYERS)},
            "optim": RES_SGD}},
        "data": {"class_path": "chip_smoke.SkipRows", "init_args": res_rows()},
    }
    path = RES_DIR / "exhaust.json"
    path.write_text(json.dumps(cli_config))
    release()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["fit", "--config", str(path), "--device", RES_DEVICE])
    check(rc == 76, f"resilience rollback: the CLI exited {rc} with its budget spent, expected 76")
    release()
    out = dict(rollbacks=rollbacks, windows=[list(w) for w in windows], losses=faulty.losses,
               rollback_s=[r["seconds"] for r in rollbacks],
               chaos_injections=snapshot.get("resilience/chaos_injections"), exhaust_rc=rc)
    print(f"resilience rollback [{card}]: {LIFE_LAYERS} layers at full width, SGD, {steps} steps, "
          f"one committed save (step 2); chaos NaN at step 3 and spike at step 4: NanGuard raised "
          f"{[r['failure'] for r in rollbacks]}, rolled back in-process to micro-step "
          f"{[r['restored_micro'] for r in rollbacks]}, skipped windows {windows}, finished; "
          f"losses bit-equal to a clean run with the same skip windows; rollback seconds "
          f"(restore included) " + ", ".join(f"{s:.3f}" for s in out["rollback_s"])
          + f"; with max_rollbacks 1 the CLI exited {rc}", flush=True)
    return out


def res_run_config(name: str, trainer: dict) -> Path:
    """A JSON config of leg c: the 2-layer model, SGD, the packed rows, a
    JSONL logger into `RES_DIR/c/<name>/run`."""
    node = {"max_steps": 4, "seed": 0, "log_every_n_steps": 1,
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": str(RES_DIR / "c"), "project": name,
                                       "name": "run"}}]}
    node.update(trainer)
    config = {
        "seed_everything": 0, "trainer": node,
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": res_model_kwargs(LIFE_LAYERS)},
            "optim": RES_SGD}},
        "data": {"class_path": "chip_smoke.SkipRows", "init_args": res_rows()},
    }
    path = RES_DIR / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def res_launch(path: Path, log: Path):
    """`python -m llm_training_tpu_torch fit --config path` in a process of
    its own, its output into `log`: (process, log handle)."""
    import subprocess

    handle = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m", "llm_training_tpu_torch", "fit", "--config",
                             str(path), "--device", RES_DEVICE], cwd=ROOT, stdout=handle,
                            stderr=subprocess.STDOUT)
    return proc, handle


def res_wait(launched, timeout: float = 300) -> int:
    """The process's exit code; killed (and waited for) on the timeout."""
    proc, handle = launched
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        handle.close()


def res_losses(name: str) -> dict[int, float]:
    rows = (RES_DIR / "c" / name / "run" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, rows) if "loss" in r}


def res_processes(card: str) -> dict:
    """Leg c: preemption (exit 75, the relaunch resumes bit-equal), the
    watchdog's hang dump and a retried data error, through the CLI in
    processes of their own (see the header)."""
    logs = RES_DIR / "c" / "logs"
    logs.mkdir(parents=True)
    clean = res_run_config("clean", {})
    preempt = res_run_config("preempt", {
        "checkpoint": {"dirpath": str(RES_DIR / "c" / "ckpt"), "async_save": False},
        "resilience": {"chaos": {"sigterm_step": 2}}})
    faults = res_run_config("faults", {"resilience": {
        "watchdog_timeout_s": RES_WATCHDOG_S, "data_retries": 2, "data_retry_backoff_s": 0.1,
        "chaos": {"data_error_steps": [2], "slow_step_s": RES_STALL_S, "slow_step_from": 4}}})
    t0 = time.perf_counter()
    # three processes at once on the card (~20 GB each), then the relaunch
    procs = {name: res_launch(path, logs / f"{name}.log")
             for name, path in (("clean", clean), ("preempt", preempt), ("faults", faults))}
    try:
        rcs = {name: res_wait(launched) for name, launched in procs.items()}
    finally:
        for proc, handle in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            handle.close()
    text = {name: (logs / f"{name}.log").read_text() for name in procs}
    expected_rcs = {"clean": 0, "preempt": 75, "faults": 0}
    check(rcs == expected_rcs, f"resilience processes: exit codes {rcs}, expected "
          f"{expected_rcs}; tails: " + "; ".join(f"{n}: {text[n][-800:]}" for n in rcs
                                                 if rcs[n] != expected_rcs[n]))
    committed = sorted(p.name for p in (RES_DIR / "c" / "ckpt").iterdir())
    check("resumable code 75" in text["preempt"] and committed == ["manifest-2.json", "step_2"],
          f"resilience processes: the preempted run committed {committed}")
    rc = res_wait(res_launch(preempt, logs / "relaunch.log"))
    check(rc == 0, f"resilience processes: the relaunch exited {rc}: "
          f"{(logs / 'relaunch.log').read_text()[-800:]}")
    seconds = time.perf_counter() - t0
    want = res_losses("clean")
    preempted = res_losses("preempt")
    check(sorted(want) == [1, 2, 3, 4] and preempted == want,
          f"resilience processes: interrupted + resumed losses {preempted} against "
          f"uninterrupted {want}")
    telemetry = (RES_DIR / "c" / "preempt" / "run" / "telemetry.jsonl").read_text().splitlines()
    emergency = [json.loads(line) for line in telemetry if "resilience/emergency_saves" in line]
    check(bool(emergency) and emergency[0]["resilience/preemptions"] == 1,
          "resilience processes: no emergency-save record in the preempted run's telemetry")
    dumps = sorted((RES_DIR / "c" / "faults" / "run").glob("hang-dump-*.txt"))
    # the stall is step 4's boundary: the loop's last beat was micro-step 3
    stall = [d.read_text() for d in dumps]
    stall = [t for t in stall if "(step 3)" in t and "--- thread MainThread" in t
             and "goodput phase open at stall:" in t]
    check(bool(stall), f"resilience processes: no hang dump of the stall among "
          f"{[d.name for d in dumps]}")
    dump = stall[0]
    faults_telemetry = json.loads(
        (RES_DIR / "c" / "faults" / "run" / "telemetry.jsonl").read_text().splitlines()[-1])
    check(faults_telemetry.get("data/retries") == 1 and res_losses("faults") == want
          and faults_telemetry.get("resilience/watchdog_dumps", 0) >= 1,
          f"resilience processes: data/retries {faults_telemetry.get('data/retries')}, watchdog "
          f"dumps {faults_telemetry.get('resilience/watchdog_dumps')}, losses "
          f"{res_losses('faults')} against {want}")
    phase_line = next(line for line in dump.splitlines() if line.startswith("goodput phase"))
    out = dict(exit_codes={**rcs, "relaunch": rc}, losses=want, seconds=seconds,
               hang_dumps=[d.name for d in dumps], dump_phase=phase_line,
               data_retries=faults_telemetry["data/retries"])
    print(f"resilience processes [{card}]: fit in processes of its own, {LIFE_LAYERS} layers, 4 "
          f"steps: SIGTERM at step 2 -> emergency save, exit 75, the relaunch resumed at step 3 "
          f"and its losses equal the uninterrupted run's bit for bit; a {RES_STALL_S} s stall "
          f"against a {RES_WATCHDOG_S} s watchdog wrote a hang dump ('{phase_line}', the "
          f"main thread's stack) and the run completed; a data error at batch 2 retried once "
          f"(data/retries 1), losses equal the clean run's; {seconds:.1f} s", flush=True)
    return out


def phase_resilience(card: str) -> dict:
    """Telemetry and resilience around fit (see the header)."""
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    shutil.rmtree(RES_DIR, ignore_errors=True)
    RES_DIR.mkdir()
    out = {}
    try:
        for name, leg in (("health", res_health), ("rollback", res_rollback),
                          ("processes", res_processes)):
            t0 = time.perf_counter()
            out[name] = leg(card)
            out[name]["leg_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(RES_DIR, ignore_errors=True)
        release()
    return out



# ------------------------------------------------------ phase 16: durability


def dur_config(name: str, trainer: dict | None = None, checkpoint: dict | None = None) -> dict:
    """Phase 15's 2-layer full-width model, SGD and packed rows for 4 steps,
    saving every 2 steps (`verify: full`, three kept) into
    `DUR_DIR/<name>/ckpt`, a JSONL logger into `DUR_DIR/<name>/run/log`."""
    node = {"max_steps": DUR_STEPS, "seed": 0, "log_every_n_steps": 1,
            "checkpoint_every_n_steps": 2,
            "checkpoint": {"dirpath": str(DUR_DIR / name / "ckpt"), "max_to_keep": 3,
                           "verify": "full", **(checkpoint or {})},
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": str(DUR_DIR / name), "project": "run",
                                       "name": "log"}}]}
    node.update(trainer or {})
    return {
        "seed_everything": 0, "trainer": node,
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": res_model_kwargs(LIFE_LAYERS)},
            "optim": RES_SGD}},
        "data": {"class_path": "chip_smoke.SkipRows", "init_args": res_rows()},
    }


def dur_compare(got: dict, want: dict) -> dict:
    """Tensors of two state dicts: how many differ in any bit, and the
    largest |difference| over the largest |value| of a tensor."""
    differ, worst = [], 0.0
    for name, ref in want.items():
        value = got[name].detach().to("cpu")
        if not torch.equal(value, ref):
            differ.append(name)
            scale = float(ref.abs().max()) or 1.0
            worst = max(worst, float((value.float() - ref.float()).abs().max()) / scale)
    return dict(tensors=len(want), differ=len(differ), max_rel=worst)


def dur_losses(name: str) -> dict[int, float]:
    rows = (DUR_DIR / name / "run" / "log" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, rows) if "loss" in r}


def dur_in_process(card: str) -> dict:
    """Leg a: the clean fit (manifests, mirror, both copies verify); a
    flipped byte in the primary step 4 healed from the mirror at restore;
    both copies of step 4 rotten, the fit falls back to step 2 and re-runs
    steps 3-4 (see the header)."""
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.resilience import durability
    from llm_training_tpu_torch.telemetry.registry import TelemetryRegistry, set_registry

    root, mirror = DUR_DIR / "a" / "ckpt", DUR_DIR / "a" / "mirror"
    config = dur_config("a", checkpoint={"mirror_dir": str(mirror), "mirror_interval_s": 0.5,
                                         "scrub_interval_s": 0})
    t0 = time.perf_counter()
    losses, trainer, launches, plain = fit_leg(config)
    fit_s = time.perf_counter() - t0
    clean = {k: v.detach().to("cpu", copy=True) for k, v in trainer.state.state_dict().items()}
    snap = trainer.telemetry.snapshot()
    manifest = dict(trainer.checkpointer.last_manifest)
    t1 = time.perf_counter()
    trainer.checkpointer.close()  # drains the mirror
    close_s = time.perf_counter() - t1
    del trainer
    release()
    losses = {s: float(v) for s, v in losses.items()}
    check(sorted(losses) == [1, 2, 3, 4] and min(launches) > 0 and plain == 0,
          f"durability: the clean fit logged {sorted(losses)}, K1/K2/K3 {launches}, plain {plain}")
    check(durability.committed_steps(root) == [2, 4] == durability.manifested_steps(root)
          and durability.committed_steps(mirror) == [2, 4],
          f"durability: primary {durability.committed_steps(root)} (manifested "
          f"{durability.manifested_steps(root)}), mirror {durability.committed_steps(mirror)}")
    verify_s = {}
    for label, where in (("primary", root), ("mirror", mirror)):
        t1 = time.perf_counter()
        result = durability.verify_step(where, 4, mode="full")
        verify_s[label] = time.perf_counter() - t1
        check(result.ok and durability.verify_step(where, 2, mode="fast").ok,
              f"durability: the {label} copy of step 4 does not verify: {result.findings}")
    step_bytes = durability.load_manifest(root, 4)["total_bytes"]

    # heal: one flipped byte in the primary step 4, a new Trainer restores it
    victim = durability.corrupt_step(root, 4, "flip")
    trainer, objective, _ = build_fit(config, LIFE_DEVICE)
    state, _ = trainer.init_state(objective)
    registry = TelemetryRegistry()
    previous = set_registry(registry)
    try:
        t1 = time.perf_counter()
        meta = trainer.checkpointer.maybe_restore(state)
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t1
    finally:
        set_registry(previous)
    healed = dur_compare(state.state_dict(), clean)
    heal_counts = {k: registry.snapshot().get(k, 0) for k in DUR_COUNTERS}
    trainer.checkpointer.close()
    del trainer, objective, state
    release()
    check(meta["step"] == 4 and healed["differ"] == 0
          and heal_counts == {"checkpoint/verify_failures": 1, "checkpoint/mirror_restores": 1,
                              "resilience/restore_fallbacks": 0},
          f"durability heal: restored step {meta['step']}, {healed}, counters {heal_counts}")
    check(durability.verify_step(root, 4, mode="full").ok, "durability heal: step 4 not whole")

    # fall back: both copies of step 4 rotten; the fit restores step 2, deletes
    # step 4 and re-runs steps 3-4
    durability.corrupt_step(root, 4, "flip")
    durability.corrupt_step(mirror, 4, "flip")
    ladder = {}

    class TimeRestore:
        def on_fit_start(self, trainer, objective, datamodule, start_step):
            ladder["start_step"] = start_step

    def timed(restore):
        def run(*args, **kwargs):
            t1 = time.perf_counter()
            meta = restore(*args, **kwargs)
            torch.cuda.synchronize()
            ladder["seconds"] = time.perf_counter() - t1
            ladder["steps_after"] = durability.committed_steps(root)
            return meta
        return run

    from llm_training_tpu_torch.cli import main as cli

    build = cli.build_fit

    def build_timed(*args, **kwargs):
        trainer, objective, datamodule = build(*args, **kwargs)
        trainer.checkpointer.maybe_restore = timed(trainer.checkpointer.maybe_restore)
        return trainer, objective, datamodule

    cli.build_fit = build_timed
    try:
        resumed, trainer, launches_b, plain_b = fit_leg(config, [TimeRestore()])
    finally:
        cli.build_fit = build
    fallback_counts = {k: trainer.telemetry.snapshot().get(k, 0) for k in DUR_COUNTERS}
    trainer.checkpointer.close()
    del trainer
    release()
    resumed = {s: float(v) for s, v in resumed.items()}
    rel = {s: abs(resumed[s] - losses[s]) / abs(losses[s]) for s in (3, 4)}
    check(ladder.get("start_step") == 2 and ladder["steps_after"] == [2]
          and sorted(resumed) == [3, 4] and max(rel.values()) <= RESUME_RTOL
          and fallback_counts == {"checkpoint/verify_failures": 1,
                                  "checkpoint/mirror_restores": 0,
                                  "resilience/restore_fallbacks": 1}
          and min(launches_b) > 0 and plain_b == 0,
          f"durability fallback: {ladder}, losses {resumed} against {losses}, counters "
          f"{fallback_counts}, K1/K2/K3 {launches_b}, plain {plain_b}")
    out = dict(
        losses=losses, fit_s=fit_s, close_s=close_s, launches=launches, step_bytes=step_bytes,
        manifest_s=snap.get("checkpoint/manifest_s"), manifests=snap.get("checkpoint/manifest_n"),
        last_manifest=manifest, manifest_gbps=manifest["bytes"] / manifest["seconds"] / 1e9,
        mirror_drain_s=snap.get("checkpoint/mirror_drain_s"), wait_s=snap.get("checkpoint/wait_s"),
        verify_full_s=verify_s, victim=victim, heal_s=heal_s, heal_counts=heal_counts,
        fallback_s=ladder["seconds"], fallback_counts=fallback_counts, resumed=resumed,
        resumed_bit_equal=all(resumed[s] == losses[s] for s in (3, 4)),
        resumed_max_rel=max(rel.values()), launches_fallback=launches_b)
    print(f"durability in process [{card}]: {LIFE_LAYERS} layers at full width, SGD, "
          f"{DUR_STEPS} steps, saves at 2 and 4 of {step_bytes / 1e9:.3f} GB each, "
          f"verify full, a mirror on the same disk: {out['manifests']:.0f} manifests in "
          f"{out['manifest_s']:.3f} s on the training thread (the last: "
          f"{manifest['seconds']:.3f} s, {out['manifest_gbps']:.3f} GB/s hashed); the fit "
          f"{fit_s:.1f} s (its wait {out['wait_s']:.3f} s, mirror drain "
          f"{out['mirror_drain_s']:.3f} s), close {close_s:.3f} s; full verify of step 4 "
          f"{verify_s['primary']:.3f} s (primary), {verify_s['mirror']:.3f} s (mirror); a "
          f"flipped byte in {victim} healed from the mirror in {heal_s:.3f} s, every tensor "
          f"bit-equal, counters {heal_counts}; both copies rotten: the fit fell back to step 2 "
          f"in {ladder['seconds']:.3f} s, deleted step 4, re-ran steps 3-4 with losses "
          + ("bit-equal" if out["resumed_bit_equal"] else
             f"within {out['resumed_max_rel']:.2e} relative") + f", counters {fallback_counts}",
          flush=True)
    return out, clean


def dur_supervise(name: str, config: dict, env: dict, args: list[str], timeout: float = 420):
    """`python -m llm_training_tpu_torch supervise` in a session of its own
    (its children with it, all killed on the timeout): (exit code, wall
    seconds, the supervisor's events, its output)."""
    import signal
    import subprocess

    path = DUR_DIR / f"{name}.json"
    path.write_text(json.dumps(config))
    log = DUR_DIR / f"{name}-supervisor.jsonl"
    out_path = DUR_DIR / f"{name}.log"
    cmd = [sys.executable, "-m", "llm_training_tpu_torch", "supervise", "--config", str(path),
           "--backoff-base-s", "0", "--max-restarts", "2", "--log", str(log), *args]
    t0 = time.perf_counter()
    with open(out_path, "w") as handle:
        proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **env}, stdout=handle,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall = time.perf_counter() - t0
    events = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
    return rc, wall, events, out_path.read_text()


def dur_lifecycle(events: list[dict]) -> list[tuple]:
    return [(e["event"], e.get("signal")) for e in events if e["event"] != "segment_topology"]


HEALED = [("launch", None), ("exit", "SIGKILL"), ("restart", None), ("launch", None),
          ("exit", None), ("complete", None)]


def dur_processes(card: str, clean: dict, clean_losses: dict) -> dict:
    """Leg b: a chaos SIGKILL at step 3 under `supervise`, healed by the
    relaunch; then a SIGKILL inside a forced final save's swap, healed by
    promoting `.stale/step_4` (see the header)."""
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.resilience import durability

    root = DUR_DIR / "b" / "ckpt"
    config = dur_config("b", checkpoint={"async_save": False})
    rc, wall, events, text = dur_supervise(
        "sigkill", config, {"LLMT_CHAOS_SIGKILL_STEP": "3"},
        ["--child-args", f"--device {LIFE_DEVICE}"])
    check(rc == 0 and dur_lifecycle(events) == HEALED
          and [e["attempt"] for e in events if e["event"] == "segment_topology"] == [1, 2],
          f"durability supervise: exit {rc}, events {dur_lifecycle(events)}: {text[-1500:]}")
    runtimes = [e["runtime_s"] for e in events if e["event"] == "exit"]
    losses = {s: float(v) for s, v in dur_losses("b").items()}
    rel = max(abs(losses[s] - clean_losses[s]) / abs(clean_losses[s]) for s in clean_losses)
    trainer, objective, _ = build_fit(config, LIFE_DEVICE)
    state = trainer.restore_for_inference(objective)
    final = dur_compare({f"model.{k}": v for k, v in state.model.state_dict().items()},
                        {k: v for k, v in clean.items() if k.startswith("model.")})
    trainer.checkpointer.close()
    del trainer, objective, state
    release()
    check(sorted(losses) == [1, 2, 3, 4] and rel <= RESUME_RTOL
          and (final["differ"] == 0 or final["max_rel"] <= DUR_PARAM_RTOL),
          f"durability supervise: losses {losses} against {clean_losses}, final parameters "
          f"{final}")

    # a forced final save killed inside its swap: the first launch resumes
    # step 2 (--ckpt-path), runs steps 3-4 with no interval save, and its final
    # save over the committed step 4 dies on SIGKILL between the renames; the
    # relaunch promotes .stale/step_4 and finds nothing left to do
    before = durability.load_manifest(root, 4)
    rc_swap, wall_swap, swap_events, swap_text = dur_supervise(
        "swap", config, {"LLMT_CHAOS_CKPT_KILL_IN_SWAP": "4"},
        ["--ckpt-path", "2", "--child-args",
         f"--device {LIFE_DEVICE} trainer.checkpoint_every_n_steps=null"])
    promoted = "promoted staged checkpoint step 4" in swap_text
    check(rc_swap == 0 and dur_lifecycle(swap_events) == HEALED and promoted
          and durability.committed_steps(root) == [2, 4]
          and durability.load_manifest(root, 4) == before
          and durability.verify_step(root, 4, mode="full").ok
          and not (root / durability.STALE_DIR).exists(),
          f"durability kill-in-swap: exit {rc_swap}, events {dur_lifecycle(swap_events)}, "
          f"promoted {promoted}, steps {durability.committed_steps(root)}: {swap_text[-1500:]}")
    swap_runtimes = [e["runtime_s"] for e in swap_events if e["event"] == "exit"]
    out = dict(rc=rc, wall_s=wall, runtimes=runtimes,
               restarts=sum(e["event"] == "restart" for e in events), losses=losses,
               losses_bit_equal=losses == clean_losses, max_rel_loss=rel, final=final,
               swap_rc=rc_swap, swap_wall_s=wall_swap, swap_runtimes=swap_runtimes,
               swap_restarts=sum(e["event"] == "restart" for e in swap_events))
    print(f"durability processes [{card}]: supervise with LLMT_CHAOS_SIGKILL_STEP=3: the child "
          f"died on SIGKILL after {runtimes[0]:.1f} s, the relaunch restored step 2 and "
          f"completed in {runtimes[1]:.1f} s ({out['restarts']} restart, {wall:.1f} s wall); "
          f"losses " + ("bit-equal to" if out["losses_bit_equal"] else
                        f"within {rel:.2e} relative of") + " the clean run's, final parameters "
          + ("bit-equal" if final["differ"] == 0 else
             f"{final['differ']} of {final['tensors']} tensors within {final['max_rel']:.2e}")
          + f"; a forced final save killed inside its swap after {swap_runtimes[0]:.1f} s, the "
          f"relaunch promoted .stale/step_4 (bytes unchanged, full verify clean) and exited 0 "
          f"in {swap_runtimes[1]:.1f} s ({wall_swap:.1f} s wall)", flush=True)
    return out


def dur_cli(card: str) -> dict:
    """Leg c: `ckpt verify`, `ls`, `gc --dry-run` and `mirror` on leg b's
    root; one flipped byte makes `verify` exit 1 naming the step and file;
    a missing root exits 2."""
    from llm_training_tpu_torch.cli.main import main as cli_main
    from llm_training_tpu_torch.resilience import durability

    root = DUR_DIR / "b" / "ckpt"

    def ckpt(*argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["ckpt", *map(str, argv)])
        return rc, time.perf_counter() - t0, out.getvalue()

    verify = ckpt("verify", root, "--mode", "full")
    listed = ckpt("ls", root)
    gc_dry = ckpt("gc", root, "--keep-last", "1", "--dry-run")
    mirror = ckpt("mirror", root, "--mirror-dir", DUR_DIR / "c-mirror")
    victim = durability.corrupt_step(root, 4, "flip")
    finding = ckpt("verify", root, "--mode", "full", "--step", "4")
    missing = ckpt("verify", DUR_DIR / "missing", "--mode", "full")
    codes = [r[0] for r in (verify, listed, gc_dry, mirror, finding, missing)]
    check(codes == [0, 0, 0, 0, 1, 2] and "step 4" in finding[2] and victim in finding[2]
          and "would delete steps [2]" in gc_dry[2]
          and durability.committed_steps(DUR_DIR / "c-mirror") == [2, 4],
          f"durability ckpt: exit codes {codes} (want [0, 0, 0, 0, 1, 2]): "
          + " | ".join(r[2][-400:] for r in (verify, gc_dry, mirror, finding, missing)))
    out = dict(codes=codes, verify_full_s=verify[1], mirror_s=mirror[1], finding_s=finding[1],
               finding=[line for line in finding[2].splitlines() if line.startswith("FINDING")])
    print(f"durability ckpt [{card}]: verify --mode full of 2 steps {verify[1]:.3f} s (exit 0), "
          f"ls, gc --dry-run (would delete [2]), mirror of 2 steps {mirror[1]:.3f} s (exit 0); "
          f"a flipped byte: verify exit 1 in {finding[1]:.3f} s ({out['finding'][0]}); a "
          f"missing root exit 2", flush=True)
    return out


def phase_durability(card: str) -> dict:
    """Checkpoint durability, supervise and the ckpt command (see the
    header)."""
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    DUR_DIR.mkdir()
    out = {}
    try:
        free = free_bytes(DUR_DIR)
        # leg a holds two steps, two mirror copies and a healing copy at once
        check(free >= 40e9, f"durability: {free} bytes free in {DUR_DIR}, the phase needs 40 GB")
        t0 = time.perf_counter()
        out["in_process"], clean = dur_in_process(card)
        out["in_process"]["leg_s"] = time.perf_counter() - t0
        shutil.rmtree(DUR_DIR / "a", ignore_errors=True)
        t0 = time.perf_counter()
        out["processes"] = dur_processes(card, clean, out["in_process"]["losses"])
        out["processes"]["leg_s"] = time.perf_counter() - t0
        del clean
        t0 = time.perf_counter()
        out["ckpt"] = dur_cli(card)
        out["ckpt"]["leg_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(DUR_DIR, ignore_errors=True)
        release()
    return out


def main() -> int:
    if len(sys.argv) != 1:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
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

    phase_build()
    phase_kernel_parity(kernels)
    phase_flash_parity()
    serve = phase_serve(kernels, card)
    gc.collect()  # the engine's timing wrappers form a reference cycle
    torch.cuda.empty_cache()
    phase_engine_parity(kernels)
    torch.cuda.empty_cache()
    timing = phase_timing(kernels, card)
    train = phase_train(card)
    lifecycle = phase_lifecycle(card)
    preference = phase_preference(card)
    optimizer = phase_optimizer(card)
    resilience = phase_resilience(card)
    durability = phase_durability(card)
    phase_train_parity()
    flash = phase_flash_timing(card)
    phase_random_streams(card)
    print(f"serve summary [{card}]: " + json.dumps(serve))
    print(f"train summary [{card}]: " + json.dumps(train))
    print(f"lifecycle summary [{card}]: " + json.dumps(lifecycle))
    print(f"preference summary [{card}]: " + json.dumps(preference))
    print(f"optimizer summary [{card}]: " + json.dumps(optimizer))
    print(f"resilience summary [{card}]: " + json.dumps(resilience))
    print(f"durability summary [{card}]: " + json.dumps(durability))
    rows = [{
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
    }]
    for (name, source, replaces), kind in zip(FLASH_KERNELS, ("fwd", "dq", "dkv")):
        # launches on this slice's path: full-depth AdamW with int8 state offloaded
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": optimizer["adamw_int8_full"]["launches"][kind], **flash[kind]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
