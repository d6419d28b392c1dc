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
   split planner reaches 1, an intermediate count and 16 blocks a row; then
   Phi-3's head_dim 96 at group 1 and 4, with its 2047-token window and
   without, over rows of up to 3100 tokens;
4. flash parity (K1-K3): the flash forward (O, LSE) and backward (dq, dk,
   dv, d_sinks) kernels against their plain versions over head_dim x GQA
   group x {causal, window, cap, sinks} x {one document, packed, padding
   tail}, in fp32 and bf16, at S 300, and at S 64 and 257 (lengths that
   cross the backward kernels' 128-row block, with a packed boundary at row
   64 inside a block), and as q_offset chunks of 100 and 170 rows (Sq != Skv,
   not block multiples), and Phi-3's head_dim 96 (padded to 128 by the
   wrapper) at group 1 with its 2047-token window at S 4096; every case has
   fully masked rows (O = 0, LSE = -inf or the sink, dq = 0); then K1, K2
   and K3 launched twice on one input give the same bits;
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
   Llama-3.1-8B widths cut to 1 layer (fp32 params, bf16 compute; the
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
   pinned copy each way. At 4 layers, 3 steps each: AdamW with its state
   on the card, prefetching 2 batches and 0 (losses equal; the device idle
   share of one traced step of each); AdamW with its state offloaded to
   pinned host memory as float32 (parameters and losses bit-equal to the
   on-card run), bfloat16 and int8 (blocks of 256), within the stated
   limits of the on-card run. Then at full depth (32 layers), 4 steps:
   AdamW with int8 state offloaded, and Adafactor with its state on the
   card; step 1's loss near ln(vocab), the loss on each row lower at its
   second visit. Then Lion at 4 layers. Every run: K1, K2 and K3 once a
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
   smoke's own. b: the lifecycle's 1-layer full-width model under plain SGD
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
   phase 15 freed its memory), on phase 15's 1-layer full-width model under
   SGD (checkpoints of 5.07 GB), 4 steps, saves at 2 and 4 with `verify:
   full`, in three legs. a: in one process, the clean fit commits steps 2
   and 4 with manifests, the mirror (on the same disk) drains and both
   copies verify in full; one flipped byte in the primary step 4 is healed
   from the mirror by a new `Trainer`'s restore, every tensor bit-equal to
   the saved one; with both copies of step 4 rotten the fit falls back to
   step 2, deletes step 4 and re-runs steps 3-4, their losses within 1e-3
   relative of the clean run's (bit-equal where the scatter-add allows);
   each time the ladder's counters are checked. b: `supervise` in
   processes of its own, two runs side by side: with
   `LLMT_CHAOS_SIGKILL_STEP=3` on a fresh root the child dies on SIGKILL,
   the relaunch restores step 2 and exits 0, `supervisor.jsonl` shows
   launch, exit (SIGKILL), restart, launch, exit, complete, and the losses
   and final parameters equal leg a's clean run's; on leg a's root a
   forced final save killed inside its swap (`LLMT_CHAOS_CKPT_KILL_IN_SWAP`)
   is promoted from `.stale/` by the relaunch, its bytes unchanged. c:
   after the swap run, on leg a's root (beside the SIGKILL run), `ckpt
   verify --mode full` exits 0, `ls`, `gc --dry-run` and `mirror` run, a
   flipped byte makes `verify` exit 1 naming the step and the file, a
   missing root exits 2. K1-K3 launch in leg a's fits. It prints the
   manifest seconds and hashing rate, the mirror, verify, heal and fallback
   seconds, and each process's wall time and restarts. Once leg a's mirror
   is gone, phase 19's round trip (d below) runs on leg a's checkpoints.
17. rl-fit (run after phase 16 freed its memory): GRPO over the serving
   engine through the `rl-fit` command, in legs. a: in a process of its
   own, Llama-3.1-8B widths cut to 4 layers (fp32 params, bf16 compute,
   selective recompute, random weights from seed 0), AdamW, beta 0.04,
   clip_eps 0.2, fused sync, no checkpointer; 3 rounds of 4 prompts x 8
   rollouts of 256 + 256 tokens (temperature 1, eos off, `max_batch` 32,
   bf16 KV cache) scored by a `regex` reward over the rendered ids: every
   round's collect (decode steps, prefill chunks, rollout tokens/s), update
   (ms, MFU), sync and round wall are printed with the peak memory; K1 ran
   twice a layer an update (policy and reference), K2/K3 once, K4 once a
   layer a decode step, the plain attention path never; the engine's
   generation is 3 and a policy weight moved. parity: one GRPO batch (8
   rows of 512 tokens) at 2 layers of full width through K1-K3 against the
   plain path, in fp32 (token log-probs, per-token loss terms, gradients
   within 1e-4 of max|plain|) and bf16 (no further from fp32 than 1.5 x the
   plain bf16 path; the loss within 1.5 x the plain path's per-token term
   errors). sync: a greedy request in flight across a `fused` and a `host`
   sync at 2 layers: bit-equal engine tensors, the same continuation, which
   a fresh engine over the new weights fed prompt + tokens so far also
   gives. cast: the decode step from fp32 parameters against a bf16 copy,
   in turns. c: in processes of their own, 2 layers under SGD with a
   checkpointer (11.9 GB of policy and reference a round) and the rollout
   journal: a real SIGTERM 40 engine steps into round 2 exits 75 with the
   rollouts in flight journaled and the round cursor checkpointed; the
   relaunch (host sync) adopts every journaled rollout, submits none again,
   drops none as stale, and exits 0 with the journal retired.
18. `serve`'s resilience and live telemetry (run after phase 17 freed its
   memory), through the CLI in processes of their own, each counting K4's
   launches and the plain decode path's calls (which must stay 0). a:
   Llama-3.1-8B's widths cut to 8 layers (`--model-config`; bf16, random
   weights from seed 0),
   `max_batch` 8, `max_model_len` 2048, chunk 256, greedy: 8 warm-up
   requests, then a burst of 48 (prompts of 32-1024 tokens, 64 new) --
   without shedding, then with `--max-queue 8 --shed-ttft-ms` twice the
   warm-up TTFT p50: TTFT p50/p99, `overloaded` terminals (0, then > 0),
   decode step p50; `/metrics` scraped at ~2 Hz through `LLMT_METRICS_PORT`
   and every scrape parsed by the port's `parse_prometheus_text`,
   `/healthz` 200 while busy, the final scrape's completions equal the
   client's. Both processes also hold a request journal and time, on the
   loop thread, every call into the tracer, the journal and the watchdog's
   beat, while their engine steps cycle through all on, the tracer
   disabled and the journal detached: the host microseconds each costs a
   step, and each mode's decode-only step against the adjacent all-on
   one; a microbenchmark gives the tracer's cost an event. b: 2 layers of the
   same widths in fp32 (token equality across a drain needs the prefill
   and decode paths to agree closer than bf16 does): a 1-step SGD `fit`
   writes the checkpoint, one uninterrupted `serve --config` answers 16
   requests of 128 new tokens, then `supervise --child serve` with
   `LLMT_CHAOS_SERVE_SIGTERM_STEP` 40 and a 1 s drain: exit 75, the
   relaunch replays the journal, every stream equals the uninterrupted
   one token for token with one terminal a request; a `{"type":
   "profile"}` line writes a `torch.profiler` trace holding CUDA kernel
   events with `profile/errors` 0; the `trace` command's export tiles
   every residency's queue/prefill/decode spans within 50 ms. c: 2 layers
   in bf16, a stall at engine step 10 under `--watchdog-timeout-s 6`: a
   hang dump and a flight dump, `/healthz` 503 before the abort, and the
   supervised relaunch finishes every request.
19. HF checkpoint I/O and Phi-3 (run after phase 18 freed its memory), at
   the published widths of Phi-3-mini-4k-instruct (hidden 3072, 32 layers,
   32 q and kv heads of 96, vocab 32064, a 2047-token sliding window),
   random bf16 weights from seed 0. a: `save_hf_checkpoint` writes two
   safetensors shards, the index and `config.json` (seconds, GB/s). b:
   `ModelProvider("HFCausalLM", {"hf_path": ...})` through the objectives'
   `build_model`/`init_model` loads it on the card, every tensor equal to
   the exported model's (seconds, GB/s); a `ServingEngine` (bf16, 8 slots,
   `max_model_len` 4096, block 16, chunk 512) answers 16 requests of
   1024-3072 prompt tokens and 128 new ones (most rows decode past the
   window): all complete, the pool ends leak-free, K4 launches 32 times a
   decode step, the plain decode path never; decode step p50, tokens/s,
   TTFT p50, peak memory. c: DPO built from a JSON node whose model is
   `HFCausalLM` over the same directory with `num_hidden_layers: 8`
   (fp32 parameters, bf16 compute, selective recompute): policy and
   reference loaded (the reference equal to the policy, the probed tensors
   equal to the export's), the example's AdamW, 3 steps of 8 synthetic
   pairs up to 2048 tokens: the first loss ln 2, K1 4 x 8 x 3 and K2/K3 2 x
   8 x 3 launches, the plain path never; step p50, MFU, peak memory. d
   (inside phase 16, on its leg a checkpoints of 5.07 GB): `convert_to_hf`
   writes bf16 safetensors, `HFCausalLM` reloads them on the card: every
   tensor equal to the restored model's rounded to bf16, and the logits of
   one 2 x 1024 batch bit-equal (else the largest difference is printed,
   and must stay within 8 bf16 steps of the largest logit). Then the
   kernels at this slice's shapes against their plain versions and timed
   beside their bounds: K4 at B 8, Hkv 32, D 96, window 2047, rows of
   2048-3072; K1-K3 at B 8, S 2048, Hq = Hkv = 32, D 96 (padded to 128;
   the bound counts 96), window 2047, with the plain versions and SDPA.
The allocator runs with expandable segments (set before torch is
imported) for phase 14's full-depth runs.
Every phase prints its wall time. It prints the four kernels at the
earlier slices' Llama-3.1-8B shapes (phases 7 and 10, launches from phase
17a) and phase 18's K4 launches on lines of their own, then one
`{"kernels": [...]}` line for this slice's path (phase 19: K4 launches
from its serving leg, K1-K3 from its DPO leg, times at its shapes), the
card's name and power limit, and as its last line `{"ok": true,
"device": {...}}`.
"""

from __future__ import annotations

import os

# phase 14 holds 64 GB of float32 parameters and gradients of the full-depth
# model beside activations and the optimizer's staging buffers: segments
# that grow in place keep the allocator's fragmentation from failing it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import contextlib
import dataclasses
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
LIFE_LAYERS = 1  # cut from 2 to keep the smoke inside its time limit
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
OPT_LAYERS = 4  # cut from 8 to keep the smoke inside its time limit
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
RES_LAYERS = 8  # leg a: health at 8 layers (the layout of telemetry/health_keys.json)
RES_STEPS = 6
RES_DIR = ROOT / ".smoke_resilience"
RES_DEVICE = "cuda"
# legs b and c: the lifecycle's 1-layer model; plain SGD keeps a checkpoint to
# the parameters (5.1 GB): AdamW's moments would triple every save and restore
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
# phase 16: durability and the ckpt command, on phase 15's 1-layer
# model under SGD (a checkpoint of the parameters, 5.07 GB)
DUR_DIR = ROOT / ".smoke_durability"
DUR_STEPS = 4
DUR_COUNTERS = ("checkpoint/verify_failures", "checkpoint/mirror_restores",
                "resilience/restore_fallbacks")
# leg b's supervised runs, each (its children included) killed past this
DUR_SUPERVISE_TIMEOUT_S = 420.0
# leg b's live `supervise` process groups, and whether the phase is ending
# them (a failure elsewhere in the phase)
_DUR_LIVE: set[int] = set()
_DUR_STOP = [False]
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


class LegThread:
    """A leg on a thread of its own; `result()` joins and re-raises."""

    def __init__(self, leg, *args):
        import threading

        self._out, self._error = None, None
        self._thread = threading.Thread(target=self._run, args=(leg, *args), daemon=True)
        self._thread.start()

    def _run(self, leg, *args) -> None:
        try:
            self._out = leg(*args)
        except BaseException as e:  # re-raised on the phase's thread
            self._error = e

    def join(self, timeout: float) -> None:
        """Wait for the leg without re-raising its error."""
        self._thread.join(timeout)

    def result(self, timeout: float):
        self._thread.join(timeout)
        check(not self._thread.is_alive(), f"a leg did not finish in {timeout:.0f} s")
        if self._error is not None:
            raise self._error
        return self._out


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
    # Phi-3: head_dim 96, MHA (and group 4), its 2047-token window over rows past it
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for group in (1, 4):
            for window in (None, 2047):
                case = decode_case([1, 16, 1500, 2100, 3100, 1], 16, 2, group, 96, dtype, n_cases)
                case["block_tables"][-1] = 0
                err = kernel_vs_plain(kernels, case, sliding_window=window)
                check(err.pop("ok"), f"kernel parity: {name} D=96 G={group} window={window}: "
                      f"errors {err}")
                for key, value in err.items():
                    worst[name][key] = max(worst[name].get(key, 0.0), value)
                n_cases += 1
    check({1, kernels.MAX_SPLITS} <= splits_seen and len(splits_seen) >= 3,
          f"kernel parity: the bf16 cases split {sorted(splits_seen)} ways; they must reach 1, "
          f"an intermediate count and {kernels.MAX_SPLITS}")
    bf16 = worst["bfloat16"]
    print(
        f"kernel parity: {n_cases} cases pass (D 64/128 x G 1/4/8 x window 100 + cap 5 or "
        f"neither x page 16/32 x {'/'.join(k4_layouts(16))}; D 96 x G 1/4 x window 2047 or "
        f"none over rows to 3100; bf16 split "
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
    # Phi-3's shape: head_dim 96 (padded to 128 by the wrapper), MHA, its
    # 2047-token window over rows of 4096
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("one_doc", "packed"):
            cases.append((dtype, 96, 1, "window2047", layout, 4096, None))
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
        elif variant == "window2047":
            opts["sliding_window"] = 2047
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
          f"of 100 and 170 rows; D 96 G 1 window 2047 at S 4096; fully masked rows exact; K1, "
          f"K2 and K3 twice: identical bits); "
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

    t_run = time.perf_counter()
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
    result["wall_s"] = time.perf_counter() - t_run
    print(f"optimizer {name}: {result['wall_s']:.1f} s in all", flush=True)
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
    """A JSON config of leg c: the lifecycle's model, SGD, the packed rows, a
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
    """Phase 15's full-width model, SGD and packed rows for 4 steps,
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


def dur_losses(name: str) -> dict[int, float]:
    rows = (DUR_DIR / name / "run" / "log" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, rows) if "loss" in r}


def dur_supervise(name: str, config: dict, env: dict, args: list[str]):
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
    check(not _DUR_STOP[0], f"durability {name}: the phase is ending")
    t0 = time.perf_counter()
    with open(out_path, "w") as handle:
        proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **env}, stdout=handle,
                                stderr=subprocess.STDOUT, start_new_session=True)
        _DUR_LIVE.add(proc.pid)
        try:
            rc = proc.wait(timeout=DUR_SUPERVISE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            _DUR_LIVE.discard(proc.pid)
    wall = time.perf_counter() - t0
    events = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
    return rc, wall, events, out_path.read_text()


def dur_lifecycle(events: list[dict]) -> list[tuple]:
    return [(e["event"], e.get("signal")) for e in events if e["event"] != "segment_topology"]


HEALED = [("launch", None), ("exit", "SIGKILL"), ("restart", None), ("launch", None),
          ("exit", None), ("complete", None)]


def dur_sigkill() -> dict:
    """Leg b's first run (on a thread beside the swap run and leg c): a
    chaos SIGKILL at step 3 under `supervise` on a fresh root, healed by
    the relaunch (see the header)."""
    config = dur_config("b", checkpoint={"async_save": False})
    rc, wall, events, text = dur_supervise(
        "sigkill", config, {"LLMT_CHAOS_SIGKILL_STEP": "3"},
        ["--child-args", f"--device {LIFE_DEVICE}"])
    check(rc == 0 and dur_lifecycle(events) == HEALED
          and [e["attempt"] for e in events if e["event"] == "segment_topology"] == [1, 2],
          f"durability supervise: exit {rc}, events {dur_lifecycle(events)}: {text[-1500:]}")
    return dict(rc=rc, wall_s=wall, runtimes=[e["runtime_s"] for e in events
                                              if e["event"] == "exit"],
                restarts=sum(e["event"] == "restart" for e in events),
                losses={s: float(v) for s, v in dur_losses("b").items()})


def dur_swap() -> dict:
    """Leg b's second run, on leg a's root (steps 2 and 4): a forced final
    save killed inside its swap. The first launch resumes step 2
    (--ckpt-path), runs steps 3-4 with no interval save, and its final save
    over the committed step 4 dies on SIGKILL between the renames; the
    relaunch promotes .stale/step_4 and finds nothing left to do."""
    from llm_training_tpu_torch.resilience import durability

    root = DUR_DIR / "a" / "ckpt"
    before = durability.load_manifest(root, 4)
    rc, wall, events, text = dur_supervise(
        "swap", dur_config("a", checkpoint={"async_save": False}),
        {"LLMT_CHAOS_CKPT_KILL_IN_SWAP": "4"},
        ["--ckpt-path", "2", "--child-args",
         f"--device {LIFE_DEVICE} trainer.checkpoint_every_n_steps=null"])
    promoted = "promoted staged checkpoint step 4" in text
    check(rc == 0 and dur_lifecycle(events) == HEALED and promoted
          and durability.committed_steps(root) == [2, 4]
          and durability.load_manifest(root, 4) == before
          and durability.verify_step(root, 4, mode="full").ok
          and not (root / durability.STALE_DIR).exists(),
          f"durability kill-in-swap: exit {rc}, events {dur_lifecycle(events)}, "
          f"promoted {promoted}, steps {durability.committed_steps(root)}: {text[-1500:]}")
    return dict(swap_rc=rc, swap_wall_s=wall,
                swap_runtimes=[e["runtime_s"] for e in events if e["event"] == "exit"],
                swap_restarts=sum(e["event"] == "restart" for e in events))


def dur_processes_match(card: str, out: dict, clean: dict, clean_losses: dict) -> dict:
    """Leg b's SIGKILL run: its losses and final parameters (step 4)
    against leg a's clean run."""
    from llm_training_tpu_torch.cli.main import build_fit

    config = dur_config("b", checkpoint={"async_save": False})
    losses = out["losses"]
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
    out.update(losses_bit_equal=losses == clean_losses, max_rel_loss=rel, final=final)
    runtimes, swap_runtimes = out["runtimes"], out["swap_runtimes"]
    print(f"durability processes [{card}]: supervise with LLMT_CHAOS_SIGKILL_STEP=3: the child "
          f"died on SIGKILL after {runtimes[0]:.1f} s, the relaunch restored step 2 and "
          f"completed in {runtimes[1]:.1f} s ({out['restarts']} restart, {out['wall_s']:.1f} s "
          f"wall); losses " + ("bit-equal to" if out["losses_bit_equal"] else
                               f"within {rel:.2e} relative of") + " the clean run's, final "
          "parameters " + ("bit-equal" if final["differ"] == 0 else
                           f"{final['differ']} of {final['tensors']} tensors within "
                           f"{final['max_rel']:.2e}")
          + f"; a forced final save killed inside its swap after {swap_runtimes[0]:.1f} s, the "
          f"relaunch promoted .stale/step_4 (bytes unchanged, full verify clean) and exited 0 "
          f"in {swap_runtimes[1]:.1f} s ({out['swap_wall_s']:.1f} s wall; on leg a's root, "
          f"beside the SIGKILL run)", flush=True)
    return out


def dur_cli(card: str) -> dict:
    """Leg c: `ckpt verify`, `ls`, `gc --dry-run` and `mirror` on leg a's
    root (steps 2 and 4 after its fallback re-ran steps 3-4); one flipped
    byte makes `verify` exit 1 naming the step and file; a missing root
    exits 2."""
    from llm_training_tpu_torch.cli.main import main as cli_main
    from llm_training_tpu_torch.resilience import durability

    root = DUR_DIR / "a" / "ckpt"

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
    mirrored = durability.committed_steps(DUR_DIR / "c-mirror")
    shutil.rmtree(DUR_DIR / "c-mirror")  # 12 GB the disk need not hold beside leg b
    victim = durability.corrupt_step(root, 4, "flip")
    finding = ckpt("verify", root, "--mode", "full", "--step", "4")
    missing = ckpt("verify", DUR_DIR / "missing", "--mode", "full")
    codes = [r[0] for r in (verify, listed, gc_dry, mirror, finding, missing)]
    check(codes == [0, 0, 0, 0, 1, 2] and "step 4" in finding[2] and victim in finding[2]
          and "would delete steps [2]" in gc_dry[2]
          and mirrored == [2, 4],
          f"durability ckpt: exit codes {codes} (want [0, 0, 0, 0, 1, 2]): "
          + " | ".join(r[2][-400:] for r in (verify, gc_dry, mirror, finding, missing)))
    out = dict(codes=codes, verify_full_s=verify[1], mirror_s=mirror[1], finding_s=finding[1],
               finding=[line for line in finding[2].splitlines() if line.startswith("FINDING")])
    print(f"durability ckpt [{card}]: verify --mode full of 2 steps {verify[1]:.3f} s (exit 0), "
          f"ls, gc --dry-run (would delete [2]), mirror of 2 steps {mirror[1]:.3f} s (exit 0); "
          f"a flipped byte: verify exit 1 in {finding[1]:.3f} s ({out['finding'][0]}); a "
          f"missing root exit 2", flush=True)
    return out


def phase_durability(card: str, round_trip=None) -> dict:
    """Checkpoint durability, supervise and the ckpt command (see the
    header): after leg a, leg b's SIGKILL run goes on a thread while its
    swap run and then leg c use leg a's root. `round_trip(card, ckpt_dir,
    out_dir)` runs on leg a's checkpoints once its mirror is gone (phase
    19's `convert_to_hf` leg: no new large checkpoint)."""
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    DUR_DIR.mkdir()
    out = {}
    leg_b, _DUR_STOP[0] = None, False
    try:
        free = free_bytes(DUR_DIR)
        # leg a holds two steps, two mirror copies and a healing copy at once
        check(free >= 40e9, f"durability: {free} bytes free in {DUR_DIR}, the phase needs 40 GB")
        t0 = time.perf_counter()
        out["in_process"], clean = dur_in_process(card)
        out["in_process"]["leg_s"] = time.perf_counter() - t0
        # the machine's disk counts every block ever written: leg b's roots
        # take the place of leg a's mirror, and leg c's mirror follows the
        # swap run
        shutil.rmtree(DUR_DIR / "a" / "mirror")
        if round_trip is not None:
            t0 = time.perf_counter()
            out["hf_round_trip"] = round_trip(card, DUR_DIR / "a" / "ckpt", DUR_DIR / "hf")
            out["hf_round_trip"]["leg_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        leg_b = LegThread(dur_sigkill)
        swap = dur_swap()
        t1 = time.perf_counter()
        out["ckpt"] = dur_cli(card)
        out["ckpt"]["leg_s"] = time.perf_counter() - t1
        sigkill = leg_b.result(DUR_SUPERVISE_TIMEOUT_S + 60)
        leg_b = None
        out["processes"] = dur_processes_match(card, {**sigkill, **swap}, clean,
                                               out["in_process"]["losses"])
        out["processes"]["leg_s"] = time.perf_counter() - t0
        del clean
    finally:
        if leg_b is not None:  # the swap run or leg c failed: end leg b's SIGKILL run
            import signal

            _DUR_STOP[0] = True
            for pgid in list(_DUR_LIVE):
                try:
                    os.killpg(pgid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            leg_b.join(60)
        shutil.rmtree(DUR_DIR, ignore_errors=True)
        release()
    return out


# ------------------------------------------------------------------ phase 17: rl-fit

RL_DIR = ROOT / ".smoke_rl"
RL_DEVICE = "cuda"
RL_LAYERS = 4  # leg a at Llama-3.1-8B widths (cut from 8 for the smoke's time limit)
RL_SMALL_LAYERS = 2  # legs b and c
RL_ROUNDS = 3
RL_PROMPTS = 4  # prompts a round, x RL_GROUP rollouts each
RL_GROUP = 8
RL_PROMPT_LEN = 256
RL_NEW = 256
RL_PREFILL = 256  # prefill chunk width: one prompt a chunk
RL_LR = 5e-5  # phase 13's peak: the examples' rates move no bf16 product in a few steps
# fused CE positions a chunk: 32 rows x 128 x 128256 fp32 logits = 2.1 GB
RL_LOGPS_CHUNK = 128
RL_FP32_RTOL = 1e-4  # fp32 kernel path against the plain path, of max|plain|
RL_SIGTERM_STEP = 40  # leg c: engine steps into round 2 when SIGTERM lands
RL_RESUME_ROUNDS = 2
# the reward: `length` is constant here (eos is off, so every completion has
# RL_NEW tokens), its advantages 0 and no weight would move; `regex` over the
# rendered ids matches ids 100000-100399, which ~55% of 256 near-uniform
# draws from 128256 ids contain: groups with spread rewards
RL_REWARD = "regex"
RL_REWARD_ENV = {"LLMT_RL_REWARD_PATTERN": r"\b100[0-3]\d\d\b"}

# leg a and c's child: `rl-fit` through the CLI, with its kernels counted, a
# probe of the policy's weights, and (SMOKE_RL_SIGTERM) a real SIGTERM sent
# to itself that many engine steps into round 2; one `SMOKE_RL {...}` line
_RL_CHILD = r"""
import json, os, signal, sys, time
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke
from llm_training_tpu_torch.cli import main as cli
from llm_training_tpu_torch.ops.kernels import flash_attention as fa
from llm_training_tpu_torch.ops.kernels import paged_attention as pa
from llm_training_tpu_torch.serve.engine import ServingEngine

loops = []
real_setup = cli.RLLoop.setup

def setup(self):
    real_setup(self)
    loops.append(self)
    sync()
    self.probe = self.state.model.policy.lm_head.weight[:64].detach().clone()
    self.t_setup = time.perf_counter()

cuda = torch.cuda.is_available()
sync = torch.cuda.synchronize if cuda else (lambda: None)
cli.RLLoop.setup = setup
sigterm_at = int(os.environ.get("SMOKE_RL_SIGTERM", "0"))
if sigterm_at:
    real_step = ServingEngine.step
    steps = [0]

    def step(self):
        if self.weights_generation == 1:
            steps[0] += 1
            if steps[0] == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return real_step(self)

    ServingEngine.step = step
launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel, pa.paged_decode_attention)
for launcher in launchers:
    launcher.launches = 0
if cuda:
    torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
with chip_smoke.count_plain_attention() as plain:
    rc = cli.main(sys.argv[1:])
    sync()
t1 = time.perf_counter()
loop = loops[-1]
policy = loop.state.model.policy
out = dict(
    rc=rc, wall_s=t1 - t0, setup_s=loop.t_setup - t0, launches=[l.launches for l in launchers],
    plain_calls=plain[0], peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
    timings=loop.timings, generation=loop.engine.weights_generation,
    decode_steps=loop.engine.decode_steps, layers=policy.config.num_hidden_layers,
    updates=loop.state.step,
    params=sum(p.numel() for p in policy.parameters()),
    embed=policy.model.embed_tokens.weight.numel(),
    probe_delta=float((policy.lm_head.weight[:64].detach() - loop.probe).abs().max()),
)
print("SMOKE_RL " + json.dumps(out), flush=True)
sys.exit(rc)
"""


def rl_config(name: str, layers: int, optim: dict, checkpoint: bool) -> Path:
    """A GRPO config at Llama-3.1-8B widths (fp32 params, bf16 compute,
    selective recompute), random weights from seed 0, into
    `RL_DIR/<name>.json`; with `checkpoint`, a checkpointer and a JSONL
    logger (whose run directory holds the rollout journal)."""
    from dataclasses import asdict

    from llm_training_tpu_torch.models.llama.config import preset

    model = asdict(preset("llama-3.1-8b", num_hidden_layers=layers, param_dtype="float32",
                          compute_dtype="bfloat16", enable_gradient_checkpointing=True,
                          recompute_granularity="selective"))
    trainer = {"max_steps": RL_ROUNDS, "seed": 0}
    if checkpoint:
        trainer["checkpoint"] = {"dirpath": str(RL_DIR / name / "ckpt"), "async_save": False}
        trainer["loggers"] = [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                               "init_args": {"save_dir": str(RL_DIR / name), "project": "run",
                                             "name": "log"}}]
    config = {
        "seed_everything": 0, "trainer": trainer,
        "model": {"class_path": "llm_training_tpu.lms.GRPO", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": model},
            "beta": 0.04, "clip_eps": 0.2, "group_size": RL_GROUP,
            "logps_chunk_size": RL_LOGPS_CHUNK, "optim": optim}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 1, "max_length": 16, "vocab_size": 128256}},
    }
    path = RL_DIR / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def rl_argv(path: Path, rounds: int, *flags: str) -> list[str]:
    return ["rl-fit", "--config", str(path), "--device", RL_DEVICE, "--rounds", str(rounds),
            "--prompts-per-round", str(RL_PROMPTS), "--prompt-len", str(RL_PROMPT_LEN),
            "--max-new-tokens", str(RL_NEW), "--max-batch", str(RL_PROMPTS * RL_GROUP),
            "--max-model-len", str(RL_PROMPT_LEN + RL_NEW), "--prefill-chunk", str(RL_PREFILL),
            "--temperature", "1.0", "--reward", RL_REWARD, "--eos-token-id", "-1",
            "--cache-dtype", "bfloat16", *flags]


def rl_child(name: str, argv: list[str], env: dict | None = None, timeout: float = 600):
    """`_RL_CHILD` in a process of its own: (exit code, wall seconds, its
    `SMOKE_RL` summary or None, its rl_round and stats records, output)."""
    import subprocess

    log = RL_DIR / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "w") as handle:
        proc = subprocess.Popen(
            [sys.executable, "-c", _RL_CHILD, *argv], cwd=ROOT, stdout=handle,
            stderr=subprocess.STDOUT,
            env={**os.environ, **RL_REWARD_ENV, **(env or {})})
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    text = log.read_text()
    summary, records = None, []
    for line in text.splitlines():
        if line.startswith("SMOKE_RL "):
            summary = json.loads(line.removeprefix("SMOKE_RL "))
        elif line.startswith("{"):
            records.append(json.loads(line))
    return rc, wall, summary, records, text


def rl_update_flops(summary: dict) -> float:
    """One update's operations: 6 N a trained token (N without the input
    embedding table) and 2 N a reference token, attention 12 D a visible
    pair a head a layer for the policy and 4 D for the reference (PERF.md
    section 2; recompute not counted). Every row holds prompt + completion
    tokens, all causal within the row."""
    from llm_training_tpu_torch.models.llama.config import preset

    config = preset("llama-3.1-8b")
    rows, seq = RL_PROMPTS * RL_GROUP, RL_PROMPT_LEN + RL_NEW
    n = summary["params"] - summary["embed"]
    pairs = rows * seq * (seq + 1) // 2
    return (8 * n * rows * seq + 16 * config.resolved_head_dim * config.num_attention_heads
            * summary["layers"] * pairs)


def rl_leg_a(card: str) -> dict:
    """GRPO through `rl-fit` at RL_LAYERS layers of Llama-3.1-8B widths, AdamW,
    fused sync, no checkpointer (see the header)."""
    from llm_training_tpu_torch.ops.kernels import bench_flash

    optim = {"optimizer": "adamw", "learning_rate": RL_LR, "lr_scheduler": "constant",
             "warmup_steps": 0, "grad_clip_norm": 1.0}
    path = rl_config("a", RL_LAYERS, optim, checkpoint=False)
    rc, wall, summary, records, text = rl_child("a", rl_argv(path, RL_ROUNDS))
    check(rc == 0 and summary is not None, f"rl-fit: exit {rc}: {text[-3000:]}")
    rounds = [r for r in records if r.get("type") == "rl_round"]
    stats = next((r["stats"] for r in records if r.get("type") == "stats"), {})
    layers, updates = summary["layers"], summary["updates"]
    k1, k2, k3, k4 = summary["launches"]
    expected = [2 * layers * updates, layers * updates, layers * updates,
                summary["decode_steps"] * layers]
    flops = rl_update_flops(summary)
    for timing in summary["timings"]:
        timing["tokens_per_s"] = timing["tokens"] / timing["collect_s"]
        timing["mfu"] = flops / timing["update_s"] / bench_flash.BF16_FLOPS_PER_S
    timings = summary["timings"]
    out = dict(layers=layers, rounds=len(rounds), updates=updates, launches=dict(
        zip(("fwd", "dq", "dkv", "decode"), summary["launches"])),
        plain_calls=summary["plain_calls"], peak_memory_gb=summary["peak_bytes"] / 1e9,
        timings=timings, generation=summary["generation"], probe_delta=summary["probe_delta"],
        wall_s=wall, setup_s=summary["setup_s"], flops_per_update=flops,
        mean_rewards=[r["mean_reward"] for r in rounds], losses=[r.get("loss") for r in rounds],
        kl=[r.get("kl_to_ref") for r in rounds], collected=stats.get("rl/rollouts_collected"),
        stale=stats.get("rl/rollouts_stale_dropped"))
    for t in timings:
        print(f"rl round [{card}]: round {t['round']}: collect {t['collect_s']:.3f} s "
              f"({t['decode_steps']} decode steps, {t['prefill_chunks']} prefill chunks, "
              f"{t['tokens']} tokens, {t['tokens_per_s']:.1f} rollout tokens/s); update "
              f"{1e3 * t['update_s']:.1f} ms (MFU {100 * t['mfu']:.2f}%); sync "
              f"{1e3 * t['sync_s']:.3f} ms; round {t['round_s']:.3f} s", flush=True)
    print(f"rl-fit [{card}]: GRPO at llama-3.1-8b widths x {layers} layers ({summary['params']} "
          f"params), {len(rounds)} rounds of {RL_PROMPTS} prompts x {RL_GROUP} rollouts "
          f"({RL_PROMPT_LEN} + {RL_NEW} tokens), AdamW, fused sync: update MFU "
          + ", ".join(f"{100 * t['mfu']:.2f}%" for t in timings)
          + f" ({flops / 1e12:.1f} TFLOP an update: 6N a trained token, 2N a reference token, "
          f"attention 12D + 4D a visible pair a head a layer); peak memory "
          f"{out['peak_memory_gb']:.2f} GB; launches K1 {k1} K2 {k2} K3 {k3} K4 {k4} "
          f"(expected {expected}), plain attention {summary['plain_calls']}; engine generation "
          f"{summary['generation']}, |delta| of a policy weight {summary['probe_delta']:.3e}; "
          f"mean rewards {out['mean_rewards']}, losses {out['losses']}, KL {out['kl']}; "
          f"set-up {summary['setup_s']:.1f} s, child wall {wall:.1f} s", flush=True)
    check(len(rounds) == RL_ROUNDS and summary["launches"] == expected and min(expected) > 0
          and summary["plain_calls"] == 0,
          f"rl-fit: {len(rounds)} rounds, launches {summary['launches']} (expected {expected}), "
          f"plain attention {summary['plain_calls']}")
    check(any(0 < r < 1 for r in out["mean_rewards"]),
          f"rl-fit: mean rewards {out['mean_rewards']}: no group has spread rewards")
    check(summary["generation"] == RL_ROUNDS and summary["probe_delta"] > 0
          and out["collected"] == RL_ROUNDS * RL_PROMPTS * RL_GROUP and out["stale"] == 0
          and all(math.isfinite(x) for x in out["losses"] + out["kl"]),
          f"rl-fit: generation {summary['generation']}, weight delta {summary['probe_delta']}, "
          f"collected {out['collected']}, stale {out['stale']}, losses {out['losses']}")
    return out


def rl_batch(vocab: int) -> dict:
    """One GRPO batch of RL_GROUP rows of RL_PROMPT_LEN + RL_NEW seeded
    tokens: two groups of 4 with spread rewards, behavior logprobs around
    a random model's (ln 1/vocab), so ratios fall inside and outside the
    clip."""
    rng = np.random.default_rng(17)
    rows, seq = RL_GROUP, RL_PROMPT_LEN + RL_NEW
    completion = np.zeros((rows, seq), np.int32)
    completion[:, RL_PROMPT_LEN:] = 1
    behavior = np.where(completion > 0, rng.uniform(-12.3, -11.2, (rows, seq)), 0.0)
    return {"input_ids": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "segment_ids": np.ones((rows, seq), np.int32), "completion_mask": completion,
            "behavior_logprobs": behavior.astype(np.float32),
            "rewards": rng.uniform(0, 1, rows).astype(np.float32),
            "group_ids": np.repeat(np.arange(2), rows // 2).astype(np.int32)}


def rl_token_terms(policy_lp, ref_lp, mask, batch, beta=0.04, clip=0.2):
    """GRPO's per-token loss terms `(pg + beta kl) mask / n` from the two
    models' token log-probs (the objective's formula, written out here as
    the yardstick the loss is held to)."""
    from llm_training_tpu_torch.lms.grpo import group_relative_advantages

    behavior = torch.cat([batch["behavior_logprobs"][:, 1:],
                          torch.zeros_like(batch["behavior_logprobs"][:, :1])], 1)
    adv = group_relative_advantages(batch["rewards"], batch["group_ids"])[:, None]
    ratio = torch.exp(torch.where(mask > 0, policy_lp - behavior, 0.0))
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    r = torch.where(mask > 0, ref_lp - policy_lp, 0.0)
    return (pg + beta * (torch.exp(r) - r - 1)) * mask / mask.sum().clamp_min(1)


def rl_pair(ref, config):
    """(policy, reference) in `config`: the reference a copy of `ref`, the
    policy that copy plus seeded noise of PREF_PARITY_NOISE x the init std."""
    from llm_training_tpu_torch.models.llama.model import Llama

    ref_model, policy = Llama(config, device=RL_DEVICE), Llama(config, device=RL_DEVICE)
    ref_model.load_state_dict(ref.state_dict())
    policy.load_state_dict(ref.state_dict())
    noise = torch.Generator(device=RL_DEVICE).manual_seed(2)
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(torch.randn(p.shape, generator=noise, device=p.device),
                   alpha=PREF_PARITY_NOISE * config.initializer_range)
    return policy, ref_model.requires_grad_(False)


def rl_parity(card: str) -> dict:
    """Leg b, first half: one GRPO batch's loss, token log-probs and policy
    gradients with a 2-layer full-width policy (the reference plus seeded
    noise) through K1-K3 and the plain path, in fp32 (within RL_FP32_RTOL
    of max|plain|) and in bf16 (no further from fp32 than NO_FURTHER x the
    plain bf16 path)."""
    from llm_training_tpu_torch.lms.grpo import GRPO, GRPOConfig
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    layers = RL_SMALL_LAYERS
    kw = dict(num_hidden_layers=layers, param_dtype="float32", enable_gradient_checkpointing=True,
              recompute_granularity="selective")
    ref = Llama(preset("llama-3.1-8b", **kw), device=RL_DEVICE)
    ref.init_weights(torch.Generator(device=RL_DEVICE).manual_seed(1))
    batch = {k: torch.as_tensor(v, device=RL_DEVICE) for k, v in rl_batch(ref.config.vocab_size).items()}
    names = ("model.layers.0.self_attn.q_proj.weight", "model.layers.1.self_attn.k_proj.weight",
             "model.layers.1.mlp.down_proj.weight", "model.embed_tokens.weight")
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    results = {}
    for path, compute, impl in (("kernel_bf16", "bfloat16", "auto"), ("plain_bf16", "bfloat16", "torch"),
                                ("kernel_fp32", "float32", "auto"), ("plain_fp32", "float32", "torch")):
        policy, ref_model = rl_pair(ref, preset("llama-3.1-8b", compute_dtype=compute,
                                                attention_impl=impl, **kw))
        objective = GRPO(GRPOConfig(logps_chunk_size=RL_LOGPS_CHUNK), model=policy,
                         ref_model=ref_model)
        logps, real = [], objective._token_logps

        def recorded(model, batch, real=real, logps=logps):
            out = real(model, batch)
            logps.append(out)
            return out

        objective._token_logps = recorded  # policy, then reference
        before = [launcher.launches for launcher in launchers]
        with count_plain_attention() as plain:
            loss, metrics = objective.loss_and_metrics(batch)
            loss.backward()
            torch.cuda.synchronize()
        ran = [launcher.launches - b for launcher, b in zip(launchers, before)]
        kernel = path.startswith("kernel")
        expected = [2 * layers, layers, layers] if kernel else [0, 0, 0]
        check(ran == expected and (plain[0] == 0) == kernel,
              f"rl parity: {path} launched K1/K2/K3 {ran} (expected {expected}), the plain "
              f"path {plain[0]} times")
        check(all(p.grad is None for p in ref_model.parameters()),
              f"rl parity: {path}: the reference got gradients")
        (policy_lp, mask), (ref_lp, _) = [(lp.detach(), m) for lp, m in logps]
        params = dict(policy.named_parameters())
        results[path] = dict(loss=float(loss.detach()), policy_logps=policy_lp, ref_logps=ref_lp,
                             terms=rl_token_terms(policy_lp, ref_lp, mask, batch),
                             clip_frac=float(metrics["ratio_clip_frac"]),
                             kl=float(metrics["kl_to_ref"]),
                             **{n: params[n].grad.detach().clone() for n in names})
        del objective, recorded, logps, real, loss, metrics, params, policy, ref_model
        release()
    del ref
    keys = ("policy_logps", "ref_logps", "terms", *names)
    errors = {}
    for path, truth in (("kernel_fp32", "plain_fp32"), ("kernel_bf16", "plain_fp32"),
                        ("plain_bf16", "plain_fp32")):
        errors[path] = {k: _max_rel(results[path][k], results[truth][k]) for k in keys}
        errors[path]["loss"] = abs(results[path]["loss"] - results[truth]["loss"])
    # a loss is a sum of per-token terms whose rounding errors may cancel by
    # chance on one path and not the other: the loss is held to the sum of
    # the plain path's per-token term errors, without cancellation
    budgets = {path: float((results[path]["terms"] - results["plain_fp32"]["terms"]).abs().sum())
               for path in ("kernel_fp32", "plain_bf16")}
    truth = results["plain_fp32"]
    print(f"rl parity [{card}]: GRPO, {layers}-layer full width, {RL_GROUP} rows x "
          f"{RL_PROMPT_LEN + RL_NEW} tokens, loss fp32 {truth['loss']:.6f}, KL {truth['kl']:.4e}, "
          f"clip fraction {truth['clip_frac']:.3f}; vs the plain fp32 path (loss |error|; token "
          "log-probs, per-token loss terms and grads: max error over max|fp32|): " + "; ".join(
              f"{path} " + ", ".join(f"{k.removeprefix('model.')} {v:.3e}"
                                     for k, v in errors[path].items())
              for path in errors)
          + f"; loss limits: fp32 {RL_FP32_RTOL} x max(|loss|, the per-token terms' sum) , bf16 "
          f"{NO_FURTHER} x the plain bf16 terms' errors {budgets['plain_bf16']:.3e}", flush=True)
    scale = max(abs(truth["loss"]), float(truth["terms"].abs().sum()))
    for key, err in errors["kernel_fp32"].items():
        limit = RL_FP32_RTOL * (scale if key == "loss" else 1.0)
        check(err <= limit, f"rl parity: fp32 {key}: the kernel path is {err:.3e} from the "
              f"plain path (limit {limit:.3e})")
    for key, err in errors["kernel_bf16"].items():
        limit = (budgets["plain_bf16"] if key == "loss" else errors["plain_bf16"][key])
        check(err <= NO_FURTHER * limit,
              f"rl parity: bf16 {key}: the kernel path is further from fp32 ({err:.3e}) than "
              f"{NO_FURTHER} x the plain bf16 path's ({limit:.3e})")
    loss_fp32 = truth["loss"]
    del results, truth
    release()
    return dict(layers=layers, loss_fp32=loss_fp32, errors=errors, loss_budgets=budgets)


def rl_sync(card: str) -> dict:
    """Leg b, second half: a greedy request in flight across a weight sync
    at 2 layers of full width (bf16 compute, bf16 cache): `fused` and
    `host` leave bit-equal engine tensors and continue with the same
    tokens, which a fresh engine over the new weights, fed prompt + the
    tokens so far, also gives."""
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.ops.kernels import paged_attention as pa
    from llm_training_tpu_torch.rl.sync import sync_weights
    from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

    config = preset("llama-3.1-8b", num_hidden_layers=RL_SMALL_LAYERS, param_dtype="float32")
    serve = ServeConfig(max_batch=4, max_model_len=RL_PROMPT_LEN + 64, prefill_chunk=RL_PREFILL,
                        cache_dtype="bfloat16", eos_token_id=None)
    prompt = np.random.default_rng(5).integers(0, config.vocab_size, RL_PROMPT_LEN).tolist()
    total, before_sync = 48, 16

    def model(seed):
        m = Llama(config, device=RL_DEVICE)
        m.init_weights(torch.Generator(device=RL_DEVICE).manual_seed(seed))
        return m.eval().requires_grad_(False)

    target = model(4)
    runs, held = {}, {}
    pa.paged_decode_attention.launches = 0
    for mode in ("fused", "host"):
        engine = ServingEngine(model(3), serve, device=RL_DEVICE)
        tokens = [e["token"] for e in engine.submit(id="r", prompt=prompt, max_new_tokens=total)
                  if e["type"] == "token"]
        while len(tokens) < before_sync:
            tokens += [e["token"] for e in engine.step() if e["type"] == "token"]
        k = len(tokens)
        summary = sync_weights(engine, target.state_dict(keep_vars=True), mode=mode)
        done = None
        while done is None:
            done = next((e for e in engine.step() if e["type"] == "done"), None)
        runs[mode] = (k, done["tokens"], done["generation"], summary["sync_time_s"])
        held[mode] = {n: t.detach().clone() for n, t in engine.model.state_dict().items()}
        del engine
        release()
    k, tokens = runs["fused"][0], runs["fused"][1]
    fresh = ServingEngine(target, serve, device=RL_DEVICE)
    done = next((e for e in fresh.submit(id="f", prompt=prompt + tokens[:k],
                                         max_new_tokens=total - k) if e["type"] == "done"), None)
    while done is None:
        done = next((e for e in fresh.step() if e["type"] == "done"), None)
    equal = all(torch.equal(held["fused"][n], held["host"][n]) for n in held["fused"])
    out = dict(k=k, fused_equals_host=runs["fused"][:3] == runs["host"][:3], tensors_equal=equal,
               fresh_equal=tokens[k:] == done["tokens"], k4_launches=pa.paged_decode_attention.launches,
               sync_s={mode: runs[mode][3] for mode in runs})
    print(f"rl sync [{card}]: 2 layers full width, a greedy request of {RL_PROMPT_LEN} + {total} "
          f"tokens synced after {k}: fused {1e3 * runs['fused'][3]:.3f} ms, host "
          f"{1e3 * runs['host'][3]:.3f} ms; engine tensors bit-equal {equal}; continuations equal "
          f"(fused/host) {out['fused_equals_host']}, equal to a fresh engine's {out['fresh_equal']}; "
          f"K4 {out['k4_launches']} launches", flush=True)
    check(equal and out["fused_equals_host"] and out["fresh_equal"] and out["k4_launches"] > 0
          and runs["fused"][2] == 1,
          f"rl sync: tensors equal {equal}, fused {runs['fused'][:3]}, host {runs['host'][:3]}, "
          f"fresh {done['tokens']}")
    del held, target, fresh
    release()
    return out


def rl_cast_cost(card: str) -> dict:
    """What decoding from fp32 master weights costs: leg a's engine reads
    the trainer's fp32 parameters and casts them to bf16 at each product.
    The decode step of 32 rows of 256 + 64 tokens at RL_LAYERS layers, from fp32
    parameters and from a bf16 copy, in turns (fp32, bf16, bf16, fp32)."""
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.models.llama.model import Llama
    from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

    rows, new = RL_PROMPTS * RL_GROUP, 64
    fp32 = Llama(preset("llama-3.1-8b", num_hidden_layers=RL_LAYERS, param_dtype="float32"),
                 device=RL_DEVICE)
    fp32.init_weights(torch.Generator(device=RL_DEVICE).manual_seed(0))
    bf16 = Llama(preset("llama-3.1-8b", num_hidden_layers=RL_LAYERS, param_dtype="bfloat16"),
                 device=RL_DEVICE)
    bf16.load_state_dict(fp32.state_dict())
    models = {"fp32": fp32.eval().requires_grad_(False), "bf16": bf16.eval().requires_grad_(False)}
    serve = ServeConfig(max_batch=rows, max_model_len=RL_PROMPT_LEN + new, prefill_chunk=RL_PREFILL,
                        cache_dtype="bfloat16", eos_token_id=None)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, fp32.config.vocab_size, RL_PROMPT_LEN).tolist() for _ in range(rows)]
    steps = {"fp32": [], "bf16": []}
    for turn in ("fp32", "bf16", "bf16", "fp32"):
        engine = ServingEngine(models[turn], serve, device=RL_DEVICE)
        for i, prompt in enumerate(prompts):
            engine.submit(id=str(i), prompt=prompt, max_new_tokens=new)
        while not engine.scheduler.idle:
            chunks = engine.prefill_chunks
            t0 = time.perf_counter()
            engine.step()  # ends in the sampled tokens' copy to the host
            if engine.prefill_chunks == chunks:  # a decode step alone
                steps[turn].append(time.perf_counter() - t0)
        del engine
        release()
    p50 = {k: 1e3 * percentile(v, 50) for k, v in steps.items()}
    out = dict(decode_step_ms_p50=p50, overhead_pct=100 * (p50["fp32"] / p50["bf16"] - 1),
               steps=len(steps["fp32"]))
    print(f"rl cast cost [{card}]: decode step of {rows} rows ({RL_PROMPT_LEN} + {new} tokens) at "
          f"{RL_LAYERS} layers, p50 over {out['steps']} steps in two turns: fp32 parameters cast "
          f"at each product {p50['fp32']:.3f} ms, a bf16 copy {p50['bf16']:.3f} ms "
          f"({out['overhead_pct']:+.1f}%)", flush=True)
    check(all(math.isfinite(v) and v > 0 for v in p50.values()), f"rl cast cost: {p50}")
    del models, fp32, bf16
    release()
    return out


def rl_leg_c(card: str) -> dict:
    """Leg c: `rl-fit` at 2 layers of full width under SGD with a
    checkpointer and the rollout journal: SIGTERM in the middle of round 2
    (exit 75, the journal written, the round cursor checkpointed), then a
    relaunch with host sync that adopts the journaled rollouts and
    finishes (exit 0); no stale sample is trained on."""
    optim = {"optimizer": "sgd", "learning_rate": RL_LR, "lr_scheduler": "constant",
             "warmup_steps": 0, "grad_clip_norm": 1.0}
    path = rl_config("c", RL_SMALL_LAYERS, optim, checkpoint=True)
    free = free_bytes(RL_DIR)
    # three 11.9 GB steps (max_to_keep 3) and a forced save's staged clone
    check(free >= 40e9, f"rl resume: {free} bytes free in {RL_DIR}, the leg needs 40 GB")
    run_dir = RL_DIR / "c" / "run" / "log"
    rc, wall, summary, records, text = rl_child(
        "c1", rl_argv(path, RL_RESUME_ROUNDS), env={"SMOKE_RL_SIGTERM": str(RL_SIGTERM_STEP)})
    journal = run_dir / "rl-journal.jsonl"
    entries = []
    if journal.exists():
        from llm_training_tpu_torch.serve.journal import replay_journal

        entries = replay_journal(journal)
    meta = json.loads((RL_DIR / "c" / "ckpt" / "step_1" / "meta.json").read_text()) if (
        RL_DIR / "c" / "ckpt" / "step_1").is_dir() else {}
    first = dict(rc=rc, wall_s=wall, journaled=len(entries),
                 journaled_tokens=sum(len(e["generated"]) for e in entries),
                 cursor=meta.get("rl"), rounds=[r["round"] for r in records
                                                if r.get("type") == "rl_round"])
    check(rc == 75 and entries and meta.get("rl") == {"round": 1} and first["rounds"] == [0],
          f"rl resume: SIGTERM run exited {rc}, journaled {len(entries)}, cursor "
          f"{meta.get('rl')}, rounds {first['rounds']}: {text[-3000:]}")
    rc, wall, summary, records, text = rl_child("c2", rl_argv(path, RL_RESUME_ROUNDS, "--sync-mode",
                                                              "host"))
    stats = next((r["stats"] for r in records if r.get("type") == "stats"), {})
    rounds = [r["round"] for r in records if r.get("type") == "rl_round"]
    second = dict(rc=rc, wall_s=wall, rounds=rounds, stats={
        k: stats.get(k) for k in ("serve/replayed_requests", "rl/rollouts_collected",
                                  "rl/rollouts_submitted", "rl/rollouts_stale_dropped",
                                  "rl/weight_syncs", "rl/sync_time_s")},
        launches=summary["launches"] if summary else None)
    replayed = stats.get("serve/replayed_requests", 0)
    check(rc == 0 and rounds == [1] and replayed == len(entries)
          and stats.get("rl/rollouts_stale_dropped") == 0
          and stats.get("rl/rollouts_collected") == RL_PROMPTS * RL_GROUP
          and stats.get("rl/rollouts_submitted") == RL_PROMPTS * RL_GROUP - replayed
          and not journal.exists(),
          f"rl resume: relaunch exited {rc}, rounds {rounds}, stats {second['stats']}, journal "
          f"left {journal.exists()}: {text[-3000:]}")
    ckpt = RL_DIR / "c" / "ckpt" / "step_2"
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    out = dict(first=first, second=second, checkpoint_bytes=size)
    print(f"rl resume [{card}]: 2 layers full width, SGD, a {size / 1e9:.2f} GB checkpoint of the "
          f"policy and the reference a round; SIGTERM {RL_SIGTERM_STEP} engine steps into round 2: "
          f"exit 75 after {first['wall_s']:.1f} s, {first['journaled']} rollouts journaled "
          f"({first['journaled_tokens']} tokens), cursor {first['cursor']}; the relaunch (host "
          f"sync) replayed and adopted {replayed:.0f}, submitted "
          f"{second['stats']['rl/rollouts_submitted']:.0f}, collected "
          f"{second['stats']['rl/rollouts_collected']:.0f}, stale dropped "
          f"{second['stats']['rl/rollouts_stale_dropped']:.0f}, exit 0 after "
          f"{second['wall_s']:.1f} s", flush=True)
    return out


def phase_rl(card: str) -> dict:
    """rl-fit: GRPO over the serving engine (see the header)."""
    shutil.rmtree(RL_DIR, ignore_errors=True)
    RL_DIR.mkdir()
    out = {}
    try:
        for name, leg in (("a", rl_leg_a), ("parity", rl_parity), ("sync", rl_sync),
                          ("cast", rl_cast_cost), ("c", rl_leg_c)):
            t0 = time.perf_counter()
            out[name] = leg(card)
            out[name]["leg_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(RL_DIR, ignore_errors=True)
        release()
    return out


# ------------------------------------------------------------------ phase 18: serve resilience

SV_DIR = ROOT / ".smoke_serve"
SV_DEVICE = "cuda"
SV_PRESET = "llama-3.1-8b"
SV_A_LAYERS = 8  # leg a: the preset cut to 8 layers (for the smoke's time limit)
# leg a's model flags: None is the preset cut to SV_A_LAYERS, written as a
# `--model-config` file (a CPU rehearsal passes a file of a narrow model)
SV_MODEL_ARGS = None
SV_BATCH = 8
SV_MAX_LEN = 2048
SV_CHUNK = 256
SV_PROMPTS = (32, 1024)  # prompt lengths, inclusive
SV_WARM = 8  # leg a: warm-up requests that seed the service-time EMA
SV_BURST = 48  # leg a: then this many at once
SV_NEW = 64
SV_B_LAYERS = 2  # leg b: the journal and the supervisor (cut from 8 for the smoke's time limit)
SV_B_REQUESTS = 16
SV_B_NEW = 128
SV_SIGTERM_STEP = 40
SV_DRAIN_S = 1.0
SV_C_LAYERS = 2  # leg c: the watchdog
SV_C_REQUESTS = 8
SV_C_NEW = 32
SV_STALL_STEP = 10
SV_WATCHDOG_S = 6.0
SV_SCRAPE_S = 0.5  # ~2 Hz
SV_A_WATCHDOG_S = 60.0  # leg a: /healthz reads a real beat
SV_TILE_S = 0.05  # a residency's spans against its wall clock
SV_TIMEOUT_S = 300.0

# a serving process of phase 18: the CLI's `serve` (argv) with K4's launch
# count, the plain decode path's calls (the gather path at one query token),
# decode-only step times and the drain/replay instants recorded; it writes
# one JSON summary at exit (and, with SMOKE_SERVE_STEP_SUMMARY, after every
# engine step too, for a process the watchdog aborts) to
# $SMOKE_SERVE_OUT.<pid>.json. With SMOKE_SERVE_HOOKS=<path> (leg a) it also
# attaches a request journal at <path> to the engine, as a run dir's serve
# does, and measures the per-step host work of the tracer, the journal and
# the watchdog's beat in this process: each call on the loop thread is
# timed inclusively, and the engine steps cycle through all on, the tracer
# disabled and the journal detached, so adjacent decode-only steps compare
_SERVE_CHILD = r"""
import time
T_START = time.time()
import atexit, json, os, sys, threading
import torch
sys.path.insert(0, os.getcwd())
from llm_training_tpu_torch.cli import main as cli
from llm_training_tpu_torch.ops import paged_attention as ops_pa
from llm_training_tpu_torch.ops.kernels import paged_attention as pa
from llm_training_tpu_torch.resilience import chaos
from llm_training_tpu_torch.resilience.watchdog import HangWatchdog
from llm_training_tpu_torch.serve.engine import ServingEngine
from llm_training_tpu_torch.serve.journal import RequestJournal
from llm_training_tpu_torch.telemetry.registry import get_registry
from llm_training_tpu_torch.telemetry.trace import TraceRecorder, get_tracer

out = {"pid": os.getpid(), "attempt": os.environ.get("LLMT_SUPERVISOR_ATTEMPT"),
       "t_start": T_START}
engines, plain, step_ms, step_t0 = [], [0], [], []
real_gather = ops_pa._gather_attention

def gather(q, *args, **kwargs):
    plain[0] += q.shape[1] == 1
    return real_gather(q, *args, **kwargs)

def wrap(name, after):
    real = getattr(ServingEngine, name)
    def wrapped(self, *args, **kwargs):
        before = (self.decode_steps, self.prefill_chunks) if name == "step" else None
        wall, t = time.time(), time.perf_counter()
        result = real(self, *args, **kwargs)
        after(self, result, before, t, wall)
        return result
    setattr(ServingEngine, name, wrapped)

def stepped(self, result, before, t, wall):
    if (self.decode_steps, self.prefill_chunks) == (before[0] + 1, before[1]):
        step_ms.append(1e3 * (time.perf_counter() - t))
        step_t0.append(wall)
    if every_step:
        summary()

def resumed(self, result, before, t, wall):
    out["t_replayed"] = time.time()

def drained(self, result, before, t, wall):
    out["drain"], out["t_drained"] = result, time.time()

hooks = os.environ.get("SMOKE_SERVE_HOOKS")
real_init = ServingEngine.__init__
def init(self, *args, **kwargs):
    real_init(self, *args, **kwargs)
    engines.append(self)
    if hooks and self.journal is None:
        self.attach_journal(RequestJournal(hooks))
ServingEngine.__init__ = init
ops_pa._gather_attention = gather
wrap("step", stepped)
wrap("submit_resumed", resumed)
wrap("drain", drained)

# SMOKE_SERVE_HOOKS: "<bucket> <mode>" -> [seconds, calls] on the loop
# thread, the outermost call counted once, mode the engine step's (or
# "between" steps); engine steps a mode; (engine step, mode, ms) of each
# decode-only step
cost, mode_steps, ab_steps = {}, {}, []
LOOP, nested, current = threading.get_ident(), [0], ["between"]

def timed(cls, name, bucket):
    real = getattr(cls, name)
    def wrapped(*args, **kwargs):
        if nested[0] or threading.get_ident() != LOOP:
            return real(*args, **kwargs)
        nested[0] += 1
        t = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            entry = cost.setdefault(f"{bucket} {current[0]}", [0.0, 0])
            entry[0] += time.perf_counter() - t
            entry[1] += 1
            nested[0] -= 1
    setattr(cls, name, wrapped)

if hooks:
    for name in ("span", "instant", "sample_request"):
        timed(TraceRecorder, name, "tracer")
    for name in ("delivered", "accepted", "progress", "finished"):
        timed(RequestJournal, name, "journal")
    timed(HangWatchdog, "beat", "beat")
    MODES = ("on", "tracer_off", "journal_off")
    timed_step = ServingEngine.step
    def ab_step(self):
        mode = MODES[self.step_index % len(MODES)]
        tracer, journal = get_tracer(), self.journal
        enabled = tracer.enabled
        tracer.enabled = enabled and mode != "tracer_off"
        if mode == "journal_off":
            self.journal = None
        timed_before = len(step_ms)
        current[0] = mode
        try:
            return timed_step(self)
        finally:
            current[0] = "between"
            mode_steps[mode] = mode_steps.get(mode, 0) + 1
            tracer.enabled, self.journal = enabled, journal
            if len(step_ms) > timed_before:
                ab_steps.append((self.step_index, mode, step_ms[-1]))
    ServingEngine.step = ab_step
    real_stats = ServingEngine.stats
    def stats(self):
        # the CLI's last call before exit: the journal is this process's
        # own, so it is closed here (a run dir's serve unlinks its own)
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        return real_stats(self)
    ServingEngine.stats = stats
real_sigterm = chaos.Chaos.maybe_serve_sigterm_mid_stream
def sigterm(self, step):
    fired = real_sigterm(self, step)
    if fired:
        out["t_sigterm"] = time.time()
    return fired
chaos.Chaos.maybe_serve_sigterm_mid_stream = sigterm
pa.paged_decode_attention.launches = 0
every_step = bool(os.environ.get("SMOKE_SERVE_STEP_SUMMARY"))

def summary():
    engine = engines[-1] if engines else None
    values = get_registry().snapshot()
    out.update(
        t_exit=time.time(), launches=pa.paged_decode_attention.launches,
        plain_decode_calls=plain[0], decode_step_ms=step_ms, decode_step_t0=step_t0,
        decode_steps=engine.decode_steps if engine else 0,
        engine_steps=engine.step_index if engine else 0,
        replayed=engine.replayed_requests if engine else 0,
        profile={k: v for k, v in values.items() if k.startswith("profile/")},
        trace=get_tracer().counts(), hook_cost=cost, mode_steps=mode_steps, ab_steps=ab_steps,
        journal_bytes=os.path.getsize(hooks) if hooks and os.path.exists(hooks) else 0,
        peak_bytes=torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0)
    with open(f"{os.environ['SMOKE_SERVE_OUT']}.{os.getpid()}.json", "w") as f:
        json.dump(out, f)

atexit.register(summary)
sys.exit(cli.main(sys.argv[1:]))
"""

# `supervise` through the CLI, its serve children started through
# `_SERVE_CHILD` (the same argv after the interpreter)
_SUPERVISE_DRIVER = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
from llm_training_tpu_torch.cli import main as cli
real = cli.build_serve_argv
def build(*args, **kwargs):
    argv = real(*args, **kwargs)
    assert argv[1:4] == ["-m", "llm_training_tpu_torch", "serve"], argv
    return [argv[0], "-c", chip_smoke._SERVE_CHILD, *argv[3:]]
cli.build_serve_argv = build
sys.exit(cli.main(sys.argv[1:]))
"""


def sv_requests(seed: int, n: int, new: int, vocab: int, prefix: str) -> list[dict]:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SV_PROMPTS[0], SV_PROMPTS[1] + 1, size=n)
    return [{"id": f"{prefix}{i}", "prompt": rng.integers(0, vocab, int(k)).tolist(),
             "max_new_tokens": new} for i, k in enumerate(lengths)]


def sv_serve_flags(*extra: str) -> list[str]:
    return ["--device", SV_DEVICE, "--max-batch", str(SV_BATCH), "--max-model-len",
            str(SV_MAX_LEN), "--prefill-chunk", str(SV_CHUNK), *extra]


def sv_summaries(prefix: str) -> list[dict]:
    """The `_SERVE_CHILD` summaries written under `prefix`, in start order."""
    found = [json.loads(p.read_text()) for p in SV_DIR.glob(f"{Path(prefix).name}.*.json")]
    return sorted(found, key=lambda s: s["t_start"])


def sv_get(port: int, path: str, timeout: float = 2.0) -> tuple[int, str]:
    """(status, body) of one GET on the local exporter; (0, error) when it
    does not answer."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError as e:
        return 0, str(e)


class Scraper:
    """Polls `/metrics` and `/healthz` of a local exporter every `every`
    seconds on a thread: every `/metrics` body goes through the port's
    `parse_prometheus_text` (a parse error is kept, and fails the leg)."""

    def __init__(self, port: int, every: float, metrics: bool = True):
        import threading

        self.port, self.every, self.metrics = port, every, metrics
        self.scrapes, self.health, self.errors, self.scrape_ms = [], [], [], []
        self.windows = []  # (start, end) wall seconds of each /metrics scrape
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        from llm_training_tpu_torch.telemetry.exporter import parse_prometheus_text

        while not self._stop.is_set():
            if self.metrics:
                t, wall = time.perf_counter(), time.time()
                code, body = sv_get(self.port, "/metrics")
                if code == 200:
                    self.scrape_ms.append(1e3 * (time.perf_counter() - t))
                    self.windows.append((wall, time.time()))
                    try:
                        self.scrapes.append(parse_prometheus_text(body))
                    except ValueError as e:
                        self.errors.append(str(e))
            code, _ = sv_get(self.port, "/healthz")
            if code:
                self.health.append((time.time(), code))
            self._stop.wait(self.every)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class Stream:
    """A serving process (or a supervisor of them) on pipes: lines written
    to its stdin, its JSON stdout records collected by a thread."""

    def __init__(self, argv: list[str], env: dict, log: Path):
        import queue
        import subprocess
        import threading

        self._log = open(log, "w")
        self.proc = subprocess.Popen(argv, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self._log, text=True, env={**os.environ, **env},
                                     start_new_session=True)
        self.records: list[dict] = []
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("{"):
                self._queue.put(json.loads(line))
        self._queue.put(None)

    def send(self, records: list[dict]) -> None:
        self.proc.stdin.write("".join(json.dumps(r) + "\n" for r in records))
        self.proc.stdin.flush()

    def until(self, done, timeout: float = SV_TIMEOUT_S) -> None:
        """Collect records until `done(records)` or the stream ends."""
        import queue

        deadline = time.monotonic() + timeout
        while not done(self.records):
            try:
                record = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise SmokeFailure(f"serve: no progress in {timeout:.0f} s") from None
            if record is None:
                return
            self.records.append(record)

    def finish(self, timeout: float = SV_TIMEOUT_S) -> int:
        """Close stdin, collect to the end, and return the exit code."""
        self.proc.stdin.close()
        self.until(lambda records: False, timeout)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            self.kill()

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self._log.close()


def sv_done(records: list[dict]) -> dict[str, list[dict]]:
    done: dict[str, list[dict]] = {}
    for record in records:
        if record.get("type") == "done":
            done.setdefault(record["id"], []).append(record)
    return done


def sv_streams(records: list[dict]) -> dict[str, list[int]]:
    streams: dict[str, list[int]] = {}
    for record in records:
        if record.get("type") == "token":
            streams.setdefault(record["id"], []).append(record["token"])
    return streams


def sv_leg_a_run(name: str, flags: list[str], warm: list[dict], burst: list[dict],
                 port: int) -> dict:
    """One full-depth `serve` process: the warm-up, then (after its last
    terminal) the burst; its exporter on `port` scraped at ~2 Hz throughout
    and once after the last terminal."""
    prefix = str(SV_DIR / f"a-{name}")
    env = {"SMOKE_SERVE_OUT": prefix, "SMOKE_SERVE_HOOKS": str(SV_DIR / f"a-{name}.journal"),
           "LLMT_METRICS_PORT": str(port)}
    argv = [sys.executable, "-c", _SERVE_CHILD, "serve", *SV_MODEL_ARGS,
            *sv_serve_flags("--max-new-tokens", str(SV_NEW), "--watchdog-timeout-s",
                            str(SV_A_WATCHDOG_S), *flags)]
    stream = Stream(argv, env, SV_DIR / f"a-{name}.log")
    scraper = Scraper(port, SV_SCRAPE_S)
    try:
        with scraper:
            stream.send(warm)
            stream.until(lambda r: len(sv_done(r)) >= len(warm))
            t_burst = time.perf_counter()
            stream.send(burst)
            stream.until(lambda r: len(sv_done(r)) >= len(warm) + len(burst))
            burst_s = time.perf_counter() - t_burst
            code, body = sv_get(port, "/metrics")
            check(code == 200, f"serve {name}: the final scrape answered {code}: {body[:200]}")
            from llm_training_tpu_torch.telemetry.exporter import parse_prometheus_text

            final = parse_prometheus_text(body)
        rc = stream.finish()
    finally:
        stream.kill()
    text = (SV_DIR / f"a-{name}.log").read_text()
    summaries = sv_summaries(prefix)
    check(rc == 0 and len(summaries) == 1, f"serve {name}: exit {rc}: {text[-3000:]}")
    child = summaries[0]
    done = sv_done(stream.records)
    check(all(len(v) == 1 for v in done.values()) and len(done) == len(warm) + len(burst),
          f"serve {name}: terminals {sorted((k, len(v)) for k, v in done.items())}")
    warm_ids = {r["id"] for r in warm}
    completed = [v[0] for v in done.values() if v[0]["stop_reason"] in ("eos", "max_tokens")]
    ttft = [d["ttft_ms"] for d in completed]
    out = dict(
        rc=rc, burst_s=burst_s,
        warm_ttft_ms_p50=percentile([done[i][0]["ttft_ms"] for i in warm_ids], 50),
        ttft_ms_p50=percentile(ttft, 50), ttft_ms_p99=percentile(ttft, 99),
        completed=len(completed),
        overloaded=sum(v[0]["stop_reason"] == "overloaded" for v in done.values()),
        other=sorted({v[0]["stop_reason"] for v in done.values()} - {"max_tokens", "overloaded"}),
        decode_step_ms_p50=percentile(child["decode_step_ms"], 50),
        decode_steps_timed=len(child["decode_step_ms"]),
        decode_steps=child["decode_steps"], engine_steps=child["engine_steps"],
        launches=child["launches"], plain_decode_calls=child["plain_decode_calls"],
        trace_recorded=child["trace"]["recorded"], trace_written=child["trace"]["written"],
        layers=None, hooks=sv_hook_costs(child), journal_bytes=child["journal_bytes"],
    )
    stats = next((r["stats"] for r in stream.records if r.get("type") == "stats"), {})
    out["stats_completed"] = stats.get("serve/requests_completed")
    out["stats_shed"] = stats.get("serve/shed_total")
    healthz = [code for _, code in scraper.health]
    # decode steps that overlapped a /metrics render against the rest
    overlapped = [ms for ms, t0 in zip(child["decode_step_ms"], child["decode_step_t0"])
                  if any(a < t0 + ms / 1e3 and t0 < b for a, b in scraper.windows)]
    alone = [ms for ms, t0 in zip(child["decode_step_ms"], child["decode_step_t0"])
             if not any(a < t0 + ms / 1e3 and t0 < b for a, b in scraper.windows)]
    out.update(steps_scraped=len(overlapped),
               decode_step_ms_p50_scraped=percentile(overlapped, 50) if overlapped else math.nan,
               decode_step_ms_p50_unscraped=percentile(alone, 50) if alone else math.nan)
    out.update(scrapes=len(scraper.scrapes), scrape_errors=scraper.errors,
               scrape_ms_p50=percentile(scraper.scrape_ms, 50) if scraper.scrape_ms else None,
               healthz=sorted(set(healthz)), healthz_n=len(healthz),
               final_completed=final.get("llmt_serve_requests_completed"))
    check(not scraper.errors and len(scraper.scrapes) >= 2,
          f"serve {name}: scrapes {len(scraper.scrapes)}, parse errors {scraper.errors[:3]}")
    check(healthz and set(healthz) == {200}, f"serve {name}: /healthz answered {set(healthz)}")
    check(out["final_completed"] == len(completed),
          f"serve {name}: the final scrape counts {out['final_completed']} completions, "
          f"the client {len(completed)}")
    check(child["launches"] > 0 and child["plain_decode_calls"] == 0
          and child["launches"] % max(1, child["decode_steps"]) == 0,
          f"serve {name}: K4 {child['launches']} launches for {child['decode_steps']} decode "
          f"steps, plain decode calls {child['plain_decode_calls']}")
    out["layers"] = child["launches"] // max(1, child["decode_steps"])
    return out


def sv_hook_costs(child: dict) -> dict:
    """SMOKE_SERVE_HOOKS' readings of one process (see `_SERVE_CHILD`): the
    tracer's, the journal's and the beat's host microseconds and calls an
    engine step on the loop thread with everything on (calls inside the
    "on" steps over those steps, plus calls between steps over all steps),
    and each mode's decode-only step p50 with the difference to the
    adjacent "on" step (its p25, p50, p75 over the pairs)."""
    cost, steps = child["hook_cost"], child["mode_steps"]
    n_on, n_all = max(1, steps.get("on", 0)), max(1, sum(steps.values()))
    out = {}
    for bucket in ("tracer", "journal", "beat"):
        on = cost.get(f"{bucket} on", [0.0, 0])
        between = cost.get(f"{bucket} between", [0.0, 0])
        out[f"{bucket}_us_per_step"] = 1e6 * (on[0] / n_on + between[0] / n_all)
        out[f"{bucket}_calls_per_step"] = on[1] / n_on + between[1] / n_all
    # an entry's step is the engine's index after it; its mode was chosen
    # from the index before: tracer_off follows an "on" step, journal_off
    # precedes one
    by_step = {step: (mode, ms) for step, mode, ms in child["ab_steps"]}
    out["on_ms_p50"] = percentile([ms for mode, ms in by_step.values() if mode == "on"], 50)
    for mode, offset in (("tracer_off", -1), ("journal_off", 1)):
        diffs = [ms - by_step[step + offset][1] for step, (m, ms) in by_step.items()
                 if m == mode and by_step.get(step + offset, ("",))[0] == "on"]
        out[mode] = dict(
            pairs=len(diffs),
            ms_p50=percentile([ms for m, ms in by_step.values() if m == mode], 50),
            diff_ms=[percentile(diffs, q) for q in (25, 50, 75)] if diffs else None)
    return out


def sv_tracer_cost() -> dict:
    """Host microseconds a tracer event costs, ring and sink (a span and an
    instant per pair, as the engine emits them)."""
    from llm_training_tpu_torch.telemetry.trace import TraceRecorder

    tracer = TraceRecorder(capacity=2048, sample_every=1, enabled=True)
    tracer.attach_sink(SV_DIR / "tracer-cost.jsonl")
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        now = tracer.clock()
        tracer.span("serve", "engine_step", now, now + 1e-3, step=i, running=8, waiting=0)
        tracer.instant("serve", "first_token", ts=now, request_id=f"r{i}", ttft_ms=1.0)
    seconds = time.perf_counter() - t0
    tracer.detach_sink()
    return {"us_per_event": 1e6 * seconds / (2 * n)}


def sv_journal_cost() -> dict:
    """Host microseconds of one progress record (a JSON line written and
    flushed to this disk) with nothing else running, as the engine writes
    one for each running row a step: 8 rows, one token and log-probability
    more each time."""
    from types import SimpleNamespace

    from llm_training_tpu_torch.serve.journal import RequestJournal

    journal = RequestJournal(SV_DIR / "journal-cost.jsonl")
    rows = [SimpleNamespace(id=f"r{i}", generated=[], logprobs=[], emitted=0) for i in range(8)]
    n = 2000
    t0 = time.perf_counter()
    for step in range(n):
        for row in rows:
            row.generated.append(step)
            row.logprobs.append(-1.0)
            row.emitted += 1
            journal.progress(row)
    seconds = time.perf_counter() - t0
    journal.close()
    return {"us_per_record": 1e6 * seconds / (n * len(rows))}


def sv_leg_a(card: str) -> dict:
    """SV_A_LAYERS layers: without shedding (scraped), then with shedding,
    on the same requests; the tracer's, the journal's and the beat's cost a
    step measured inside both processes."""
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.telemetry.exporter import find_free_port

    global SV_MODEL_ARGS
    if SV_MODEL_ARGS is None:
        path = SV_DIR / f"model-{SV_A_LAYERS}.json"
        path.write_text(json.dumps(dataclasses.asdict(
            preset(SV_PRESET, num_hidden_layers=SV_A_LAYERS))))
        SV_MODEL_ARGS = ["--model-config", str(path)]
    vocab = preset(SV_PRESET).vocab_size
    requests = sv_requests(0, SV_WARM + SV_BURST, SV_NEW, vocab, "r")
    warm, burst = requests[:SV_WARM], requests[SV_WARM:]
    plain = sv_leg_a_run("plain", [], warm, burst, find_free_port())
    limit = 2.0 * plain["warm_ttft_ms_p50"]
    shed = sv_leg_a_run("shed", ["--max-queue", "8", "--shed-ttft-ms", f"{limit:.3f}"],
                        warm, burst, find_free_port())
    check(plain["overloaded"] == 0 and not plain["other"],
          f"serve: the unshed run ended {plain['overloaded']} overloaded, other {plain['other']}")
    check(shed["overloaded"] > 0 and shed["overloaded"] + shed["completed"] == len(requests)
          and shed["stats_shed"] == shed["overloaded"],
          f"serve: the shedding run ended {shed['overloaded']} overloaded of {len(requests)} "
          f"(stats shed {shed['stats_shed']})")
    for name, run in (("plain", plain), ("shed", shed)):
        hooks = run["hooks"]
        check(hooks["tracer_calls_per_step"] > 0 and hooks["journal_calls_per_step"] > 0
              and hooks["beat_calls_per_step"] > 0 and run["journal_bytes"] > 0
              and hooks["tracer_off"]["pairs"] > 0 and hooks["journal_off"]["pairs"] > 0,
              f"serve {name}: the in-process cost hooks saw {hooks}")
    cost = sv_tracer_cost()
    journal_cost = sv_journal_cost()
    hooks = plain["hooks"]
    step_us = 1e3 * hooks["on_ms_p50"]
    out = dict(plain=plain, shed=shed, shed_ttft_ms=limit, tracer=cost, journal=journal_cost,
               events_per_step=hooks["tracer_calls_per_step"],
               tracer_share_pct=100.0 * hooks["tracer_us_per_step"] / step_us,
               journal_share_pct=100.0 * hooks["journal_us_per_step"] / step_us,
               beat_share_pct=100.0 * hooks["beat_us_per_step"] / step_us,
               microbench_share_pct=100.0 * hooks["tracer_calls_per_step"]
               * cost["us_per_event"] / step_us)
    for name in ("plain", "shed"):
        run = out[name]
        print(f"serve resilience a/{name} [{card}]: {SV_PRESET} x {run['layers']} layers, bf16, "
              f"{SV_WARM} warm-up + a burst of {SV_BURST} ({SV_NEW} new tokens): TTFT p50 "
              f"{run['ttft_ms_p50']:.1f} ms, p99 {run['ttft_ms_p99']:.1f} ms over "
              f"{run['completed']} completed; {run['overloaded']} overloaded; decode step p50 "
              f"{run['decode_step_ms_p50']:.3f} ms ({run['decode_steps_timed']} decode-only "
              f"steps); K4 {run['launches']} launches ({run['decode_steps']} decode steps), plain "
              f"decode calls {run['plain_decode_calls']}; warm-up TTFT p50 "
              f"{run['warm_ttft_ms_p50']:.1f} ms", flush=True)
        h = run["hooks"]
        diffs = {m: "n/a" if h[m]["diff_ms"] is None else
                 "{:+.3f} ms (p25 {:+.3f}, p75 {:+.3f})".format(h[m]["diff_ms"][1],
                                                               h[m]["diff_ms"][0],
                                                               h[m]["diff_ms"][2])
                 for m in ("tracer_off", "journal_off")}
        print(f"serve resilience a/{name} host work a step, in process [{card}]: tracer "
              f"{h['tracer_us_per_step']:.1f} us ({h['tracer_calls_per_step']:.2f} calls), "
              f"journal {h['journal_us_per_step']:.1f} us ({h['journal_calls_per_step']:.2f} "
              f"calls, {run['journal_bytes']} bytes written), beat {h['beat_us_per_step']:.1f} "
              f"us ({h['beat_calls_per_step']:.2f} calls); decode-only step p50 all on "
              f"{h['on_ms_p50']:.3f} ms, tracer off {h['tracer_off']['ms_p50']:.3f} ms, journal "
              f"detached {h['journal_off']['ms_p50']:.3f} ms; against the adjacent all-on step: "
              f"tracer off {diffs['tracer_off']} over {h['tracer_off']['pairs']} pairs, journal "
              f"detached {diffs['journal_off']} over {h['journal_off']['pairs']} pairs",
              flush=True)
    print(f"serve resilience a [{card}]: shedding at --max-queue 8 --shed-ttft-ms {limit:.1f}; "
          f"{plain['scrapes']} scrapes parsed (p50 {plain['scrape_ms_p50']:.2f} ms a scrape), "
          f"/healthz {plain['healthz']} x{plain['healthz_n']}, final scrape "
          f"{plain['final_completed']:.0f} completions = the client's {plain['completed']}; in "
          f"the scraped run, the {plain['steps_scraped']} steps beside a scrape p50 "
          f"{plain['decode_step_ms_p50_scraped']:.3f} ms, the others "
          f"{plain['decode_step_ms_p50_unscraped']:.3f} ms; of the all-on decode step p50: "
          f"tracer {out['tracer_share_pct']:.3f}%, journal {out['journal_share_pct']:.3f}%, "
          f"beat {out['beat_share_pct']:.4f}% (timed in process); the tracer's microbenchmark "
          f"{cost['us_per_event']:.2f} us an event x {out['events_per_step']:.2f} calls a step "
          f"= {out['microbench_share_pct']:.3f}%; the journal's microbenchmark "
          f"{journal_cost['us_per_record']:.2f} us a progress record, in the loop "
          f"{hooks['journal_us_per_step'] / max(hooks['journal_calls_per_step'], 1e-9):.2f} us a "
          f"call", flush=True)
    return out


def sv_config(name: str, layers: int, dtype: str, run_name: str) -> Path:
    """A CLM config at Llama-3.1-8B widths cut to `layers`, parameters and
    compute in `dtype`, a checkpointer under SV_DIR/<name>/ckpt and a JSONL
    logger whose run directory (SV_DIR/<name>/run/<run_name>) holds the
    serve journal and trace."""
    from dataclasses import asdict

    from llm_training_tpu_torch.models.llama.config import preset

    model = asdict(preset(SV_PRESET, num_hidden_layers=layers, param_dtype=dtype,
                          compute_dtype=dtype))
    config = {
        "seed_everything": 0,
        "trainer": {
            "max_steps": 1, "seed": 0,
            "checkpoint": {"dirpath": str(SV_DIR / name / "ckpt"), "async_save": False},
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": str(SV_DIR / name), "project": "run",
                                       "name": run_name}}],
        },
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": model},
            "optim": {"optimizer": "sgd", "learning_rate": 1e-4, "lr_scheduler": "constant",
                      "warmup_steps": 0}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 1, "max_length": 16, "num_samples": 4,
                               "vocab_size": model["vocab_size"]}},
    }
    path = SV_DIR / f"{name}-{run_name}.json"
    path.write_text(json.dumps(config))
    return path


def sv_fit(path: Path) -> float:
    """`fit` of one config in this process (a checkpoint); its seconds."""
    from llm_training_tpu_torch.cli.main import main as cli_main

    t0 = time.perf_counter()
    check(cli_main(["fit", "--config", str(path), "--device", SV_DEVICE]) == 0,
          f"serve fit: {path.name} failed")
    release()
    return time.perf_counter() - t0


def sv_tiling(run_dir: Path) -> dict:
    """The `trace` command's export of `run_dir`: every residency that
    reaches its `done` (from its `submit`) is tiled by its queue, prefill and
    decode spans within SV_TILE_S."""
    from llm_training_tpu_torch.cli.main import main as cli_main

    check(cli_main(["trace", str(run_dir)]) == 0, f"trace: no export of {run_dir}")
    events = json.loads((run_dir / "trace-export.json").read_text())["traceEvents"]
    by_track: dict[tuple, list[dict]] = {}
    for event in events:
        if event.get("cat") == "serve" and event.get("ph") in ("X", "i"):
            by_track.setdefault((event["pid"], event["tid"]), []).append(event)
    gaps, residencies = [], 0
    for track in by_track.values():
        track.sort(key=lambda e: e["ts"])
        submits = [e for e in track if e["name"] == "submit"]
        for i, submit in enumerate(submits):
            end = submits[i + 1]["ts"] if i + 1 < len(submits) else float("inf")
            done = [e for e in track if e["name"] == "done" and submit["ts"] <= e["ts"] < end]
            if not done:
                continue
            spans = [e for e in track if e["ph"] == "X" and e["name"] in ("queue", "prefill", "decode")
                     and submit["ts"] <= e["ts"] < done[0]["ts"]]
            wall = done[0]["ts"] - submit["ts"]
            gaps.append(abs(sum(e["dur"] for e in spans) - wall) / 1e6)
            residencies += 1
    check(residencies > 0 and max(gaps) < SV_TILE_S,
          f"trace: {residencies} residencies, worst |spans - wall| {max(gaps, default=0):.4f} s")
    return {"residencies": residencies, "worst_gap_s": max(gaps)}


def sv_baseline(config: Path, requests: list[dict], flags: list[str]) -> dict:
    """Leg b's uninterrupted `serve --config` of `requests`."""
    import subprocess

    stdin = SV_DIR / "b-requests.jsonl"
    stdin.write_text("".join(json.dumps(r) + "\n" for r in requests))
    t0 = time.perf_counter()
    with open(stdin) as source, open(SV_DIR / "b-base.out", "w") as sink, \
            open(SV_DIR / "b-base.log", "w") as log:
        rc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, "serve", "--config", str(config),
                             *flags], cwd=ROOT, stdin=source, stdout=sink, stderr=log,
                            env={**os.environ, "SMOKE_SERVE_OUT": str(SV_DIR / "b-base")},
                            timeout=SV_TIMEOUT_S).returncode
    seconds = time.perf_counter() - t0
    done = sv_done([json.loads(line) for line in (SV_DIR / "b-base.out").read_text().splitlines()
                    if line.startswith("{")])
    check(rc == 0 and len(done) == len(requests) and all(
        v[0]["stop_reason"] == "max_tokens" for v in done.values()),
        f"serve b: the baseline exited {rc} with {len(done)} terminals: "
        f"{(SV_DIR / 'b-base.log').read_text()[-3000:]}")
    (child,) = sv_summaries(str(SV_DIR / "b-base"))
    check(child["launches"] > 0 and child["plain_decode_calls"] == 0,
          f"serve b: baseline K4 {child['launches']}, plain decode {child['plain_decode_calls']}")
    return {"seconds": seconds, "tokens": {k: v[0]["tokens"] for k, v in done.items()},
            "launches": child["launches"]}


def sv_supervised(card: str, config: Path, requests: list[dict], flags: list[str],
                  baseline: dict) -> dict:
    """Leg b's `supervise --child serve` with a chaos SIGTERM at engine step
    SV_SIGTERM_STEP and a profile line once the first token is out."""
    t0 = time.perf_counter()
    stream = Stream(
        [sys.executable, "-c", _SUPERVISE_DRIVER, "supervise", "--config", str(config),
         "--child", "serve", "--backoff-base-s", "0",
         "--child-args", " ".join([*flags, "--drain-timeout-s", str(SV_DRAIN_S)])],
        {"LLMT_CHAOS_SERVE_SIGTERM_STEP": str(SV_SIGTERM_STEP),
         "SMOKE_SERVE_OUT": str(SV_DIR / "b-sup")}, SV_DIR / "b-sup.log")
    try:
        stream.send(requests)
        stream.until(lambda r: any(x.get("type") == "token" for x in r))
        stream.send([{"type": "profile", "tag": "smoke"}])
        rc = stream.finish()
    finally:
        stream.kill()
    sup_s = time.perf_counter() - t0
    text = (SV_DIR / "b-sup.log").read_text()
    children = sv_summaries(str(SV_DIR / "b-sup"))
    run_dir = SV_DIR / "b" / "run" / "sup"
    events = [json.loads(line) for line in (run_dir / "supervisor.jsonl").read_text().splitlines()]
    exits = [e.get("rc") for e in events if e.get("event") == "exit"]
    check(rc == 0 and exits == [75, 0] and len(children) == 2,
          f"serve b: supervise exited {rc}, children {exits} ({len(children)} summaries): "
          f"{text[-3000:]}")
    first, second = children
    done = sv_done(stream.records)
    streams = sv_streams(stream.records)
    answers = [r for r in stream.records if r.get("type") == "profile"]
    check(all(len(done.get(r["id"], [])) == 1 for r in requests) and len(done) == len(requests),
          f"serve b: terminals {sorted((k, len(v)) for k, v in done.items())}")
    want = baseline["tokens"]
    mismatched = [r["id"] for r in requests if streams.get(r["id"]) != want[r["id"]]
                  or done[r["id"]][0]["tokens"] != want[r["id"]]]
    check(not mismatched, f"serve b: streams differ from the uninterrupted run for {mismatched}")
    journaled = first.get("drain", {}).get("journaled", 0)
    check(journaled > 0 and second["replayed"] == journaled and "t_sigterm" in first,
          f"serve b: journaled {journaled}, replayed {second['replayed']}")
    for name, child in (("first", first), ("relaunch", second)):
        check(child["launches"] > 0 and child["plain_decode_calls"] == 0,
              f"serve b: {name} K4 {child['launches']}, plain decode {child['plain_decode_calls']}")
    # the profile line: a torch.profiler trace with CUDA kernel events
    trace_file = run_dir / "profile-smoke" / "trace.json"
    kernels = 0
    if trace_file.exists():
        kernels = sum(e.get("cat") == "kernel"
                      for e in json.loads(trace_file.read_text()).get("traceEvents", []))
    check(answers and answers[0].get("accepted") and kernels > 0
          and (run_dir / "profile-smoke.json").exists()
          and first["profile"].get("profile/errors", 0) == 0
          and first["profile"].get("profile/captures") == 1,
          f"serve b: profile answer {answers}, {kernels} kernel events, counters {first['profile']}")
    return dict(
        supervised_s=sup_s, sigterm_to_exit_s=first["t_exit"] - first["t_sigterm"],
        relaunch_to_replayed_s=second["t_replayed"] - second["t_start"],
        journaled=journaled, replayed=second["replayed"],
        launches=[baseline["launches"], first["launches"], second["launches"]],
        profile_kernel_events=kernels, tiling=sv_tiling(run_dir),
        base_tiling=sv_tiling(SV_DIR / "b" / "run" / "base"),
        engine_steps_first=first["engine_steps"],
    )


def sv_legs_bc(card: str) -> tuple[dict, dict]:
    """Legs b and c (see the header). This process fits c's checkpoint,
    then b's; leg c runs on its checkpoint while b's fit and uninterrupted
    run go on beside it; b's supervised run, whose seconds are the
    readings, runs alone."""
    from llm_training_tpu_torch.models.llama.config import preset

    base_cfg = sv_config("b", SV_B_LAYERS, "float32", "base")
    sup_cfg = sv_config("b", SV_B_LAYERS, "float32", "sup")
    c_cfg = sv_config("c", SV_C_LAYERS, "bfloat16", "sup")
    c_fit_s = sv_fit(c_cfg)
    leg_c = LegThread(sv_leg_c, card, c_cfg)
    fit_s = sv_fit(base_cfg)
    ckpt_bytes = sum(f.stat().st_size for f in (SV_DIR / "b" / "ckpt").rglob("*") if f.is_file())
    requests = sv_requests(1, SV_B_REQUESTS, SV_B_NEW, preset(SV_PRESET).vocab_size, "b")
    flags = sv_serve_flags("--max-new-tokens", str(SV_B_NEW))
    baseline = sv_baseline(base_cfg, requests, flags)
    c = leg_c.result(SV_TIMEOUT_S)
    b = dict(fit_s=fit_s, c_fit_s=c_fit_s, checkpoint_bytes=ckpt_bytes,
             baseline_s=baseline["seconds"],
             **sv_supervised(card, sup_cfg, requests, flags, baseline))
    tiling, base_tiling = b["tiling"], b["base_tiling"]
    print(f"serve resilience b [{card}]: {SV_PRESET} x {SV_B_LAYERS} layers in fp32 "
          f"(a {ckpt_bytes / 1e9:.2f} GB checkpoint; its fit {fit_s:.1f} s), {SV_B_REQUESTS} "
          f"requests of {SV_B_NEW} new tokens: the uninterrupted run {b['baseline_s']:.1f} s "
          f"(leg c beside it); supervise --child serve with SIGTERM at engine step "
          f"{SV_SIGTERM_STEP}: exit 75 {b['sigterm_to_exit_s']:.2f} s after the SIGTERM "
          f"({SV_DRAIN_S:.1f} s drain), {b['journaled']} journaled, the relaunch replayed "
          f"{b['replayed']} {b['relaunch_to_replayed_s']:.2f} s after its start; every stream "
          f"token for token equal, one terminal each ({b['supervised_s']:.1f} s in all); K4 "
          f"{b['launches']} launches (baseline, first, relaunch), plain decode 0; profile: "
          f"{b['profile_kernel_events']} CUDA kernel events, profile/errors 0; trace: "
          f"{tiling['residencies']} residencies tiled within {tiling['worst_gap_s'] * 1e3:.3f} "
          f"ms (baseline {base_tiling['worst_gap_s'] * 1e3:.3f} ms)", flush=True)
    return b, c


def sv_leg_c(card: str, path: Path) -> dict:
    """The watchdog at 2 layers (see the header)."""
    from llm_training_tpu_torch.models.llama.config import preset
    from llm_training_tpu_torch.telemetry.exporter import find_free_port

    requests = sv_requests(2, SV_C_REQUESTS, SV_C_NEW, preset(SV_PRESET).vocab_size, "c")
    port = find_free_port()
    flags = sv_serve_flags("--max-new-tokens", str(SV_C_NEW), "--watchdog-timeout-s",
                           str(SV_WATCHDOG_S))
    t0 = time.perf_counter()
    stream = Stream(
        [sys.executable, "-c", _SUPERVISE_DRIVER, "supervise", "--config", str(path),
         "--child", "serve", "--backoff-base-s", "0", "--child-args", " ".join(flags)],
        {"LLMT_CHAOS_SERVE_STALL_STEP": str(SV_STALL_STEP), "LLMT_METRICS_PORT": str(port),
         "SMOKE_SERVE_STEP_SUMMARY": "1", "SMOKE_SERVE_OUT": str(SV_DIR / "c-sup")},
        SV_DIR / "c-sup.log")
    try:
        with Scraper(port, 0.25, metrics=False) as scraper:
            stream.send(requests)
            rc = stream.finish()
    finally:
        stream.kill()
    wall = time.perf_counter() - t0
    text = (SV_DIR / "c-sup.log").read_text()
    children = sv_summaries(str(SV_DIR / "c-sup"))
    run_dir = SV_DIR / "c" / "run" / "sup"
    events = [json.loads(line) for line in (run_dir / "supervisor.jsonl").read_text().splitlines()]
    exits = [e.get("rc") for e in events if e.get("event") == "exit"]
    check(rc == 0 and exits == [-6, 0] and len(children) == 2,
          f"serve c: supervise exited {rc}, children {exits}: {text[-3000:]}")
    first, second = children
    t_abort = next(e["ts"] for e in events if e.get("event") == "exit")
    red = [t for t, code in scraper.health if code == 503 and t < t_abort]
    dumps = sorted(p.name for p in run_dir.glob("hang-dump-*.txt"))
    flights = sorted(p.name for p in run_dir.glob("trace-flight-hang-*.jsonl"))
    done = sv_done(stream.records)
    check(red and dumps and flights, f"serve c: 503s before the abort {len(red)}, hang dumps "
          f"{dumps}, flight dumps {flights}")
    check(len(done) == len(requests) and all(
        len(v) == 1 and v[0]["stop_reason"] == "max_tokens" for v in done.values()),
        f"serve c: terminals {sorted((k, [d['stop_reason'] for d in v]) for k, v in done.items())}")
    for name, child in (("first", first), ("relaunch", second)):
        check(child["launches"] > 0 and child["plain_decode_calls"] == 0,
              f"serve c: {name} K4 {child['launches']}, plain decode {child['plain_decode_calls']}")
    out = dict(wall_s=wall, first_503_before_abort_s=t_abort - red[0],
               stall_to_abort_s=t_abort - first["t_exit"],
               hang_dumps=dumps, flight_dumps=flights, replayed=second["replayed"],
               launches=[first["launches"], second["launches"]])
    print(f"serve resilience c [{card}]: {SV_C_LAYERS} layers, bf16, a stall at engine step "
          f"{SV_STALL_STEP} under --watchdog-timeout-s {SV_WATCHDOG_S:.0f}: the abort "
          f"{out['stall_to_abort_s']:.2f} s after the last step, /healthz 503 "
          f"{out['first_503_before_abort_s']:.2f} s before it, {len(dumps)} hang dump, "
          f"{len(flights)} flight dump; supervise relaunched, {second['replayed']} replayed, "
          f"{len(done)}/{len(requests)} finished once; K4 {out['launches']}, plain decode 0 "
          f"({wall:.1f} s)", flush=True)
    return out


def phase_serve_resilience(card: str) -> dict:
    """serve's resilience and live telemetry (see the header)."""
    shutil.rmtree(SV_DIR, ignore_errors=True)
    SV_DIR.mkdir()
    out = {}
    try:
        t0 = time.perf_counter()
        out["a"] = sv_leg_a(card)
        out["a"]["leg_s"] = time.perf_counter() - t0
        out["b"], out["c"] = sv_legs_bc(card)
        out["b"]["legs_bc_s"] = time.perf_counter() - t0 - out["a"]["leg_s"]
    finally:
        shutil.rmtree(SV_DIR, ignore_errors=True)
        release()
    return out


# ------------------------------------------------------- phase 19: HF I/O + Phi-3

HF_DIR = ROOT / ".smoke_hf"
HF_DEVICE = "cuda"
# the config.json of huggingface.co/microsoft/Phi-3-mini-4k-instruct
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                 max_position_embeddings=4096, original_max_position_embeddings=4096,
                 sliding_window=2047, rms_norm_eps=1e-5, rope_theta=10000.0,
                 bos_token_id=1, eos_token_id=32000, pad_token_id=32000,
                 tie_word_embeddings=False)
HF_SERVE = dict(max_batch=8, max_model_len=4096, block_size=16, prefill_chunk=512)
HF_REQUESTS = 16
HF_PROMPTS = (1024, 3072)  # prompt lengths, inclusive: most rows decode past the window
HF_NEW = 128
HF_DPO_LAYERS = 8
HF_DPO_STEPS = 3
# the optimizer of config/examples/phi-3/phi-3-mini_dpo.yaml: AdamW (the
# default), 5e-7, linear with 50 warm-up steps, clip 1.0 (the default)
HF_DPO_OPTIM = {"optimizer": "adamw", "learning_rate": 5e-7, "lr_scheduler": "linear",
                "warmup_steps": 50}


def hf_probes() -> tuple[str, ...]:
    """Tensors the DPO leg's loaded policy is held to: the embeddings, the
    head and its last layer's."""
    last = f"model.layers.{HF_DPO_LAYERS - 1}."
    return ("model.embed_tokens.weight", last + "self_attn.q_proj.weight",
            last + "mlp.down_proj.weight", "lm_head.weight")


@contextlib.contextmanager
def count_plain_decode():
    """Count single-token calls of the paged gather path (the plain decode
    path, which the serving engine must never take on the card)."""
    from llm_training_tpu_torch.ops import paged_attention as ops_pa

    real = ops_pa._gather_attention
    calls = [0]

    def counted(q, *args, **kwargs):
        calls[0] += q.shape[1] == 1
        return real(q, *args, **kwargs)

    ops_pa._gather_attention = counted
    try:
        yield calls
    finally:
        ops_pa._gather_attention = real


def hf_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.glob("*.safetensors"))


def hf_load(path: Path, **overrides):
    """An `HFCausalLM` model built and loaded on the card through the
    objective's own loader; (model, seconds)."""
    from llm_training_tpu_torch.lms.base import (
        BaseLMConfig,
        ModelProvider,
        build_model,
        init_model,
        resolve_pretrained_source,
    )

    t0 = time.perf_counter()
    model = build_model(ModelProvider("HFCausalLM", {"hf_path": str(path), **overrides}),
                        torch.device(HF_DEVICE), "phase 19")
    lm = BaseLMConfig()
    init_model(model, lm, resolve_pretrained_source(lm, model.config), torch.Generator())
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def hf_export(card: str):
    """a) Phi-3-mini at its published widths, random bf16 weights from seed
    0, written by `save_hf_checkpoint`: two shards and an index."""
    from llm_training_tpu_torch.models.hf_io import save_hf_checkpoint
    from llm_training_tpu_torch.models.phi3 import Phi3, Phi3Config

    config = Phi3Config(**PHI3_MINI, param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Phi3(config, device=HF_DEVICE)
    model.init_weights(torch.Generator(device=HF_DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    path = save_hf_checkpoint(model.state_dict(), config, HF_DIR / "phi-3-mini",
                              dtype="bfloat16")
    seconds = time.perf_counter() - t0
    shards = sorted(p.name for p in path.glob("*.safetensors"))
    check(shards == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
          and (path / "model.safetensors.index.json").exists()
          and json.loads((path / "config.json").read_text())["model_type"] == "phi3",
          f"hf export: files {sorted(p.name for p in path.iterdir())}")
    nbytes = hf_bytes(path)
    out = dict(params=n_params, bytes=nbytes, seconds=seconds, gb_per_s=nbytes / seconds / 1e9)
    print(f"hf export [{card}]: phi-3-mini, {n_params} params in bf16, {nbytes} bytes in "
          f"{len(shards)} shards in {seconds:.2f} s ({out['gb_per_s']:.2f} GB/s)", flush=True)
    return model, path, out


def hf_reload(card: str, exported, path: Path):
    """b) `HFCausalLM` over the export at full depth, loaded on the card:
    every tensor equal to the exported model's. (model, host copies of a
    few exported tensors, the load's numbers)."""
    from llm_training_tpu_torch.models.phi3 import Phi3

    model, load_s = hf_load(path, param_dtype="bfloat16", compute_dtype="bfloat16")
    nbytes = hf_bytes(path)
    check(isinstance(model, Phi3) and model.config.sliding_window == 2047
          and model.config.num_hidden_layers == PHI3_MINI["num_hidden_layers"],
          f"hf load: {type(model).__name__} "
          f"{model.config}")
    mine, theirs = model.state_dict(), exported.state_dict()
    differ = [n for n, t in theirs.items() if not torch.equal(t, mine[n])]
    check(not differ, f"hf load: {len(differ)} tensors differ from the export: {differ[:4]}")
    probes = {n: theirs[n].detach().to("cpu", copy=True) for n in hf_probes()}
    print(f"hf load [{card}]: HFCausalLM -> Phi3, {nbytes} bytes to the card in {load_s:.2f} s "
          f"({nbytes / load_s / 1e9:.2f} GB/s), every tensor equal to the export", flush=True)
    return model.eval(), probes, dict(load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9)


def hf_serve(card: str, model) -> dict:
    """b) The serving engine answers 16 requests on the loaded model through
    K4 at head_dim 96 with the 2047-token window, the plain decode path
    never."""
    from llm_training_tpu_torch.ops.kernels import paged_attention as kernels
    from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, ServeConfig(**HF_SERVE), device=HF_DEVICE)
    decode_ms, prefill_ms = [], []

    def timed(fn, sink):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(*args)
            torch.cuda.synchronize()
            sink.append(1e3 * (time.perf_counter() - t))
            return result
        return run

    engine._run_decode = timed(engine._run_decode, decode_ms)
    engine._run_prefill = timed(engine._run_prefill, prefill_ms)
    rng = np.random.default_rng(19)
    lens = rng.integers(HF_PROMPTS[0], HF_PROMPTS[1] + 1, size=HF_REQUESTS)
    requests = [{"id": f"h{i}", "prompt": rng.integers(0, PHI3_MINI["vocab_size"], n).tolist(),
                 "max_new_tokens": HF_NEW} for i, n in enumerate(lens)]
    events: list[dict] = []
    with count_plain_decode() as plain:
        kernels.paged_decode_attention.launches = 0
        t_run = time.perf_counter()
        for request in requests:
            events.extend(engine.submit(**request))
        while not engine.scheduler.idle:
            events.extend(engine.step())
            check(engine.step_index < 20_000, "hf serve: the loop did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.paged_decode_attention.launches
    done = {e["id"]: e for e in events if e["type"] == "done"}
    stats = engine.stats()
    layers = PHI3_MINI["num_hidden_layers"]
    check(len(done) == HF_REQUESTS and all(
        e["stop_reason"] == "max_tokens" and e["n_tokens"] == HF_NEW for e in done.values()),
        f"hf serve: not every request completed: {[(k, v['stop_reason']) for k, v in done.items()]}")
    check(engine.allocator.blocks_in_use == 0 and engine.logits_finite,
          "hf serve: pool blocks leaked or logits not finite")
    check(launches == layers * engine.decode_steps and launches > 0 and plain[0] == 0,
          f"hf serve: {launches} K4 launches for {engine.decode_steps} decode steps x {layers} "
          f"layers; {plain[0]} plain decode calls")
    past = int(sum(n + HF_NEW > PHI3_MINI["sliding_window"] for n in lens))
    out = dict(
        launches=launches,
        decode_steps=engine.decode_steps, launches_per_step=launches / engine.decode_steps,
        plain_decode_calls=plain[0], prefill_chunks=engine.prefill_chunks,
        rows_past_window=past, wall_s=wall,
        tokens_per_s=stats["serve/tokens_generated"] / wall,
        decode_step_ms_p50=percentile(decode_ms, 50),
        prefill_chunk_ms_p50=percentile(prefill_ms, 50),
        ttft_ms_p50=stats["serve/ttft_p50_ms"], tpot_ms_p50=stats["serve/tpot_p50_ms"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print(f"hf serve [{card}]: phi-3-mini full depth, {len(done)}/{HF_REQUESTS} requests of "
          f"{HF_PROMPTS[0]}-"
          f"{HF_PROMPTS[1]} + {HF_NEW} tokens ({past} decode past the 2047 window); "
          f"{engine.decode_steps} decode steps, {launches} K4 launches "
          f"({out['launches_per_step']:.0f} a step), {plain[0]} plain decode calls; decode step "
          f"p50 {out['decode_step_ms_p50']:.3f} ms, prefill chunk (512) p50 "
          f"{out['prefill_chunk_ms_p50']:.3f} ms, {out['tokens_per_s']:.1f} tokens/s over "
          f"{wall:.2f} s, TTFT p50 {out['ttft_ms_p50']:.1f} ms, TPOT p50 "
          f"{out['tpot_ms_p50']:.3f} ms, peak memory {out['peak_memory_gb']:.2f} GB", flush=True)
    out.update(profile_decode(engine, card, rng))
    del engine
    return out


def hf_dpo(card: str, path: Path, probes: dict) -> dict:
    """c) DPO at 8 layers from the same directory (`num_hidden_layers` an
    `HFCausalLM` override): policy and reference both loaded, the example's
    AdamW, 3 steps of 8 synthetic pairs up to 2048 tokens, through K1-K3."""
    from llm_training_tpu_torch.cli.config import instantiate_from_config
    from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa
    from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

    batches = preference_batches(19, HF_DPO_STEPS, PHI3_MINI["vocab_size"])

    class Batches(BaseDataModule):
        def setup(self):
            pass

        def train_batches(self, start_step=0):
            yield from batches[start_step:]

    class Watch:
        """Step clock, host metrics, and at fit start the loaded weights."""

        def __init__(self):
            self.step_s, self.metrics, self.t, self.loaded = [], [], None, {}

        def on_fit_start(self, trainer, *args):
            pair = trainer.state.model
            self.loaded = dict(
                ref_equals_policy=all(torch.equal(p, r) for p, r in zip(
                    pair.policy.parameters(), pair.ref.parameters())),
                probes_equal=all(torch.equal(
                    pair.policy.state_dict()[n].cpu(), t.float()) for n, t in probes.items()),
                loaded_layers=len(pair.policy.model.layers))
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_train_step(self, trainer, step):
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.step_s.append(now - self.t)
            self.t = now

        def on_step_end(self, trainer, step, metrics):
            self.metrics.append(metrics)

    objective = instantiate_from_config({"class_path": "llm_training_tpu.lms.DPO", "init_args": {
        "model": {"model_class": "HFCausalLM", "model_kwargs": {
            "hf_path": str(path), "num_hidden_layers": HF_DPO_LAYERS, "param_dtype": "float32",
            "compute_dtype": "bfloat16", "enable_gradient_checkpointing": True,
            "recompute_granularity": "selective"}},
        "beta": PREF_BETA, "label_smoothing": 0.0, "logps_chunk_size": 128,
        "optim": HF_DPO_OPTIM}})
    watch = Watch()
    trainer = Trainer(TrainerConfig(max_steps=HF_DPO_STEPS, seed=0, log_every_n_steps=1),
                      callbacks=[watch], device=HF_DEVICE)
    launchers = (fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_plain_attention() as plain:
        for launcher in launchers:
            launcher.launches = 0
        state = trainer.fit(objective, Batches(BaseDataModuleConfig()))
        torch.cuda.synchronize()
        launches = [launcher.launches for launcher in launchers]
    fit_s = time.perf_counter() - t0
    losses = [m["loss"] for m in watch.metrics]
    policy = state.model.policy
    n_matmul = sum(p.numel() for p in policy.parameters()) - policy.model.embed_tokens.weight.numel()
    head_dim, hq = 96, PHI3_MINI["num_attention_heads"]
    per_token = 8 * n_matmul  # 6 N a policy token, 2 N a reference token
    per_pair = 16 * head_dim * hq * HF_DPO_LAYERS  # 12 D policy, 4 D reference
    flops, tokens = [], []
    for batch in batches:
        n, f = 0, 0
        for side in ("chosen", "rejected"):
            seg = torch.as_tensor(batch[f"{side}_segment_ids"], device=HF_DEVICE)
            side_tokens = int((batch[f"{side}_segment_ids"] > 0).sum())
            n += side_tokens
            f += per_token * side_tokens + per_pair * bench_flash.visible_pairs(
                seg, seg, window=PHI3_MINI["sliding_window"])
        tokens.append(n)
        flops.append(f)
    timed_s = watch.step_s[1:]
    expected = [4 * HF_DPO_LAYERS * HF_DPO_STEPS] + [2 * HF_DPO_LAYERS * HF_DPO_STEPS] * 2
    out = dict(layers=HF_DPO_LAYERS, steps=HF_DPO_STEPS, losses=losses, fit_s=fit_s,
               widths=[b["chosen_input_ids"].shape[1] for b in batches], tokens=tokens,
               launches=dict(zip(("fwd", "dq", "dkv"), launches)), plain_calls=plain[0],
               step_ms_p50=1e3 * percentile(timed_s, 50),
               step_ms=[1e3 * t for t in watch.step_s],
               mfu=sum(flops[1:]) / sum(timed_s) / bench_flash.BF16_FLOPS_PER_S,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **watch.loaded)
    print(f"hf dpo [{card}]: phi-3-mini x {HF_DPO_LAYERS} layers from the export (policy and "
          f"reference loaded: reference == policy {watch.loaded['ref_equals_policy']}, probes "
          f"equal {watch.loaded['probes_equal']}), {HF_DPO_STEPS} steps of {PREF_PAIRS} pairs "
          f"(widths {out['widths']}); losses " + ", ".join(f"{x:.6f}" for x in losses)
          + f"; K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}, plain path {plain[0]}; step "
          f"p50 {out['step_ms_p50']:.1f} ms, MFU {100 * out['mfu']:.2f}% of 989 TFLOPS (8N a "
          f"token, 16 D a visible pair a head a layer at D 96), peak memory "
          f"{out['peak_memory_gb']:.2f} GB", flush=True)
    check(watch.loaded == dict(ref_equals_policy=True, probes_equal=True,
                              loaded_layers=HF_DPO_LAYERS),
          f"hf dpo: loaded weights {watch.loaded}")
    check(len(losses) == HF_DPO_STEPS and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(2)) <= LN2_RTOL * math.log(2),
          f"hf dpo: losses {losses} (step 1 must be ln 2 = {math.log(2)})")
    check(launches == expected and plain[0] == 0,
          f"hf dpo: K1/K2/K3 launched {launches}, expected {expected}; plain path {plain[0]}")
    del objective, state, trainer, policy
    release()
    return out


def hf_kernel_timing(card: str) -> dict:
    """The kernels at this slice's shapes, held against their plain versions
    there and timed beside their bounds: K4 at Phi-3-mini's serving shape
    (B 8, Hkv 32, D 96, group 1, window 2047, rows past it, bf16), K1-K3 at
    its DPO shape (B 8, S 2048, Hq = Hkv = 32, D 96 padded to 128 by the
    wrapper, window 2047): the bound counts D 96."""
    from llm_training_tpu_torch.ops.kernels import bench_flash
    from llm_training_tpu_torch.ops.kernels import bench_paged_decode as bench
    from llm_training_tpu_torch.ops.kernels import paged_attention as kernels

    window = PHI3_MINI["sliding_window"]
    rng = np.random.default_rng(20)
    lengths = rng.integers(2048, 3073, size=8).tolist()
    cases = [bench.phi3_decode_case(lengths, seed) for seed in range(2)]
    cases += [bench.phi3_decode_case(lengths, s) for s in range(2, bench.cold_copies(cases[0]))]
    err = kernel_vs_plain(kernels, cases[0], sliding_window=window)
    as_fp32 = {k: (v.float() if v.is_floating_point() else v) for k, v in cases[0].items()}
    err32 = kernel_vs_plain(kernels, as_fp32, sliding_window=window)
    check(err.pop("ok") and err32.pop("ok"),
          f"phi-3 decode shape: kernel vs plain errors bf16 {err}, fp32 {err32}")
    k4_ms = bench.device_ms([(lambda c=c: kernels.paged_decode_attention(
        **c, sliding_window=window)) for c in cases])
    plain_ms = bench.device_ms([(lambda c=c: kernels.paged_decode_attention_torch(
        **c, sliding_window=window)) for c in cases])
    bound_ms, bound_by = bench.decode_bound_ms(cases[0], window)
    out = {"k4": dict(ms=k4_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=None, max_abs_err=err["abs"])}
    print(f"kernel timing [{card}]: paged_decode phi-3 B8 Hq32 Hkv32 D96 page16 window {window} "
          f"lengths {min(lengths)}-{max(lengths)} bf16, cold L2: kernel {1e3 * k4_ms:.2f} us, "
          f"plain {1e3 * plain_ms:.2f} us, bound {1e3 * bound_ms:.2f} us ({bound_by}), "
          f"{100 * bound_ms / k4_ms:.1f}% of bound; parity bf16 row {err['row_rel']:.3e}, vs "
          f"fp32 {err['vs_fp32']:.3f} of the limit, fp32 abs {err32['abs']:.3e}", flush=True)
    del cases
    release()
    cases = bench_flash.dpo_case()
    case = cases[0]
    got = bench_flash.run_case(case, kernel=True, causal=True, sliding_window=window)
    ref = bench_flash.run_plain_by_kv_head(case, causal=True, sliding_window=window)
    ref32 = bench_flash.run_plain_by_kv_head(case, upcast=True, causal=True,
                                             sliding_window=window)
    torch.cuda.synchronize()
    errors, broken = flash_case_errors(got, ref, ref32, case, None)
    check(not broken, f"phi-3 DPO shape: flash kernels vs plain: {broken}")
    abs_err = {
        "fwd": float((got["out"].float() - ref["out"].float()).abs().max()),
        "dq": float((got["dq"].float() - ref["dq"].float()).abs().max()),
        "dkv": max(float((got[n].float() - ref[n].float()).abs().max()) for n in ("dk", "dv")),
    }
    del got, ref, ref32
    record = bench_flash.kernel_record(cases=cases, window=window)
    plain = bench_flash.time_plain(cases, window=window)
    library = bench_flash.time_sdpa(cases, window=window)
    for kind in ("fwd", "dq", "dkv"):
        side = "fwd_ms" if kind == "fwd" else "bwd_ms"
        out[kind] = dict(ms=record[f"{kind}_ms"], plain_ms=plain[side], library_ms=library[side],
                         bound_ms=record[f"{kind}_bound_ms"], bound_by=record[f"{kind}_bound_by"],
                         max_abs_err=abs_err[kind])
    print(f"flash timing [{card}]: phi-3 DPO B8 S2048 Hq32 Hkv32 D96 (padded to 128) window "
          f"{window} bf16 ({record['visible_pairs_per_head']} visible pairs a head), cold L2: "
          + "; ".join(f"{kind} {v['ms']:.3f} ms (bound at D 96 {v['bound_ms']:.3f} ms by "
                      f"{v['bound_by']}, {100 * v['bound_ms'] / v['ms']:.1f}%)"
                      for kind, v in out.items() if kind != "k4")
          + f"; plain fwd {plain['fwd_ms']:.3f} ms, bwd {plain['bwd_ms']:.3f} ms; SDPA fwd "
          f"{library['fwd_ms']:.3f} ms, bwd {library['bwd_ms']:.3f} ms; parity bf16 "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errors.items())), flush=True)
    del cases, case
    release()
    return out


def hf_round_trip(card: str, ckpt_dir: Path, out_dir: Path) -> dict:
    """d) `convert_to_hf` on a checkpoint phase 16 wrote (the 1-layer
    Llama-3.1-8B-width model under SGD), the export reloaded through
    `HFCausalLM` on the card: every tensor and the logits on one batch
    equal those of the restored model with its parameters rounded to bf16."""
    from llm_training_tpu_torch.convert_to_hf import convert_checkpoint, load_checkpoint
    from llm_training_tpu_torch.models.llama.model import Llama

    release()
    t0 = time.perf_counter()
    convert_checkpoint(ckpt_dir, out_dir, dtype="bfloat16")
    convert_s = time.perf_counter() - t0
    nbytes = hf_bytes(out_dir)
    meta_model, params, _ = load_checkpoint(ckpt_dir, None)
    config = dataclasses.replace(meta_model.config, param_dtype="bfloat16")
    restored = Llama(config, device=HF_DEVICE)
    restored.load_state_dict({k: v.to(torch.bfloat16) for k, v in params.items()})
    del params
    reloaded, reload_s = hf_load(out_dir, param_dtype="bfloat16",
                                 compute_dtype=config.compute_dtype)
    mine = reloaded.state_dict()
    differ = [n for n, t in restored.state_dict().items() if not torch.equal(t, mine[n])]
    check(not differ, f"hf round trip: {len(differ)} tensors differ: {differ[:4]}")
    ids = torch.randint(0, config.vocab_size, (2, 1024), device=HF_DEVICE,
                        generator=torch.Generator(device=HF_DEVICE).manual_seed(21))
    with torch.no_grad():
        a = restored.eval()(ids).logits
        b = reloaded.eval()(ids).logits
    torch.cuda.synchronize()
    equal = torch.equal(a, b)
    diff = float((a.float() - b.float()).abs().max())
    scale = float(a.float().abs().max())
    out = dict(bytes=nbytes, convert_s=convert_s, convert_gb_per_s=nbytes / convert_s / 1e9,
               reload_s=reload_s, reload_gb_per_s=nbytes / reload_s / 1e9,
               logits_bit_equal=equal, logits_max_abs_diff=diff)
    print(f"hf round trip [{card}]: convert_to_hf of {ckpt_dir.name}'s newest step "
          f"({nbytes} bytes of bf16 safetensors) in {convert_s:.2f} s "
          f"({out['convert_gb_per_s']:.2f} GB/s written), reloaded through HFCausalLM in "
          f"{reload_s:.2f} s; every tensor equal; logits on 2 x 1024 tokens "
          + ("bit-equal" if equal else f"differ by at most {diff:.3e} (max |logit| {scale:.3f}): "
             "the same bf16 weights and inputs through the same kernels, so a difference "
             "comes from a nondeterministic library product"), flush=True)
    check(equal or diff <= ENGINE_LOGITS_RTOL * scale,
          f"hf round trip: logits differ by {diff} (> {ENGINE_LOGITS_RTOL} x {scale})")
    shutil.rmtree(out_dir)
    del restored, reloaded, a, b
    release()
    return out


def phase_hf_phi3(card: str) -> dict:
    """HF I/O and Phi-3-mini (see the header): export, load and serve at full
    depth, DPO at 8 layers from the same directory, the kernels at this
    slice's shapes."""
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    shutil.rmtree(HF_DIR, ignore_errors=True)
    HF_DIR.mkdir()
    out = {}
    try:
        t0 = time.perf_counter()
        exported, path, out["export"] = hf_export(card)
        model, probes, out["load"] = hf_reload(card, exported, path)
        del exported
        release()
        out["serve"] = hf_serve(card, model)
        del model
        release()
        out["serve"]["leg_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dpo"] = hf_dpo(card, path, probes)
        out["dpo"]["leg_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(HF_DIR, ignore_errors=True)
        release()
    t0 = time.perf_counter()
    out["kernels"] = hf_kernel_timing(card)
    out["kernels"]["leg_s"] = time.perf_counter() - t0
    return out


def timed(name: str, phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
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

    t_start = time.perf_counter()
    timed("2 build", phase_build)
    timed("3 kernel parity", phase_kernel_parity, kernels)
    timed("4 flash parity", phase_flash_parity)
    serve = timed("5 serving", phase_serve, kernels, card)
    gc.collect()  # the engine's timing wrappers form a reference cycle
    torch.cuda.empty_cache()
    timed("6 engine parity", phase_engine_parity, kernels)
    torch.cuda.empty_cache()
    timing = timed("7 K4 timing", phase_timing, kernels, card)
    train = timed("8 training", phase_train, card)
    lifecycle = timed("12 lifecycle", phase_lifecycle, card)
    preference = timed("13 preference", phase_preference, card)
    optimizer = timed("14 optimizer", phase_optimizer, card)
    resilience = timed("15 resilience", phase_resilience, card)
    durability = timed("16 durability", phase_durability, card, hf_round_trip)
    rl = timed("17 rl-fit", phase_rl, card)
    serving = timed("18 serve resilience", phase_serve_resilience, card)
    hf = timed("19 hf + phi3", phase_hf_phi3, card)
    hf["round_trip"] = durability.pop("hf_round_trip")
    timed("9 train-step parity", phase_train_parity)
    flash = timed("10 flash timing", phase_flash_timing, card)
    timed("11 random streams", phase_random_streams, card)
    print(f"phases: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"serve summary [{card}]: " + json.dumps(serve))
    print(f"train summary [{card}]: " + json.dumps(train))
    print(f"lifecycle summary [{card}]: " + json.dumps(lifecycle))
    print(f"preference summary [{card}]: " + json.dumps(preference))
    print(f"optimizer summary [{card}]: " + json.dumps(optimizer))
    print(f"resilience summary [{card}]: " + json.dumps(resilience))
    print(f"durability summary [{card}]: " + json.dumps(durability))
    print(f"rl summary [{card}]: " + json.dumps(rl))
    print(f"serve resilience summary [{card}]: " + json.dumps(serving))
    print(f"hf + phi3 summary [{card}]: " + json.dumps(hf))
    print("phase 18 K4 launches: " + json.dumps({
        "a": {name: serving["a"][name]["launches"] for name in ("plain", "shed")},
        "b": serving["b"]["launches"], "c": serving["c"]["launches"]}))

    def kernel_rows(k4: dict, k4_launches: int, flash_by_kind: dict, launches: dict) -> list:
        rows = [{"name": "paged_decode_attention", "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": KERNEL_REPLACES, "launches": k4_launches,
                 **{key: k4[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")}, "library_ms": None}]
        for (name, source, replaces), kind in zip(FLASH_KERNELS, ("fwd", "dq", "dkv")):
            rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": launches[kind], **flash_by_kind[kind]})
        return rows

    # the earlier slices' shapes (Llama-3.1-8B: phases 7 and 10) with phase
    # 17a's launches (its rl-fit runs all four kernels)
    print("kernels at Llama-3.1-8B shapes (launches: phase 17a): " + json.dumps(kernel_rows(
        timing, rl["a"]["launches"]["decode"], flash, rl["a"]["launches"])))
    # this slice's path: phase 19's serving (K4) and DPO (K1-K3) at Phi-3-mini's
    # shapes, timed there
    print(json.dumps({"kernels": kernel_rows(
        hf["kernels"]["k4"], hf["serve"]["launches"], hf["kernels"], hf["dpo"]["launches"])}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
