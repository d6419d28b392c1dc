"""Continuous-batching serving engine.

Counterpart of `llm_training_tpu/serve/engine.py` (without the journal,
chaos, tracing, weight reload and device-attribution layers). Two model
calls run against the paged pool, which they update in place:

- a prefill chunk: ONE request's next prompt chunk (batch 1, fixed chunk
  width) written into its own blocks; it samples the first new token when
  the chunk completes the prompt;
- a decode step: one token for EVERY decoding slot (`max_batch` rows)
  through the ragged paged-decode kernel -- each row at its own length.
  Idle slots carry length 0 and table row 0 (the trash block).

The host loop (`step()`) executes what the `Scheduler` decides.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from llm_training_tpu_torch import resolve_device
from llm_training_tpu_torch.infer.sampling import SamplingConfig, sample_tokens_with_logprob
from llm_training_tpu_torch.models.base import PagedDecodeState
from llm_training_tpu_torch.serve.paged_cache import (
    DEFAULT_BLOCK_SIZE,
    BlockAllocator,
    init_paged_pool,
    pool_bytes,
)
from llm_training_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig, ServeRequest


@dataclass
class ServeConfig:
    max_batch: int = 4  # decode slots
    max_model_len: int = 256  # per-request cap: prompt + generation
    block_size: int = DEFAULT_BLOCK_SIZE  # tokens per KV block
    # pool capacity in blocks (excluding the trash block); None sizes for
    # max_batch full-length requests
    num_blocks: int | None = None
    prefill_chunk: int = 32  # tokens per prefill chunk
    cache_dtype: str | None = None
    seed: int = 0
    eos_token_id: int | None = None
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_model_len < 2:
            raise ValueError(f"max_model_len must be >= 2, got {self.max_model_len}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {self.num_blocks}")


class ServingEngine:
    """Drives a model under continuous batching on `device` (default
    `cuda`; raises when CUDA is missing and the CPU was not asked for).
    Traffic goes through `submit()` + `step()`, or `run()` for a closed
    request set."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: ServeConfig | None = None,
        device: torch.device | str | None = None,
    ):
        device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device.type != device.type:
            raise ValueError(f"model lives on {param_device}, engine asked for {device}")
        self.model = model
        self.config = config or ServeConfig()
        self.block_size = self.config.block_size
        self.pages_per_request = math.ceil(self.config.max_model_len / self.block_size)
        num_blocks = self.config.num_blocks
        if num_blocks is None:
            num_blocks = self.config.max_batch * self.pages_per_request
        self._pool_k, self._pool_v = init_paged_pool(
            model.config, num_blocks + 1, self.block_size, param_device,
            cache_dtype=self.config.cache_dtype,
        )
        self.allocator = BlockAllocator(num_blocks + 1)
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_batch=self.config.max_batch,
                max_model_len=self.config.max_model_len,
                block_size=self.block_size,
                prefill_chunk=self.config.prefill_chunk,
            ),
            self.allocator,
        )
        self._generator = torch.Generator(device=param_device)
        self._generator.manual_seed(self.config.seed)
        self._t0: float | None = None
        self.step_index = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_generated = 0
        self.peak_running = 0
        # False once any sampled-from logits row held a non-finite value
        self.logits_finite = True

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self._pool_k.device)

    def _table_row(self, request: ServeRequest) -> np.ndarray:
        row = np.zeros((self.pages_per_request,), np.int32)
        row[: len(request.blocks)] = request.blocks
        return row

    def _sample(self, logits: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """fp32 logits `[rows, vocab]` -> host (tokens, logprobs)."""
        tokens, logprobs = sample_tokens_with_logprob(
            logits, self._generator, self.config.sampling
        )
        self.logits_finite &= bool(torch.isfinite(logits).all())
        return tokens.cpu().numpy(), logprobs.cpu().numpy()

    # -------------------------------------------------------------- intake

    def submit(
        self, id: str, prompt: Sequence[int], max_new_tokens: int = 32, priority: int = 0
    ) -> list[dict]:
        """Queue one request; returns the events submission itself produced
        (a rejection completes synchronously). Every prompt token is coerced
        to int here, so a junk prompt fails at submit, not inside a step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        request = ServeRequest(
            id=str(id), prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), priority=int(priority),
        )
        if self.scheduler.submit(request) is not None:
            return [self._done_event(request)]
        return []

    # ---------------------------------------------------------------- step

    def step(self) -> list[dict]:
        """One scheduler round: admissions, at most one prefill chunk, one
        decode step over every decoding row. Returns the streamed events."""
        events: list[dict] = []
        self.step_index += 1
        before = len(self.scheduler.completed)
        self.scheduler.admit()
        for request in self.scheduler.completed[before:]:
            events.append(self._done_event(request))
        self.peak_running = max(self.peak_running, len(self.scheduler.running))
        plan = self.scheduler.next_prefill()
        if plan is not None:
            events.extend(self._run_prefill(*plan))
        rows = self.scheduler.decode_rows()
        if rows:
            events.extend(self._run_decode(rows))
        return events

    def _emit_token(
        self, request: ServeRequest, token: int, logprob: float, events: list[dict]
    ) -> None:
        now = time.perf_counter()
        request.generated.append(token)
        request.logprobs.append(logprob)
        self.tokens_generated += 1
        if request.first_token_s is None:
            request.first_token_s = now
        request.last_token_s = now
        while request.emitted < len(request.generated):
            events.append({
                "type": "token", "id": request.id,
                "token": request.generated[request.emitted],
                "logprob": request.logprobs[request.emitted],
            })
            request.emitted += 1
        eos = self.config.eos_token_id
        if eos is not None and token == eos:
            self.scheduler.finish(request, "eos")
            events.append(self._done_event(request))
        elif len(request.generated) >= request.max_new_tokens:
            self.scheduler.finish(request, "max_tokens")
            events.append(self._done_event(request))

    @torch.no_grad()
    def _run_prefill(self, request: ServeRequest, chunk: list[int], start: int) -> list[dict]:
        events: list[dict] = []
        width = self.config.prefill_chunk
        ids = np.zeros((1, width), np.int64)
        seg = np.zeros((1, width), np.int32)
        ids[0, : len(chunk)] = chunk
        seg[0, : len(chunk)] = 1
        # padded tail positions are clamped into the rope table's range
        pos = np.minimum(start + np.arange(width), self.config.max_model_len - 1)[None, :]
        state = PagedDecodeState(
            k=self._pool_k, v=self._pool_v,
            block_tables=self._tensor(self._table_row(request)[None, :]),
            lengths=self._tensor(np.asarray([start], np.int32)),
        )
        out = self.model(
            self._tensor(ids), segment_ids=self._tensor(seg),
            position_ids=self._tensor(pos), decode_state=state,
        )
        self.prefill_chunks += 1
        request.prefilled += len(chunk)
        request.cache_len += len(chunk)
        if start + len(chunk) >= len(request.prefill_tokens):
            logits = out.logits[0, len(chunk) - 1].to(torch.float32)
            tokens, logprobs = self._sample(logits[None])
            self._emit_token(request, int(tokens[0]), float(logprobs[0]), events)
        return events

    @torch.no_grad()
    def _run_decode(self, rows: list[ServeRequest]) -> list[dict]:
        events: list[dict] = []
        # grow each row's blocks for this step's write; under pool pressure
        # this evicts lowest-priority requests (possibly out of `rows`)
        survivors = [
            r for r in rows
            if r.slot is not None and self.scheduler.ensure_decode_blocks(r)
        ]
        # a LATER row's eviction can take an EARLIER survivor: its blocks
        # may already belong to the evictor, so it must not decode now
        survivors = [r for r in survivors if r.slot is not None]
        if not survivors:
            return events
        batch = self.config.max_batch
        tokens = np.zeros((batch, 1), np.int64)
        lengths = np.zeros((batch,), np.int32)
        tables = np.zeros((batch, self.pages_per_request), np.int32)
        for request in survivors:
            tokens[request.slot, 0] = request.generated[-1]
            lengths[request.slot] = request.cache_len
            tables[request.slot] = self._table_row(request)
        lengths_t = self._tensor(lengths)
        state = PagedDecodeState(
            k=self._pool_k, v=self._pool_v,
            block_tables=self._tensor(tables), lengths=lengths_t,
        )
        out = self.model(
            self._tensor(tokens), position_ids=lengths_t[:, None].long(),
            decode_state=state,
        )
        self.decode_steps += 1
        host, host_lp = self._sample(out.logits[:, -1].to(torch.float32))
        for request in survivors:
            request.cache_len += 1
            self._emit_token(
                request, int(host[request.slot]), float(host_lp[request.slot]), events
            )
        return events

    def _done_event(self, request: ServeRequest) -> dict:
        event = {
            "type": "done", "id": request.id,
            "stop_reason": request.stop_reason,
            "tokens": list(request.generated),
            "logprobs": list(request.logprobs),
            "n_tokens": len(request.generated),
            "evictions": request.evictions,
        }
        if request.first_token_s is not None:
            event["ttft_ms"] = 1000.0 * (request.first_token_s - request.arrival_s)
        if request.last_token_s is not None and len(request.generated) > 1:
            event["tpot_ms"] = (
                1000.0 * (request.last_token_s - request.first_token_s)
                / (len(request.generated) - 1)
            )
        return event

    # ----------------------------------------------------------------- run

    def run(self, requests: Sequence[dict], max_steps: int = 100_000) -> list[dict]:
        """Submit a closed request set and step until drained. Each dict:
        {'id', 'prompt', 'max_new_tokens'?, 'priority'?}."""
        events: list[dict] = []
        for request in requests:
            events.extend(self.submit(**request))
        for _ in range(max_steps):
            if self.scheduler.idle:
                break
            events.extend(self.step())
        else:
            raise RuntimeError(f"serve loop not drained after {max_steps} steps")
        return events

    # --------------------------------------------------------------- stats

    def stats(self) -> dict[str, float]:
        """Completed / failed requests, tokens, tokens/s and TTFT/TPOT
        percentiles over the requests finished so far (host clock)."""
        completed = [
            r for r in self.scheduler.completed if r.stop_reason in ("eos", "max_tokens")
        ]
        ttft = [
            1000.0 * (r.first_token_s - r.arrival_s)
            for r in completed if r.first_token_s is not None
        ]
        tpot = [
            1000.0 * (r.last_token_s - r.first_token_s) / (len(r.generated) - 1)
            for r in completed
            if r.last_token_s is not None and len(r.generated) > 1
        ]
        wall = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        stats = {
            "serve/requests_completed": float(len(completed)),
            "serve/requests_failed": float(len(self.scheduler.completed) - len(completed)),
            "serve/requests_evicted": float(self.scheduler.evictions),
            "serve/tokens_generated": float(self.tokens_generated),
            "serve/tokens_per_sec": self.tokens_generated / wall if wall > 0 else 0.0,
            "serve/peak_running": float(self.peak_running),
            "serve/engine_steps": float(self.step_index),
            "serve/decode_steps": float(self.decode_steps),
            "serve/prefill_chunks": float(self.prefill_chunks),
            "decode/cache_bytes": float(pool_bytes(self._pool_k, self._pool_v)),
            "decode/cache_blocks_total": float(self.allocator.num_blocks - 1),
            "decode/cache_blocks_in_use": float(self.allocator.blocks_in_use),
            "decode/cache_peak_blocks_in_use": float(self.allocator.peak_in_use),
        }
        for name, values in (("ttft", ttft), ("tpot", tpot)):
            if values:
                stats[f"serve/{name}_p50_ms"] = float(np.percentile(values, 50))
                stats[f"serve/{name}_p99_ms"] = float(np.percentile(values, 99))
        return stats
