"""Continuous-batching request scheduler. Pure host logic.

Counterpart of `llm_training_tpu/serve/scheduler.py` (without deadlines,
load shedding and tracing). Per engine step the scheduler decides:

- **admission**: the head of the waiting queue joins when a decode slot is
  free AND the pool has blocks for its whole (re)prefill plus one decode
  block -- all-or-nothing, so a half-admitted request cannot deadlock the
  pool;
- **chunked prefill**: at most ONE fixed-width prompt chunk per step, so a
  long prompt streams in across steps while every decoding row keeps
  producing a token per step;
- **eviction**: when a decode row needs its next block and the pool is
  dry, the lowest-priority running request (ties: youngest) is evicted,
  its blocks freed, and it is requeued at the FRONT with its progress
  folded into the prompt, so on re-admission it re-prefills and continues
  (token-identically under greedy decoding).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class ServeRequest:
    """One generation request plus its scheduler-owned runtime state."""

    id: str
    prompt: list[int]
    max_new_tokens: int
    priority: int = 0  # higher = more important (evicted last)
    arrival_s: float = field(default_factory=time.perf_counter)

    generated: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)  # parallel to generated
    emitted: int = 0  # tokens already streamed (an evict/resume never re-emits)
    slot: int | None = None
    blocks: list[int] = field(default_factory=list)
    prefill_tokens: list[int] = field(default_factory=list)  # this residency's prefill
    prefilled: int = 0  # prefill_tokens positions already written
    cache_len: int = 0  # tokens whose KV is in the pool
    first_token_s: float | None = None
    last_token_s: float | None = None
    evictions: int = 0
    stop_reason: str | None = None

    @property
    def done(self) -> bool:
        return self.stop_reason is not None

    @property
    def decoding(self) -> bool:
        """Prefill complete for this residency: one token per decode step."""
        return (
            self.slot is not None
            and not self.done
            and self.prefilled >= len(self.prefill_tokens)
        )


@dataclass
class SchedulerConfig:
    max_batch: int  # decode slots (the decode step's batch)
    max_model_len: int  # per-request cap: len(prompt) + max_new_tokens
    block_size: int
    prefill_chunk: int  # tokens per prefill chunk


class Scheduler:
    """Owns the waiting queue, the slot map and the block accounting; the
    `ServingEngine` executes what `admit`/`next_prefill`/
    `ensure_decode_blocks` decide."""

    def __init__(self, config: SchedulerConfig, allocator):
        if config.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.config = config
        self.allocator = allocator
        self.waiting: deque[ServeRequest] = deque()
        self.running: dict[int, ServeRequest] = {}  # slot -> request
        self._free_slots = list(range(config.max_batch - 1, -1, -1))
        self.completed: list[ServeRequest] = []
        self.evictions = 0

    def submit(self, request: ServeRequest) -> ServeRequest | None:
        """Queue a request; returns it REJECTED (stop_reason='rejected')
        instead when it is empty or can never fit max_model_len."""
        total = len(request.prompt) + request.max_new_tokens
        if (
            len(request.prompt) == 0
            or request.max_new_tokens < 1
            or total > self.config.max_model_len
        ):
            request.stop_reason = "rejected"
            self.completed.append(request)
            return request
        self.waiting.append(request)
        return None

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    def _blocks_for(self, tokens: int) -> int:
        return math.ceil(tokens / self.config.block_size)

    def admit(self) -> list[ServeRequest]:
        """Admit waiting requests while a slot is free and the pool covers
        each one's (re)prefill + one decode write. A head-of-queue request
        the pool can NEVER hold fails with stop_reason='capacity' instead
        of starving the queue behind it."""
        admitted = []
        while self.waiting and self._free_slots:
            request = self.waiting[0]
            resident = request.prompt + request.generated
            blocks = self.allocator.alloc(self._blocks_for(len(resident) + 1))
            if blocks is None:
                if not self.running and not admitted:
                    self.waiting.popleft()
                    request.stop_reason = "capacity"
                    self.completed.append(request)
                    continue
                break
            self.waiting.popleft()
            request.slot = self._free_slots.pop()
            request.blocks = blocks
            request.prefill_tokens = resident
            request.prefilled = 0
            request.cache_len = 0
            self.running[request.slot] = request
            admitted.append(request)
        return admitted

    def next_prefill(self) -> tuple[ServeRequest, list[int], int] | None:
        """(request, chunk_tokens, chunk_start) for the oldest running
        request with prompt left to prefill, or None."""
        pending = [
            r for r in self.running.values() if r.prefilled < len(r.prefill_tokens)
        ]
        if not pending:
            return None
        request = min(pending, key=lambda r: r.arrival_s)
        start = request.prefilled
        chunk = request.prefill_tokens[start:start + self.config.prefill_chunk]
        return request, chunk, start

    def decode_rows(self) -> list[ServeRequest]:
        return [r for r in self.running.values() if r.decoding]

    def ensure_decode_blocks(self, request: ServeRequest) -> bool:
        """Guarantee the row's next token has a cache slot, evicting under
        block pressure. False when the request itself got evicted."""
        while self._blocks_for(request.cache_len + 1) > len(request.blocks):
            grown = self.allocator.alloc(1)
            if grown is not None:
                request.blocks.extend(grown)
                return True
            victim = min(self.running.values(), key=lambda r: (r.priority, -r.arrival_s))
            self.evict(victim)
            if victim is request:
                return False
        return True

    def evict(self, request: ServeRequest) -> None:
        """Free the request's residency and requeue it at the front with
        its progress folded in; streamed tokens are never re-emitted."""
        self._release(request)
        request.evictions += 1
        self.evictions += 1
        request.prefill_tokens = []
        request.prefilled = 0
        request.cache_len = 0
        self.waiting.appendleft(request)

    def finish(self, request: ServeRequest, stop_reason: str) -> None:
        self._release(request)
        request.stop_reason = stop_reason
        self.completed.append(request)

    def _release(self, request: ServeRequest) -> None:
        del self.running[request.slot]
        self._free_slots.append(request.slot)
        self.allocator.free(request.blocks)
        request.slot = None
        request.blocks = []
