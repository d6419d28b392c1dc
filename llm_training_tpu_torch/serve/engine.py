"""Continuous-batching serving engine.

Counterpart of `llm_training_tpu/serve/engine.py` (without JAX's
decode-step cost attribution, which is XLA cost analysis: ROADMAP C.17).
Every step first expires deadlines and re-evaluates load shedding, so a
`deadline` or `overloaded` terminal is never more than one step late. Two
model calls run against the paged pool, which they update
in place:

- a prefill chunk: ONE request's next prompt chunk (batch 1, fixed chunk
  width) written into its own blocks; it samples the first new token when
  the chunk completes the prompt;
- a decode step: one token for EVERY decoding slot (`max_batch` rows)
  through the ragged paged-decode kernel -- each row at its own length.
  Idle slots carry length 0 and table row 0 (the trash block).

Sampling draws under `fold_in(key(seed), call)` with a call counter that
advances on every prefill chunk and every decode step, greedy or not, as
the JAX engine's `_next_rng` does: the same seed gives its tokens. The
counter runs on across weight reloads.

Hot weight reload (`reload_weights`) swaps the model's tensors between
steps: every running request is evicted through the fold-in requeue (its
paged KV was computed under the old weights), the new tensors are bound
(a tensor the engine already holds is kept, so nothing is copied), and
`weights_generation` bumps; every token and done event carries the
generation it was decoded under. An attached `RequestJournal`
(`attach_journal`, `serve/journal.py`) records accepted, progress and done
records, so `drain()`, the SIGTERM path, can evict and journal everything
in flight for a relaunch to `submit_resumed`. The chaos serve faults
(`LLMT_CHAOS_SERVE_*`) hook the top of `step()`.

Tracing (`telemetry/trace.py`): `submit`, `first_token`, `done`, `drain`
and `weights_reload` instants, a `prefill_chunk` span per chunk and an
`engine_step` span per step, beside the scheduler's queue/prefill/decode
spans. `live_stats()` gives the `/metrics` exporter's scrape threads the
queue depth, in-flight rows and rolling TTFT/TPOT percentiles.

The host loop (`step()`) executes what the `Scheduler` decides.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from llm_training_tpu_torch import prng, resolve_device
from llm_training_tpu_torch.infer.sampling import SamplingConfig, sample_tokens_with_logprob
from llm_training_tpu_torch.models.base import PagedDecodeState
from llm_training_tpu_torch.serve.paged_cache import (
    DEFAULT_BLOCK_SIZE,
    BlockAllocator,
    init_paged_pool,
    pool_bytes,
)
from llm_training_tpu_torch.resilience.chaos import get_chaos
from llm_training_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig, ServeRequest
from llm_training_tpu_torch.telemetry.registry import get_registry
from llm_training_tpu_torch.telemetry.trace import get_tracer

logger = logging.getLogger(__name__)

# newest terminals live_stats() scans for its rolling TTFT/TPOT
# percentiles: bounds the per-scrape cost on a long-lived server
_LIVE_WINDOW = 512

# terminals that are the engine shedding load to protect its SLO, not
# request failures: counted as serve/requests_shed, never requests_failed
_SHED_REASONS = ("deadline", "overloaded")


@dataclass
class ServeConfig:
    max_batch: int = 4  # decode slots
    max_model_len: int = 256  # per-request cap: prompt + generation
    block_size: int = DEFAULT_BLOCK_SIZE  # tokens per KV block
    # pool capacity in blocks (excluding the trash block); None sizes for
    # max_batch full-length requests
    num_blocks: int | None = None
    prefill_chunk: int = 32  # tokens per prefill chunk
    # intake bound: queued requests past this end with an honest
    # stop_reason='overloaded' terminal; None = unbounded
    max_queue: int | None = None
    # shed when the queue tail's projected TTFT (EMA service-time estimate)
    # crosses this many ms; None disables
    shed_ttft_ms: float | None = None
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
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.shed_ttft_ms is not None and self.shed_ttft_ms <= 0:
            raise ValueError(f"shed_ttft_ms must be > 0, got {self.shed_ttft_ms}")
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
                max_queue=self.config.max_queue,
                shed_ttft_ms=self.config.shed_ttft_ms,
            ),
            self.allocator,
        )
        self._rng = prng.key(self.config.seed)
        self._call = 0  # model calls so far: the key of call n folds in n
        self._t0: float | None = None
        self.step_index = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_generated = 0
        self.peak_running = 0
        # False once any sampled-from logits row held a non-finite value
        self.logits_finite = True
        # bumped by reload_weights; every event carries the generation its
        # token was decoded under
        self.weights_generation = 0
        # the request journal (attach_journal): a terminal's `done` record is
        # deferred to the next step, once the caller has delivered it
        self.journal = None
        self._journal_every = 1
        self._unretired: list[ServeRequest] = []
        self.replayed_requests = 0
        # terminal counters, bumped in _done_event (every terminal passes
        # there): live_stats reads them, so a scrape never scans the whole
        # completion history. Shed load (deadline/overloaded) is tallied
        # apart from real failures
        self._done_full = 0
        self._done_shed = 0
        self._done_failed = 0

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self._pool_k.device)

    def _table_row(self, request: ServeRequest) -> np.ndarray:
        row = np.zeros((self.pages_per_request,), np.int32)
        row[: len(request.blocks)] = request.blocks
        return row

    def _next_key(self) -> prng.Key:
        self._call += 1
        return prng.fold_in(self._rng, self._call)

    def _sample(self, logits: torch.Tensor, key: prng.Key) -> tuple[np.ndarray, np.ndarray]:
        """fp32 logits `[rows, vocab]` -> host (tokens, logprobs)."""
        tokens, logprobs = sample_tokens_with_logprob(logits, key, self.config.sampling)
        self.logits_finite &= bool(torch.isfinite(logits).all())
        return tokens.cpu().numpy(), logprobs.cpu().numpy()

    # -------------------------------------------------------------- intake

    def submit(
        self, id: str, prompt: Sequence[int], max_new_tokens: int = 32, priority: int = 0,
        deadline_ms: float | None = None,
    ) -> list[dict]:
        """Queue one request; returns the events submission itself produced
        (a rejection completes synchronously). Every prompt token is coerced
        to int here, so a junk prompt fails at submit, not inside a step.
        `deadline_ms` is a latency budget anchored at arrival; a
        non-positive one ends the request with stop_reason='deadline' at
        the next step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        request = ServeRequest(
            id=str(id), prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), priority=int(priority),
        )
        if deadline_ms is not None:
            request.deadline_s = request.arrival_s + float(deadline_ms) / 1000.0
        tracer = get_tracer()
        request.traced = tracer.sample_request()
        tracer.instant(
            "serve", "submit", ts=request.arrival_s, write=request.traced,
            request_id=request.id, prompt_len=len(request.prompt),
            max_new_tokens=request.max_new_tokens, priority=request.priority,
            **({"deadline_ms": float(deadline_ms)} if deadline_ms is not None else {}),
        )
        return self._ingest(request)

    def submit_resumed(self, entry: dict) -> list[dict]:
        """Resubmit one `replay_journal` entry after a relaunch: its journaled
        continuation folds in as an eviction requeue does (a re-prefill of
        prompt + generated under the current weights), its logprobs ride
        along (padded with None where the journal had none), and the
        `emitted` watermark keeps streamed tokens from being sent again. A
        deadline re-anchors at the resumed arrival."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        request = ServeRequest(
            id=str(entry["id"]), prompt=[int(t) for t in entry["prompt"]],
            max_new_tokens=int(entry["max_new_tokens"]), priority=int(entry.get("priority", 0)),
        )
        request.generated = [int(t) for t in entry.get("generated", [])]
        logprobs = [None if lp is None else float(lp)
                    for lp in (entry.get("logprobs") or [])][: len(request.generated)]
        request.logprobs = logprobs + [None] * (len(request.generated) - len(logprobs))
        request.emitted = min(int(entry.get("emitted", 0)), len(request.generated))
        if entry.get("deadline_ms") is not None:
            request.deadline_s = request.arrival_s + float(entry["deadline_ms"]) / 1000.0
        tracer = get_tracer()
        request.traced = tracer.sample_request()
        tracer.instant(
            "serve", "submit", ts=request.arrival_s, write=request.traced,
            request_id=request.id, prompt_len=len(request.prompt),
            max_new_tokens=request.max_new_tokens, priority=request.priority,
            replayed=True, generated=len(request.generated),
        )
        self.replayed_requests += 1
        if len(request.generated) >= request.max_new_tokens:
            # the journal caught the last token but not the done record
            request.stop_reason = "max_tokens"
            request.advance_phase("done")
            self.scheduler.completed.append(request)
            return [self._done_event(request)]
        return self._ingest(request)

    def _ingest(self, request: ServeRequest) -> list[dict]:
        """Hand a built request to the scheduler, journal its acceptance,
        and return the terminals submission produced (a rejection, shed
        victims)."""
        before = len(self.scheduler.completed)
        self.scheduler.submit(request)
        if not request.done and self.journal is not None:
            self.journal.accepted(request)
            if request.generated or request.emitted:
                # a replayed continuation must survive a second death
                self.journal.progress(request)
        return [self._done_event(r) for r in self.scheduler.completed[before:]]

    # ---------------------------------------------------------- resilience

    def attach_journal(self, journal, every: int = 1) -> None:
        """Record request lifetimes into `journal`; progress is checkpointed
        every `every` engine steps (and always at drain)."""
        self.journal = journal
        self._journal_every = max(1, int(every))

    def _retire_finished(self) -> None:
        """The deferred `done` records of terminals the caller has had the
        chance to deliver (everything returned before this step)."""
        if self.journal is None or not self._unretired:
            return
        retired, self._unretired = self._unretired, []
        for request in retired:
            self.journal.finished(request)

    def reload_weights(self, weights: Mapping[str, torch.Tensor]) -> int:
        """Hot-swap the model's tensors between engine steps. `weights` maps
        every name of the model's `state_dict()` to a tensor of the same
        shape, dtype and device. Every running request is evicted through
        the fold-in requeue first: its paged KV was computed under the old
        weights. A tensor the engine already holds stays bound (no copy);
        any other is bound in its place. Returns the new generation."""
        current = self.model.state_dict(keep_vars=True)
        missing, unexpected = sorted(set(current) - set(weights)), sorted(set(weights) - set(current))
        if missing or unexpected:
            raise ValueError(
                "reload_weights: parameter names mismatch — the reload must be the same "
                f"architecture (missing {missing[:4]}, unexpected {unexpected[:4]})"
            )
        for name, old in current.items():
            new = weights[name]
            if (new.shape, new.dtype, new.device) != (old.shape, old.dtype, old.device):
                raise ValueError(
                    f"reload_weights: {name} shape/dtype/device mismatch ({tuple(new.shape)}/"
                    f"{new.dtype}/{new.device} vs the engine's {tuple(old.shape)}/{old.dtype}/"
                    f"{old.device})"
                )
        evicted = 0
        for request in list(self.scheduler.running.values()):
            self.scheduler.evict(request)
            evicted += 1
        for name, new in weights.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = self.model.get_submodule(owner_name)
            if leaf in owner._parameters:
                if owner._parameters[leaf] is not new:
                    owner._parameters[leaf] = (
                        new if isinstance(new, torch.nn.Parameter)
                        else torch.nn.Parameter(new, requires_grad=False)
                    )
            elif owner._buffers[leaf] is not new:
                owner._buffers[leaf] = new
        self.weights_generation += 1
        get_registry().gauge("serve/weights_generation").set(float(self.weights_generation))
        get_tracer().instant("serve", "weights_reload", generation=self.weights_generation,
                             evicted_for_reload=evicted)
        logger.info("weights reloaded: generation %d (%d in-flight request(s) folded for "
                    "re-prefill)", self.weights_generation, evicted)
        return self.weights_generation

    def drain(self) -> dict:
        """Evict and journal everything in flight, the graceful-shutdown
        tail: running requests fold their progress through the eviction
        requeue (freeing every pool block), then every queued request is
        checkpointed to the journal for a relaunch to `submit_resumed`. No
        terminal is emitted: the relaunch owes them."""
        self._retire_finished()
        for request in list(self.scheduler.running.values()):
            self.scheduler.evict(request)
        journaled = 0
        for request in self.scheduler.waiting:
            if self.journal is not None:
                self.journal.progress(request)
                journaled += 1
        summary = {"journaled": journaled, "blocks_in_use": self.allocator.blocks_in_use,
                   "step": self.step_index}
        get_tracer().instant("serve", "drain", **summary)
        logger.warning("drain: %d unfinished request(s) journaled for replay (%d pool blocks "
                       "in use)", journaled, self.allocator.blocks_in_use)
        return summary

    # ---------------------------------------------------------------- step

    def step(self) -> list[dict]:
        """One scheduler round: deadline expiry, admissions, shedding, at
        most one prefill chunk, one decode step over every decoding row.
        Returns the streamed events (deadline/overloaded terminals
        included)."""
        events: list[dict] = []
        tracer = get_tracer()
        self.step_index += 1
        # what the previous step returned has been delivered by now: retire
        # finished ids and checkpoint progress before this step can die
        self._retire_finished()
        if self.journal is not None and self.step_index % self._journal_every == 0:
            for request in self.scheduler.running.values():
                self.journal.progress(request)
        # chaos serve faults: a wedged step and a mid-stream SIGTERM land
        # where the real ones would, at the top of an engine step
        chaos = get_chaos()
        if chaos is not None:
            chaos.maybe_serve_stall(self.step_index)
            chaos.maybe_serve_sigterm_mid_stream(self.step_index)
        with tracer.measure(
            "serve", "engine_step", step=self.step_index,
            running=len(self.scheduler.running), waiting=len(self.scheduler.waiting),
        ):
            before = len(self.scheduler.completed)
            # deadlines first: expired queued work never costs a prefill, and
            # an expired running row frees its blocks before admission looks
            self.scheduler.expire_deadlines()
            self.scheduler.admit()
            # the service-time EMA moves with every completion, so the
            # projected-TTFT shed decision is re-evaluated each step
            self.scheduler.shed()
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
            get_tracer().instant(
                "serve", "first_token", ts=now, write=request.traced, request_id=request.id,
                # arrival-anchored: an evicted-then-resumed request's TTFT
                # counts from its original arrival
                ttft_ms=round(1000.0 * (now - request.arrival_s), 3),
            )
        request.last_token_s = now
        while request.emitted < len(request.generated):
            events.append({
                "type": "token", "id": request.id,
                "token": request.generated[request.emitted],
                "logprob": request.logprobs[request.emitted],
                "generation": self.weights_generation,
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
        t_chunk = time.perf_counter()
        key = self._next_key()  # every chunk takes one, final or not
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
            rope_length=self.config.max_model_len,
        )
        out = self.model(
            self._tensor(ids), segment_ids=self._tensor(seg),
            position_ids=self._tensor(pos), decode_state=state,
        )
        self.prefill_chunks += 1
        request.prefilled += len(chunk)
        request.cache_len += len(chunk)
        final = start + len(chunk) >= len(request.prefill_tokens)
        if final:
            logits = out.logits[0, len(chunk) - 1].to(torch.float32)
            tokens, logprobs = self._sample(logits[None], key)
            self._emit_token(request, int(tokens[0]), float(logprobs[0]), events)
        now = time.perf_counter()
        get_tracer().span(
            "serve", "prefill_chunk", t_chunk, now, write=request.traced,
            request_id=request.id, start=start, tokens=len(chunk), final=final,
        )
        if final and not request.done:
            # the first new token landed inside the prefill phase; decode
            # (one token per engine step) starts here
            request.advance_phase("decode", now)
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
        key = self._next_key()
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
            rope_length=self.config.max_model_len,
        )
        out = self.model(
            self._tensor(tokens), position_ids=lengths_t[:, None].long(),
            decode_state=state,
        )
        self.decode_steps += 1
        host, host_lp = self._sample(out.logits[:, -1].to(torch.float32), key)
        for request in survivors:
            request.cache_len += 1
            self._emit_token(
                request, int(host[request.slot]), float(host_lp[request.slot]), events
            )
        return events

    def _done_event(self, request: ServeRequest) -> dict:
        if request.stop_reason in ("eos", "max_tokens"):
            self._done_full += 1
        elif request.stop_reason in _SHED_REASONS:
            self._done_shed += 1
        else:
            self._done_failed += 1
        if self.journal is not None:
            self._unretired.append(request)
        event = {
            "type": "done", "id": request.id,
            "stop_reason": request.stop_reason,
            "tokens": list(request.generated),
            "logprobs": list(request.logprobs),
            "n_tokens": len(request.generated),
            "evictions": request.evictions,
            "generation": self.weights_generation,
        }
        if request.first_token_s is not None:
            event["ttft_ms"] = round(1000.0 * (request.first_token_s - request.arrival_s), 3)
        if request.last_token_s is not None and len(request.generated) > 1:
            event["tpot_ms"] = round(
                1000.0 * (request.last_token_s - request.first_token_s)
                / (len(request.generated) - 1), 3,
            )
        get_tracer().instant(
            "serve", "done", write=request.traced, request_id=request.id,
            stop_reason=request.stop_reason, n_tokens=len(request.generated),
            evictions=request.evictions,
            queue_wait_ms=round(1000.0 * request.queue_wait_s, 3),
            **({"ttft_ms": event["ttft_ms"]} if "ttft_ms" in event else {}),
        )
        return event

    # ----------------------------------------------------------------- run

    def run(self, requests: Sequence[dict], max_steps: int = 100_000) -> list[dict]:
        """Submit a closed request set and step until drained. Each dict:
        {'id', 'prompt', 'max_new_tokens'?, 'priority'?,
        'deadline_ms'?}."""
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

    def _completed_latencies(self) -> tuple[list, list, list[float], list[float]]:
        """(all terminals, full completions, ttft_ms, tpot_ms) over the
        requests finished so far: the one filter both `stats()` and
        `live_stats()` render."""
        return _latencies(list(self.scheduler.completed))

    def live_stats(self) -> dict[str, float]:
        """Scrape-time gauges for the `/metrics` exporter: queue depth,
        in-flight rows, terminal counts and rolling TTFT/TPOT percentiles
        over the newest `_LIVE_WINDOW` terminals. Called from the
        exporter's handler threads: host reads only, never the card."""
        _, _, ttft, tpot = _latencies(self.scheduler.completed[-_LIVE_WINDOW:])
        out = {
            "serve/queue_depth": float(len(self.scheduler.waiting)),
            "serve/running": float(len(self.scheduler.running)),
            "serve/engine_steps": float(self.step_index),
            "serve/requests_completed": float(self._done_full),
            "serve/requests_failed": float(self._done_failed),
            "serve/requests_shed": float(self._done_shed),
            "serve/tokens_generated": float(self.tokens_generated),
            "serve/weights_generation": float(self.weights_generation),
            "decode/cache_blocks_in_use": float(self.allocator.blocks_in_use),
        }
        _percentiles(out, ttft, tpot)
        return out

    def stats(self) -> dict[str, float]:
        """Completed / shed / failed requests, tokens, tokens/s and TTFT/TPOT
        percentiles over the requests finished so far (host clock), with
        the tracer's counts; published as `serve/*` gauges in the current
        registry."""
        completed_all, completed, ttft, tpot = self._completed_latencies()
        # shed load (deadline/overloaded) is the engine keeping its budget;
        # requests_failed is what remains (rejections, capacity)
        shed = sum(r.stop_reason in _SHED_REASONS for r in completed_all)
        wall = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        stats = {
            "serve/requests_completed": float(len(completed)),
            "serve/requests_failed": float(len(completed_all) - len(completed) - shed),
            "serve/requests_shed": float(shed),
            "serve/requests_evicted": float(self.scheduler.evictions),
            "serve/shed_total": float(self.scheduler.shed_total),
            "serve/deadline_total": float(self.scheduler.deadline_total),
            "serve/weights_generation": float(self.weights_generation),
            "serve/replayed_requests": float(self.replayed_requests),
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
        _percentiles(stats, ttft, tpot)
        counts = get_tracer().counts()
        stats["trace/events_recorded"] = float(counts["recorded"])
        stats["trace/events_written"] = float(counts["written"])
        stats["trace/requests_sampled"] = float(counts["requests_sampled"])
        registry = get_registry()
        for key, value in stats.items():
            registry.gauge(key).set(value)
        return stats


def _latencies(terminals: list) -> tuple[list, list, list[float], list[float]]:
    completed = [r for r in terminals if r.stop_reason in ("eos", "max_tokens")]
    ttft = [
        1000.0 * (r.first_token_s - r.arrival_s)
        for r in completed if r.first_token_s is not None
    ]
    tpot = [
        1000.0 * (r.last_token_s - r.first_token_s) / (len(r.generated) - 1)
        for r in completed
        if r.last_token_s is not None and len(r.generated) > 1
    ]
    return terminals, completed, ttft, tpot


def _percentiles(out: dict[str, float], ttft: list[float], tpot: list[float]) -> None:
    for name, values in (("ttft", ttft), ("tpot", tpot)):
        if values:
            out[f"serve/{name}_p50_ms"] = float(np.percentile(values, 50))
            out[f"serve/{name}_p99_ms"] = float(np.percentile(values, 99))
