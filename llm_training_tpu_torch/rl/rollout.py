"""Rollout collection through the serving engine.

Counterpart of `llm_training_tpu/rl/rollout.py`. Rollouts are ordinary
`ServingEngine` requests, `group_size` samples per prompt, submitted as a
priority class of their own (below user traffic by default); the
collector drives `engine.step()` as the serve loop does and routes every
other event to `on_foreign_event`.

- behavior logprobs: every token event carries the chosen token's logprob
  under the distribution it was sampled from; GRPO's ratio is taken
  against exactly these;
- generation tagging: every event carries the weights generation it was
  decoded under. A sample is usable only when all its tokens came from the
  engine's current generation: one that spans a `reload_weights` is
  dropped and counted (`rl/rollouts_stale_dropped`), never trained on.

SLO arbitration: with an `SLOMonitor` attached, a NEW serve-domain breach
(TTFT/TPOT) stops the submission of further rollout groups for
`yield_steps` engine steps (`rl/rollout_yields` counts the waves and a
`rollout_yield` trace instant marks each); rollouts in flight keep their
slots and user traffic keeps flowing. Each round is a `collect_round`
span.

`stats()` reads the counters under a lock (the exporter's scrape threads
call it); everything else is host state of the collection thread.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from llm_training_tpu_torch.telemetry.trace import get_tracer

logger = logging.getLogger(__name__)

ID_PREFIX = "rl:"
_FULL_REASONS = ("eos", "max_tokens")


def rollout_id(round_idx: int, prompt_idx: int, sample_idx: int) -> str:
    return f"{ID_PREFIX}r{round_idx}:p{prompt_idx}:s{sample_idx}"


def parse_rollout_id(id: str) -> tuple[int, int, int] | None:
    """(round, prompt, sample) of a collector-issued id, else None."""
    if not id.startswith(ID_PREFIX):
        return None
    try:
        r, p, s = id[len(ID_PREFIX):].split(":")
        return int(r[1:]), int(p[1:]), int(s[1:])
    except (ValueError, IndexError):
        return None


@dataclass
class Rollout:
    """One harvested sample: (prompt, completion, behavior logprobs) and
    where it came from."""

    id: str
    round_idx: int
    prompt_idx: int
    sample_idx: int
    prompt: list[int]
    tokens: list[int]
    logprobs: list[float]
    generation: int
    stop_reason: str
    reward: float | None = None


@dataclass
class _Pending:
    prompt: list[int]
    round_idx: int
    prompt_idx: int
    sample_idx: int
    generations: set[int] = field(default_factory=set)
    adopted: bool = False
    done: dict | None = None


class RolloutCollector:
    """Submits prompt groups into `engine`, drives its steps and harvests
    the samples decoded wholly under the current weights."""

    def __init__(
        self,
        engine: Any,
        group_size: int = 4,
        max_new_tokens: int = 16,
        priority: int = -1,
        on_foreign_event: Callable[[dict], None] | None = None,
        slo: Any | None = None,
        yield_steps: int = 50,
    ):
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        self.engine = engine
        self.group_size = group_size
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.on_foreign_event = on_foreign_event
        self.slo = slo
        self.yield_steps = max(0, int(yield_steps))
        self._pending: dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self._counters = {  # guarded by: _lock
            "rollouts_submitted": 0,
            "rollouts_collected": 0,
            "rollouts_stale_dropped": 0,
            "rollouts_failed": 0,
            "rollout_yields": 0,
        }
        # SLO arbitration state: read and written between engine steps on
        # the collection thread only, never by a scrape
        self._seen_breaches = self.slo.breach_count() if self.slo is not None else 0
        self._yield_left = 0

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    def stats(self) -> dict[str, float]:
        """The counters, `rl/`-prefixed."""
        with self._lock:
            return {f"rl/{k}": float(v) for k, v in self._counters.items()}

    # -------------------------------------------------------------- intake

    def adopt(self, entries: Sequence[dict]) -> int:
        """Register journal-replayed rollout requests (the caller submits
        them with `submit_resumed`). Their journaled tokens were decoded by
        the previous process under the weights this relaunch restored (the
        loop checkpoints after every sync), so they count as current.
        Returns how many entries were rollouts."""
        adopted = 0
        for entry in entries:
            parsed = parse_rollout_id(str(entry.get("id", "")))
            if parsed is None:
                continue
            round_idx, prompt_idx, sample_idx = parsed
            self._pending[entry["id"]] = _Pending(
                prompt=[int(t) for t in entry["prompt"]], round_idx=round_idx,
                prompt_idx=prompt_idx, sample_idx=sample_idx, adopted=True,
            )
            adopted += 1
        if adopted:
            logger.info("rollout collector adopted %d replayed sample(s)", adopted)
        return adopted

    def _submit_group(self, round_idx: int, prompt_idx: int, prompt: Sequence[int]) -> list[dict]:
        events: list[dict] = []
        for sample_idx in range(self.group_size):
            id = rollout_id(round_idx, prompt_idx, sample_idx)
            if id in self._pending:  # adopted from a replayed journal
                continue
            self._pending[id] = _Pending(prompt=list(prompt), round_idx=round_idx,
                                         prompt_idx=prompt_idx, sample_idx=sample_idx)
            self._bump("rollouts_submitted")
            events.extend(self.engine.submit(id=id, prompt=prompt,
                                             max_new_tokens=self.max_new_tokens,
                                             priority=self.priority))
        return events

    # ------------------------------------------------------------- routing

    def ingest(self, events: Sequence[dict]) -> None:
        """Route events obtained outside `collect` (submit's and
        `submit_resumed`'s returns) as step output is routed."""
        self._route(events)

    def _route(self, events: Sequence[dict]) -> None:
        for event in events:
            pending = self._pending.get(event.get("id"))
            if pending is None:
                if self.on_foreign_event is not None:
                    self.on_foreign_event(event)
                continue
            if event.get("type") in ("token", "done"):
                pending.generations.add(int(event["generation"]))
            if event.get("type") == "done":
                pending.done = event

    # --------------------------------------------------------- arbitration

    def _slo_gate(self) -> bool:
        """True while rollout submission yields to serve traffic: a NEW
        serve-domain breach opens (or re-arms) a `yield_steps` window."""
        if self.slo is not None:
            breaches = self.slo.breach_count()
            if breaches > self._seen_breaches:
                self._seen_breaches = breaches
                alert = self.slo.last_alert() or {}
                if str(alert.get("key", "")).startswith("serve/"):
                    self._yield_left = self.yield_steps
                    self._bump("rollout_yields")
                    get_tracer().instant("rl", "rollout_yield", key=alert.get("key"),
                                         burn_fast=alert.get("burn_fast"),
                                         yield_steps=self.yield_steps)
                    logger.warning("rollout submission yielding %d engine steps to serve "
                                   "traffic (SLO breach on %s)", self.yield_steps,
                                   alert.get("key"))
        if self._yield_left > 0:
            self._yield_left -= 1
            return True
        return False

    # ------------------------------------------------------------- collect

    def collect(
        self,
        round_idx: int,
        prompts: Sequence[Sequence[int]],
        max_steps: int = 100_000,
        should_stop: Callable[[], bool] | None = None,
    ) -> list[Rollout]:
        """One round: submit `group_size` samples per prompt (groups wait
        while the SLO gate is closed), drive the engine until every rollout
        of the round is terminal, and harvest them. Adopted samples of this
        round take their original (prompt, sample) places instead of being
        submitted again. `should_stop` (a `GracefulShutdown`'s flag) breaks
        out between engine steps: the caller drains, journals, and the
        round replays."""
        queue = list(enumerate(prompts))
        with get_tracer().measure("rl", "collect_round", round=round_idx, prompts=len(prompts),
                                  group=self.group_size):
            for _ in range(max_steps):
                if should_stop is not None and should_stop():
                    break
                while queue and not self._slo_gate():
                    prompt_idx, prompt = queue.pop(0)
                    self._route(self._submit_group(round_idx, prompt_idx, prompt))
                    if self._yield_left > 0:
                        break
                open_rollouts = [p for p in self._pending.values()
                                 if p.round_idx == round_idx and p.done is None]
                if not queue and not open_rollouts:
                    break
                self._route(self.engine.step())
            else:
                raise RuntimeError(
                    f"rollout round {round_idx} not drained after {max_steps} engine steps"
                )
        return self._harvest(round_idx)

    def _harvest(self, round_idx: int) -> list[Rollout]:
        current = self.engine.weights_generation
        rollouts: list[Rollout] = []
        for id in [i for i, p in self._pending.items() if p.round_idx == round_idx]:
            pending = self._pending.pop(id)
            done = pending.done
            if done is None:
                continue  # drained away: drain() journals it for the replay
            if done.get("stop_reason") not in _FULL_REASONS:
                # deadline, capacity or rejection: load the engine refused
                self._bump("rollouts_failed")
                continue
            logprobs = done.get("logprobs") or []
            stale = pending.generations - {current}
            if stale or (not pending.generations and not pending.adopted):
                # tokens decoded under older weights, or of unknown origin
                self._bump("rollouts_stale_dropped")
                get_tracer().instant("rl", "rollout_stale_dropped", request_id=id,
                                     generations=sorted(pending.generations), current=current)
                continue
            if len(logprobs) != len(done.get("tokens", [])) or any(lp is None for lp in logprobs):
                # a logprob gap would poison the importance ratio
                self._bump("rollouts_stale_dropped")
                continue
            self._bump("rollouts_collected")
            rollouts.append(Rollout(
                id=id, round_idx=round_idx, prompt_idx=pending.prompt_idx,
                sample_idx=pending.sample_idx, prompt=pending.prompt,
                tokens=[int(t) for t in done["tokens"]],
                logprobs=[float(lp) for lp in logprobs], generation=current,
                stop_reason=done["stop_reason"],
            ))
        return rollouts
