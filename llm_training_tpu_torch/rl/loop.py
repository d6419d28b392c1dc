"""The GRPO round loop behind `rl-fit`.

Counterpart of `llm_training_tpu/rl/loop.py`. One round:

    collect(W_k) -> score -> update -> W_{k+1} -> sync engine -> checkpoint

- collect: the `RolloutCollector` pushes prompt groups through the
  `ServingEngine` (beside optional synthetic user traffic at a higher
  priority) and harvests the samples decoded under the current weights,
  with their behavior logprobs;
- score: the verifiable reward (`rl/reward.py`) over host token lists;
- update: `updates_per_round` GRPO steps through the trainer's own
  micro-step and `Optimizer` (its frozen mask keeps `^ref/` without
  state);
- sync: `rl/sync.py` pushes the policy's tensors into the engine; the
  generation bump makes any unharvested sample stale;
- checkpoint: the whole train state with an `{"rl": {"round": k+1}}`
  rider, after the sync, so a relaunch restores the weights whatever the
  request journal replays was sampled under.

Round prompts are deterministic in (seed, round), so a relaunched round
makes the same prompts and adopted journal entries take their places.

With `fused` sync the engine decodes from the policy's own parameters,
which the optimizer updates in place. That is safe because the loop never
steps the engine between the update and the sync, and the sync's reload
evicts every request whose paged KV was computed under the old weights.
With `host` sync the engine holds a copy of its own.
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from llm_training_tpu_torch.rl.reward import resolve_reward
from llm_training_tpu_torch.rl.rollout import Rollout, RolloutCollector
from llm_training_tpu_torch.rl.sync import sync_weights
from llm_training_tpu_torch.telemetry.registry import get_registry

logger = logging.getLogger(__name__)

# the update's metrics a round record carries
_RECORD_METRICS = ("loss", "kl_to_ref", "ratio_clip_frac", "mean_advantage")


@dataclass
class RLLoopOptions:
    rounds: int = 4
    prompts_per_round: int = 2
    prompt_len: int = 4
    max_new_tokens: int = 8
    sync_mode: str = "fused"  # "fused" | "host" (rl/sync.py)
    reward: str | None = None  # rl/reward.py name; None -> LLMT_RL_REWARD
    # synthetic prompts: "uniform" = independent random tokens; "repeat" =
    # one random token repeated prompt_len times (the copy-the-digit task)
    prompt_style: str = "uniform"
    rollout_priority: int = -1  # below user traffic's default 0
    # PPO-style epochs over the round's fixed batch
    updates_per_round: int = 1
    user_traffic: int = 0  # synthetic priority-0 requests per round
    resume_step: int | None = None


class RLLoop:
    """Owns the train state, the serving engine, the collector and the
    update. `setup()` builds or restores them; `run()` iterates rounds."""

    def __init__(self, trainer, objective, serve_config, options: RLLoopOptions):
        from llm_training_tpu_torch.lms import GRPO

        if not isinstance(objective, GRPO):
            raise ValueError(
                "rl-fit drives the GRPO objective; the config's model node "
                f"builds {type(objective).__name__} — point rl-fit at a "
                "config whose model node is llm_training_tpu.lms.GRPO"
            )
        self.trainer = trainer
        self.objective = objective
        self.serve_config = serve_config
        self.options = options
        self.reward_fn = resolve_reward(options.reward)
        self.engine: Any = None
        self.collector: RolloutCollector | None = None
        self.state = None
        self.start_round = 0
        self._user_done = 0
        # fixed update shapes: stale drops shrink a round, padding rows fill it
        self.batch_rows = options.prompts_per_round * objective.config.group_size
        self.seq_len = options.prompt_len + options.max_new_tokens
        # per round, host-clock seconds of each stage and the engine's work
        self.timings: list[dict] = []

    # --------------------------------------------------------------- setup

    def setup(self) -> None:
        from llm_training_tpu_torch.serve.engine import ServingEngine

        trainer, objective = self.trainer, self.objective
        state, _ = trainer.init_state(objective)
        if trainer.checkpointer is not None:
            meta = trainer._restore(state, self.options.resume_step)
            if meta is not None:
                self.start_round = int(meta.get("rl", {}).get("round", 0))
                logger.info("restored step %d, resuming at RL round %d", state.step,
                            self.start_round)
        self.state = state
        policy = state.model.policy
        if self.options.sync_mode == "host":
            # the oracle's engine holds tensors of its own, filled through the host
            policy = copy.deepcopy(policy).requires_grad_(False)
        self.engine = ServingEngine(policy, self.serve_config, device=trainer.device)
        self.collector = RolloutCollector(
            self.engine, group_size=objective.config.group_size,
            max_new_tokens=self.options.max_new_tokens,
            priority=self.options.rollout_priority, on_foreign_event=self._on_foreign,
        )

    # ------------------------------------------------------------- traffic

    def _on_foreign(self, event: dict) -> None:
        """Terminals of user traffic riding the engine."""
        if event.get("type") == "done":
            self._user_done += 1

    def _round_prompts(self, round_idx: int) -> list[list[int]]:
        """Deterministic in (seed, round): a relaunched round makes the
        same prompts, so journal-adopted samples line up."""
        rng = np.random.default_rng((self.trainer.config.seed, round_idx))
        high = max(3, self.objective.model.config.vocab_size)
        if self.options.prompt_style == "repeat":
            return [[int(rng.integers(2, high))] * self.options.prompt_len
                    for _ in range(self.options.prompts_per_round)]
        return [rng.integers(2, high, size=self.options.prompt_len).tolist()
                for _ in range(self.options.prompts_per_round)]

    def _submit_user_traffic(self, round_idx: int) -> None:
        rng = np.random.default_rng((self.trainer.config.seed + 1, round_idx))
        vocab = max(3, self.objective.model.config.vocab_size)
        for i in range(self.options.user_traffic):
            prompt = rng.integers(2, vocab, size=self.options.prompt_len).tolist()
            self.collector.ingest(self.engine.submit(
                id=f"user:r{round_idx}:{i}", prompt=prompt,
                max_new_tokens=self.options.max_new_tokens, priority=0,
            ))

    # --------------------------------------------------------------- batch

    def _build_batch(self, rollouts: Sequence[Rollout]) -> dict[str, np.ndarray]:
        """The fixed-shape `[batch_rows, seq_len]` GRPO batch. A short round
        pads with rows whose completion mask is all zero and whose group is
        a fresh singleton: no loss tokens, no group statistics. Group ids
        are remapped densely into [0, batch_rows)."""
        B, S = self.batch_rows, self.seq_len
        input_ids = np.zeros((B, S), np.int32)
        segment_ids = np.zeros((B, S), np.int32)
        completion_mask = np.zeros((B, S), np.int32)
        behavior = np.zeros((B, S), np.float32)
        rewards = np.zeros((B,), np.float32)
        group_ids = np.zeros((B,), np.int32)
        gid_map: dict[int, int] = {}
        rows = list(rollouts)[:B]
        for row, rollout in enumerate(rows):
            seq = list(rollout.prompt) + list(rollout.tokens)
            length = min(len(seq), S)
            input_ids[row, :length] = seq[:length]
            segment_ids[row, :length] = 1
            prompt_len = len(rollout.prompt)
            for j, logprob in enumerate(rollout.logprobs):
                pos = prompt_len + j
                if pos >= S:
                    break
                completion_mask[row, pos] = 1
                behavior[row, pos] = float(logprob)
            rewards[row] = float(rollout.reward or 0.0)
            group_ids[row] = gid_map.setdefault(rollout.prompt_idx, len(gid_map))
        for pad in range(len(rows), B):
            group_ids[pad] = len(gid_map) + (pad - len(rows))
        return {"input_ids": input_ids, "segment_ids": segment_ids,
                "completion_mask": completion_mask, "behavior_logprobs": behavior,
                "rewards": rewards, "group_ids": group_ids}

    # ----------------------------------------------------------------- run

    def _checkpoint(self, next_round: int) -> None:
        checkpointer = self.trainer.checkpointer
        if checkpointer is None:
            return
        checkpointer.save(self.state.step, self.state, force=True,
                          extra={"rl": {"round": next_round}})
        checkpointer.wait()

    def _update(self, batch: dict[str, np.ndarray]) -> dict[str, float]:
        """`updates_per_round` GRPO steps over one batch; the last step's
        metrics on the host."""
        for _ in range(max(1, self.options.updates_per_round)):
            metrics = self.trainer.train_micro_step(self.objective, self.state, batch)
        return {k: float(v) for k, v in metrics.items()}

    def run(self, shutdown=None, emit=None) -> dict:
        """Iterate rounds; returns `{"gauges": rl/* and serve/*, "interrupted"}`.
        `shutdown` (a `GracefulShutdown`) turns a SIGTERM into drain ->
        checkpoint of the current round -> the caller's resumable exit;
        `emit` receives one JSON-able record per round."""
        options = self.options
        registry = get_registry()
        should_stop = (lambda: shutdown.requested) if shutdown is not None else None
        mean_reward = 0.0
        interrupted = False
        completed_rounds = 0
        last_sync = None
        for round_idx in range(self.start_round, options.rounds):
            if shutdown is not None and shutdown.requested:
                interrupted = True
                break
            t_round = time.perf_counter()
            engine_before = (self.engine.decode_steps, self.engine.prefill_chunks,
                             self.engine.tokens_generated)
            self._submit_user_traffic(round_idx)
            rollouts = self.collector.collect(round_idx, self._round_prompts(round_idx),
                                              should_stop=should_stop)
            t_collect = time.perf_counter()
            if shutdown is not None and shutdown.requested:
                interrupted = True
                break
            for rollout in rollouts:
                rollout.reward = self.reward_fn(rollout.prompt, rollout.tokens)
            mean_reward = float(np.mean([r.reward for r in rollouts])) if rollouts else 0.0
            metrics = {}
            if rollouts:
                metrics = self._update(self._build_batch(rollouts))
            else:
                logger.warning("round %d harvested no usable rollouts — skipping the update "
                               "(weights unchanged)", round_idx)
            t_update = time.perf_counter()
            sync = last_sync = sync_weights(self.engine, self.state.model.policy.state_dict(
                keep_vars=True), mode=options.sync_mode)
            t_sync = time.perf_counter()
            self._checkpoint(round_idx + 1)
            t_end = time.perf_counter()
            self.timings.append({
                "round": round_idx, "collect_s": t_collect - t_round,
                "decode_steps": self.engine.decode_steps - engine_before[0],
                "prefill_chunks": self.engine.prefill_chunks - engine_before[1],
                "tokens": self.engine.tokens_generated - engine_before[2],
                "update_s": t_update - t_collect, "sync_s": t_sync - t_update,
                "checkpoint_s": t_end - t_sync, "round_s": t_end - t_round,
            })
            completed_rounds = round_idx + 1
            registry.gauge("rl/rounds").set(float(completed_rounds))
            registry.gauge("rl/mean_reward").set(mean_reward)
            if metrics:
                registry.gauge("rl/loss").set(metrics["loss"])
                registry.gauge("rl/kl_to_ref").set(metrics["kl_to_ref"])
            for key, value in self.collector.stats().items():
                registry.gauge(key).set(value)
            record = {
                "type": "rl_round", "round": round_idx, "collected": len(rollouts),
                "mean_reward": mean_reward, "generation": sync["generation"],
                "sync_mode": sync["mode"], "user_done": self._user_done,
                **{k: v for k, v in metrics.items() if k in _RECORD_METRICS},
                **self.collector.stats(),
            }
            if emit is not None:
                emit(record)
            logger.info("rl round %d: %d rollouts, mean reward %.4f, generation %d",
                        round_idx, len(rollouts), mean_reward, sync["generation"])
        if interrupted:
            # drain journals every request in flight or queued; the
            # checkpoint pins the weights the journaled rollouts came from
            self.engine.drain()
            self._checkpoint(completed_rounds if completed_rounds else self.start_round)
        gauges = {
            "rl/rounds": float(completed_rounds),
            "rl/mean_reward": mean_reward,
            "rl/user_requests_done": float(self._user_done),
            **self.collector.stats(),
            **self.engine.stats(),
        }
        if last_sync is not None:
            gauges["rl/weight_syncs"] = float(last_sync["generation"])
            gauges["rl/sync_time_s"] = float(last_sync["sync_time_s"])
        return {"gauges": gauges, "interrupted": interrupted}
