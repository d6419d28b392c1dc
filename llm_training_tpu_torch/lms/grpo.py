"""Group Relative Policy Optimization (on-policy RL post-training).

Counterpart of `llm_training_tpu/lms/grpo.py`, the objective of the
`rl-fit` loop (`rl/loop.py`): rollouts sampled through the serving engine
with each chosen token's behavior logprob, a verifiable reward per
rollout, and one policy-gradient update over them:

- group-relative advantages: each sample's reward standardized against
  its own prompt group (mean and std over the group's samples);
- a token-level PPO-clipped ratio of the current policy against the
  collected behavior logprobs;
- the k3 KL estimator to a frozen reference, token-level, weighted by
  `beta`.

The trained module is DPO's `PolicyAndReference` (`lms/dpo.py`): `^ref/`
joins `frozen_modules`, the reference starts as an exact copy of the
policy, and its forward runs under `torch.no_grad()`. Per-token logps come
from the chunked `fused_linear_token_log_probs`, so the `[batch, seq,
vocab]` logits never exist.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_training_tpu_torch import prng
from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider
from llm_training_tpu_torch.lms.clm import head_and_bias
from llm_training_tpu_torch.lms.dpo import PairObjective
from llm_training_tpu_torch.ops.cross_entropy import fused_linear_token_log_probs, shift_labels


def group_relative_advantages(
    rewards: torch.Tensor, group_ids: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """(r - mean(group)) / (std(group) + eps) per sample, the statistics
    over the sample's own group. `group_ids` are dense ints in [0, batch),
    summed per group as `jax.ops.segment_sum` does; a group of one, or a
    group of equal rewards, gets advantage 0."""
    n = rewards.shape[0]
    rewards = rewards.float()
    ids = group_ids.long()

    def segment_sum(values: torch.Tensor) -> torch.Tensor:
        return torch.zeros(n, dtype=values.dtype, device=values.device).index_add_(0, ids, values)

    safe_counts = segment_sum(torch.ones_like(rewards)).clamp_min(1.0)
    mean = segment_sum(rewards) / safe_counts
    centered = rewards - mean[ids]
    var = segment_sum(centered * centered) / safe_counts
    return centered / (torch.sqrt(var)[ids] + eps)


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """x[:, 1:] with a zero column appended: a per-position quantity moved
    onto the label position that predicts it."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


@dataclass
class GRPOConfig(BaseLMConfig):
    model: ModelProvider | None = None
    ref_model: ModelProvider | None = None  # defaults to a frozen copy of `model`
    beta: float = 0.04  # KL-to-reference weight (k3, token-level)
    clip_eps: float = 0.2  # PPO ratio clip half-width
    # rollout samples per prompt (the advantage group); the rollout
    # collector reads it, the loss takes groups from `group_ids`
    group_size: int = 4
    ignore_index: int = -100
    logps_chunk_size: int = 1024


class GRPO(PairObjective):
    def _token_logps(self, model: torch.nn.Module, batch: dict[str, torch.Tensor]):
        """(label log-probs `[B, S]` fp32 of prompt + completion rows, 0
        outside completion predictions; the mask `[B, S]` fp32)."""
        cfg = self.config
        segment_ids = batch["segment_ids"]
        # a position's label is the next token, valid inside one nonzero
        # segment, and only where that token is a completion token
        valid = (segment_ids > 0) & (segment_ids == _shift_left(segment_ids))
        valid = valid & (_shift_left(batch["completion_mask"]) > 0)
        labels = shift_labels(batch["input_ids"].long(), cfg.ignore_index)
        labels = torch.where(valid, labels, cfg.ignore_index)
        out = model(
            input_ids=batch["input_ids"].long(),
            segment_ids=segment_ids,
            position_ids=batch.get("position_ids"),
            compute_logits=False,
            return_last_hidden_states=True,
        )
        hidden = out.last_hidden_states
        head, bias = head_and_bias(model)
        logps, valids = fused_linear_token_log_probs(
            hidden, head.to(hidden.dtype), labels, ignore_index=cfg.ignore_index,
            chunk_size=cfg.logps_chunk_size,
            logits_soft_cap=getattr(model.config, "final_logit_softcapping", None), bias=bias,
        )
        return logps, valids.float()

    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        rng: prng.Key | None = None,
        train: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: input_ids `[B, S]` (prompt + completion, right-padded),
        segment_ids `[B, S]`, completion_mask `[B, S]` (1 on completion
        tokens), behavior_logprobs `[B, S]` (the collected logprob of the
        token at each position), rewards `[B]`, group_ids `[B]`. Returns
        (loss fp32, metrics)."""
        cfg = self.config
        policy_lp, mask = self._token_logps(self.model, batch)
        with torch.no_grad():
            ref_lp, _ = self._token_logps(self.ref_model, batch)

        # behavior logprobs are per completion token: onto the label positions
        behavior_lp = _shift_left(batch["behavior_logprobs"].float())
        advantages = group_relative_advantages(batch["rewards"], batch["group_ids"])[:, None]

        # the PPO-clipped token-level ratio against the behavior policy
        live = mask > 0
        ratio = torch.exp(torch.where(live, policy_lp - behavior_lp, 0.0))
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        pg = -torch.minimum(ratio * advantages, clipped * advantages)

        # k3 KL estimator to the frozen reference: >= 0, unbiased
        ref_log_ratio = torch.where(live, ref_lp - policy_lp, 0.0)
        kl = torch.exp(ref_log_ratio) - ref_log_ratio - 1.0

        n_tokens = mask.sum().clamp_min(1.0)
        loss = ((pg + cfg.beta * kl) * mask).sum() / n_tokens
        clip_frac = (((ratio - 1.0).abs() > cfg.clip_eps).float() * mask).sum() / n_tokens
        metrics = {
            "loss": loss.detach(),
            "target_tokens": mask.sum().to(torch.int32),
            "mean_reward": batch["rewards"].float().mean(),
            "mean_advantage": advantages.mean(),
            "kl_to_ref": ((kl * mask).sum() / n_tokens).detach(),
            "ratio_clip_frac": clip_frac.detach(),
            "policy_logps": ((policy_lp * mask).sum() / n_tokens).detach(),
        }
        return loss, metrics
