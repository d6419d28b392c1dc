"""Odds-Ratio Preference Optimization (one model).

Counterpart of `llm_training_tpu/lms/orpo.py`: length-normalised
per-sequence log-probs of the chosen and the rejected response, the
odds-ratio loss `-(beta * logsigmoid(log_odds)).mean()` added to the CE
loss on the chosen response, and the reward and log-odds metrics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from llm_training_tpu_torch import prng
from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider, SingleModelObjective
from llm_training_tpu_torch.lms.dpo import sequence_log_probs


@dataclass
class ORPOConfig(BaseLMConfig):
    model: ModelProvider | None = None
    beta: float = 0.1
    ignore_index: int = -100
    logps_chunk_size: int = 1024


class ORPO(SingleModelObjective):
    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        rng: prng.Key | None = None,
        train: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: the preference collator's. Returns (loss fp32, metrics)."""
        cfg = self.config
        chosen_sums, chosen_counts = sequence_log_probs(
            self.model, batch, "chosen", cfg.ignore_index, cfg.logps_chunk_size)
        rejected_sums, rejected_counts = sequence_log_probs(
            self.model, batch, "rejected", cfg.ignore_index, cfg.logps_chunk_size)

        # length-normalised log-probs
        chosen_logps = chosen_sums / chosen_counts.clamp_min(1)
        rejected_logps = rejected_sums / rejected_counts.clamp_min(1)

        # the odds ratio in log space; log1p(-exp(x)) is stable for x < 0,
        # and the clamp keeps x below 0 (a fully truncated response has
        # count 0, log-prob 0 and would give log1p(-1) = -inf)
        eps = -1e-6
        log_odds = (chosen_logps - rejected_logps) - (
            torch.log1p(-torch.exp(chosen_logps.clamp(max=eps)))
            - torch.log1p(-torch.exp(rejected_logps.clamp(max=eps)))
        )
        ratio = F.logsigmoid(log_odds)
        or_loss = -(cfg.beta * ratio).mean()
        # the CE (SFT) term on the chosen response
        ce_loss = -chosen_sums.sum() / chosen_counts.sum().clamp_min(1)
        loss = or_loss + ce_loss

        chosen_rewards = cfg.beta * chosen_logps.detach()
        rejected_rewards = cfg.beta * rejected_logps.detach()
        metrics = {
            "loss": loss.detach(),
            "or_loss": or_loss.detach(),
            "ce_loss": ce_loss.detach(),
            "target_tokens": chosen_counts.sum() + rejected_counts.sum(),
            "chosen_rewards": chosen_rewards.mean(),
            "rejected_rewards": rejected_rewards.mean(),
            "reward_accuracy": (chosen_rewards > rejected_rewards).float().mean(),
            "reward_margin": (chosen_rewards - rejected_rewards).mean(),
            "log_odds_ratio": ratio.detach().mean(),
            "log_odds_chosen": log_odds.detach().mean(),
        }
        return loss, metrics
