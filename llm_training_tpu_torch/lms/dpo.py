"""Direct Preference Optimization.

Counterpart of `llm_training_tpu/lms/dpo.py`: a policy and a frozen
reference model, per-sequence label log-probs of the chosen and the
rejected response under each (`fused_linear_log_probs`), the sigmoid loss
with label smoothing and the reward metrics.

The trained module is a `PolicyAndReference` (`policy`, `ref`), so its
parameters are named `policy.<name>` and `ref.<name>` and match the JAX
tree's `policy/params/...` and `ref/params/...` (`from_jax.jax_path`).
`^ref/` joins `frozen_modules`, the reference's parameters do not require
gradients, and the optimizer holds no state for them. The reference's two
forwards run under `torch.no_grad()`, JAX's `stop_gradient`: no backward
graph, no saved activations. The reference starts as an exact copy of the
policy's initial weights (random, or read once from the pre-trained
source), or is built from `ref_model` (initialised from the same generator
state as the policy, as JAX inits both under one key, or loaded from its
own source, else the policy's, as JAX's `pretrained_params`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from llm_training_tpu_torch import prng
from llm_training_tpu_torch.lms.base import (
    BaseLMConfig,
    ModelProvider,
    build_model,
    init_model,
    resolve_pretrained_source,
)
from llm_training_tpu_torch.lms.clm import head_and_bias
from llm_training_tpu_torch.ops.cross_entropy import fused_linear_log_probs, shift_labels


def sequence_log_probs(
    model: torch.nn.Module, batch: dict[str, torch.Tensor], side: str, ignore_index: int,
    chunk_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the label log-probs `[batch]` fp32, valid counts `[batch]`)
    of one side (`chosen`, `rejected`) of a preference batch under
    `model`: the labels shifted, the head applied chunk by chunk
    (`fused_linear_log_probs`), as the JAX DPO and ORPO do it."""
    labels = shift_labels(batch[f"{side}_labels"].long(), ignore_index)
    out = model(
        input_ids=batch[f"{side}_input_ids"].long(),
        segment_ids=batch.get(f"{side}_segment_ids"),
        position_ids=batch.get(f"{side}_position_ids"),
        compute_logits=False,
        return_last_hidden_states=True,
    )
    hidden = out.last_hidden_states
    head, bias = head_and_bias(model)
    return fused_linear_log_probs(
        hidden, head.to(hidden.dtype), labels, ignore_index=ignore_index, chunk_size=chunk_size,
        logits_soft_cap=getattr(model.config, "final_logit_softcapping", None), bias=bias,
    )


@dataclass
class DPOConfig(BaseLMConfig):
    model: ModelProvider | None = None
    ref_model: ModelProvider | None = None  # defaults to a frozen copy of `model`
    beta: float = 0.1
    label_smoothing: float = 0.0
    ignore_index: int = -100
    logps_chunk_size: int = 1024


class PolicyAndReference(torch.nn.Module):
    """The policy and the frozen reference, as one module of parameters."""

    def __init__(self, policy: torch.nn.Module, ref: torch.nn.Module):
        super().__init__()
        self.policy = policy
        self.ref = ref


class PairObjective:
    """The objective contract over a `PolicyAndReference` (DPO, GRPO):
    `^ref/` joins `frozen_modules`; `configure_model` builds the pair and
    `bind` points the objective at one."""

    def __init__(
        self,
        config,
        model: torch.nn.Module | None = None,
        ref_model: torch.nn.Module | None = None,
    ):
        self.config = config
        # models handed in keep their weights; those built from the config
        # are made by `configure_model` on the trainer's device
        self.model = model
        self.ref_model = ref_model
        self.pair: PolicyAndReference | None = None
        if "^ref/" not in config.frozen_modules:
            config.frozen_modules = list(config.frozen_modules) + ["^ref/"]

    def configure_model(self, device: torch.device, generator: torch.Generator) -> torch.nn.Module:
        """The `PolicyAndReference` on `device`: the policy handed in or
        built, and the reference handed in, built from `ref_model`, or
        copied from the policy. A built model loads the pre-trained source
        (`pretrained_sources`) or takes random weights from `generator`
        when `init_weights`; a `ref_model` starts from the generator state
        the policy started from, as JAX inits both under one key."""
        if self.pair is None:
            cfg = self.config
            where = type(cfg).__name__
            start = generator.get_state()
            policy = self.model
            ref = self.ref_model
            if policy is None:
                policy = build_model(cfg.model, device, f"{where}.model")
            if ref is None and cfg.ref_model is not None:
                ref = build_model(cfg.ref_model, device, f"{where}.ref_model")
            policy_src, ref_src = self.pretrained_sources(policy, ref)
            if self.model is None:
                init_model(policy, cfg, policy_src, generator)
            if ref is None:
                # one model, one source: the checkpoint is read once and
                # placed twice; the reference starts as an exact copy
                ref = copy.deepcopy(policy)
            elif self.ref_model is None:
                generator.set_state(start)
                init_model(ref, cfg, ref_src, generator)
            ref.requires_grad_(False)
            self.pair = PolicyAndReference(policy, ref)
        self.bind(self.pair.to(device))
        return self.pair

    def pretrained_sources(self, policy: torch.nn.Module,
                           ref: torch.nn.Module | None) -> tuple[str | None, str | None]:
        """(policy's, reference's) pre-trained source, as JAX's
        `pretrained_params` reads them: the policy's is the objective's
        `pre_trained_weights`, else its model config's; a separate
        reference reads its own config's source when it has one, else the
        policy's. Nothing loads without a policy source."""
        policy_src = resolve_pretrained_source(self.config, policy.config)
        if not policy_src:
            return None, None
        ref_src = getattr(ref.config, "pre_trained_weights", None) if ref is not None else None
        return policy_src, ref_src or policy_src

    def bind(self, module: PolicyAndReference) -> None:
        """Compute with `module`'s policy and reference (a state built by
        `configure_model` and restored)."""
        self.pair, self.model, self.ref_model = module, module.policy, module.ref


class DPO(PairObjective):
    def _logps(self, model, batch, side):
        cfg = self.config
        return sequence_log_probs(model, batch, side, cfg.ignore_index, cfg.logps_chunk_size)

    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        rng: prng.Key | None = None,
        train: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: `{chosen,rejected}_{input_ids,labels,segment_ids,
        position_ids}` from the preference collator. Returns (mean loss
        fp32, metrics)."""
        cfg = self.config
        policy_chosen, counts_c = self._logps(self.model, batch, "chosen")
        policy_rejected, counts_r = self._logps(self.model, batch, "rejected")
        with torch.no_grad():
            ref_chosen, _ = self._logps(self.ref_model, batch, "chosen")
            ref_rejected, _ = self._logps(self.ref_model, batch, "rejected")

        logits = (policy_chosen - policy_rejected) - (ref_chosen - ref_rejected)
        # the sigmoid loss with label smoothing
        loss = (
            -F.logsigmoid(cfg.beta * logits) * (1 - cfg.label_smoothing)
            - F.logsigmoid(-cfg.beta * logits) * cfg.label_smoothing
        ).mean()

        chosen_rewards = cfg.beta * (policy_chosen - ref_chosen).detach()
        rejected_rewards = cfg.beta * (policy_rejected - ref_rejected).detach()
        metrics = {
            "loss": loss.detach(),
            "target_tokens": counts_c.sum() + counts_r.sum(),
            "chosen_rewards": chosen_rewards.mean(),
            "rejected_rewards": rejected_rewards.mean(),
            "reward_accuracy": (chosen_rewards > rejected_rewards).float().mean(),
            "reward_margin": (chosen_rewards - rejected_rewards).mean(),
            "policy_chosen_logps": policy_chosen.detach().mean(),
            "policy_rejected_logps": policy_rejected.detach().mean(),
        }
        return loss, metrics
