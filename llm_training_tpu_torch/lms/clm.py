"""Causal language modeling objective.

Counterpart of `llm_training_tpu/lms/clm.py`: the label shift, masking of
labels that would cross a packed document boundary or land on padding,
NEFTune noise on the input embeddings during training, the fused-linear
cross-entropy (full logits never materialise), and the metrics `loss`,
`target_tokens` and `perplexity`; `head_and_bias`, the head of the fused
objectives (CLM, DPO, ORPO).

NEFTune draws its noise with `prng.uniform` under the key it is given, in
the compute dtype, as the JAX CLM draws `jax.random.uniform`: the same key
gives JAX's noise, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from llm_training_tpu_torch import prng
from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider, SingleModelObjective
from llm_training_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy, shift_labels


def head_and_bias(model: torch.nn.Module) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(lm-head matrix `[embed, vocab]`, optional bias `[vocab]`) of a
    causal LM, for the fused cross-entropy and log-prob objectives: the
    head's weight transposed, which is the embedding table when the two
    are tied; the bias of a head that has one."""
    head = model.output_embeddings()
    return head.weight.t(), getattr(head, "bias", None)


@dataclass
class CLMConfig(BaseLMConfig):
    model: ModelProvider | None = None
    ignore_index: int = -100
    neftune_alpha: float | None = None
    log_perplexity: bool = True
    ce_chunk_size: int = 1024


class CLM(SingleModelObjective):
    """The CLM objective: owns the loss and metrics of a causal LM."""

    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        rng: prng.Key | None = None,
        train: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: input_ids [B, S]; optional labels (pre-shift), segment_ids,
        position_ids. `rng` is the step's key (NEFTune). Returns (mean loss
        fp32, metrics)."""
        cfg = self.config
        model = self.model
        input_ids = batch["input_ids"].long()
        labels = shift_labels(batch.get("labels", input_ids).long(), cfg.ignore_index)
        segment_ids = batch.get("segment_ids")
        position_ids = batch.get("position_ids")
        if segment_ids is not None:
            # no label crosses a packed document boundary or lands on padding
            next_seg = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], 1)
            valid = (segment_ids > 0) & (segment_ids == next_seg)
            labels = torch.where(valid, labels, cfg.ignore_index)

        inputs_embeds = None
        if train and cfg.neftune_alpha:
            # uniform noise on the input embeddings, scale alpha / sqrt(tokens * dim)
            table = model.model.embed_tokens.weight
            inputs_embeds = table[input_ids].to(model.config.compute_torch_dtype)
            if rng is None:
                raise ValueError("NEFTune needs the step's PRNG key")
            mag = cfg.neftune_alpha / math.sqrt(input_ids.shape[1] * inputs_embeds.shape[-1])
            noise = prng.uniform(rng, inputs_embeds.shape, inputs_embeds.dtype, -mag, mag,
                                 inputs_embeds.device)
            inputs_embeds = inputs_embeds + noise

        out = model(
            input_ids=None if inputs_embeds is not None else input_ids,
            segment_ids=segment_ids,
            position_ids=position_ids,
            inputs_embeds=inputs_embeds,
            compute_logits=False,
            return_last_hidden_states=True,
        )
        hidden = out.last_hidden_states
        head, bias = head_and_bias(model)
        total, count = fused_linear_cross_entropy(
            hidden, head.to(hidden.dtype), labels, ignore_index=cfg.ignore_index,
            chunk_size=cfg.ce_chunk_size, bias=bias,
            logits_soft_cap=getattr(model.config, "final_logit_softcapping", None),
        )
        loss = total / count.clamp_min(1).float()
        metrics = {"loss": loss.detach(), "target_tokens": count}
        if cfg.log_perplexity:
            metrics["perplexity"] = torch.exp(loss.detach())
        return loss, metrics
