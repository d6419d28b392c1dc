"""Causal language modeling objective.

Counterpart of `llm_training_tpu/lms/clm.py`: the label shift, masking of
labels that would cross a packed document boundary or land on padding,
NEFTune noise on the input embeddings during training, the fused-linear
cross-entropy (full logits never materialise), and the metrics `loss`,
`target_tokens` and `perplexity`.

NEFTune draws from an explicit `torch.Generator`, so its noise differs
from `jax.random`'s for the same seed (by design, ROADMAP C).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider
from llm_training_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy, shift_labels


@dataclass
class CLMConfig(BaseLMConfig):
    model: ModelProvider | None = None
    ignore_index: int = -100
    neftune_alpha: float | None = None
    log_perplexity: bool = True
    ce_chunk_size: int = 1024


class CLM:
    """The CLM objective: owns the loss and metrics of a causal LM."""

    def __init__(self, config: CLMConfig, model: torch.nn.Module | None = None):
        self.config = config
        # a model handed in keeps its weights; one built from the config is
        # made by `configure_model` on the trainer's device
        self.model = model

    def configure_model(self, device: torch.device, generator: torch.Generator) -> torch.nn.Module:
        """The model on `device`: the one given, or one built from the
        config with random weights from `generator` (on `device`)."""
        if self.model is None:
            if self.config.model is None:
                raise ValueError("CLMConfig.model is required when no model is given")
            self.model = self.config.model.get_model(device)
            if self.config.init_weights:
                self.model.init_weights(generator)
        return self.model.to(device)

    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        generator: torch.Generator | None = None,
        train: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: input_ids [B, S]; optional labels (pre-shift), segment_ids,
        position_ids. Returns (mean loss fp32, metrics)."""
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
            mag = cfg.neftune_alpha / math.sqrt(input_ids.shape[1] * inputs_embeds.shape[-1])
            noise = torch.empty_like(inputs_embeds).uniform_(-mag, mag, generator=generator)
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
        head = model.output_embeddings().weight.to(hidden.dtype).t()
        total, count = fused_linear_cross_entropy(
            hidden, head, labels, ignore_index=cfg.ignore_index, chunk_size=cfg.ce_chunk_size,
        )
        loss = total / count.clamp_min(1).float()
        metrics = {"loss": loss.detach(), "target_tokens": count}
        if cfg.log_perplexity:
            metrics["perplexity"] = torch.exp(loss.detach())
        return loss, metrics
