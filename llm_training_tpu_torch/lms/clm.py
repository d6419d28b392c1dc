"""Causal language modeling objective.

Counterpart of `llm_training_tpu/lms/clm.py`: the label shift, masking of
labels that would cross a packed document boundary or land on padding,
NEFTune noise on the input embeddings during training, the fused-linear
cross-entropy (full logits never materialise), and the metrics `loss`,
`target_tokens` and `perplexity`; for an MoE model the load-balancing loss
(`router_aux_loss_coef * aux_loss` added to the loss, `aux_loss` and
`ep_dropped_rows` reported, and with `with_health` the router's
`health/moe/*` metrics; on a mesh the router statistics are pooled over
the batch's ranks first, as JAX's are global); `head_and_bias`, the head of the fused objectives
(CLM, DPO, ORPO).

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
from llm_training_tpu_torch.models.base import RouterStats
from llm_training_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy, shift_labels
from llm_training_tpu_torch.parallel.batch import batch_group, batch_sum
from llm_training_tpu_torch.telemetry.health import moe_router_health


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

    def global_labels(self, batch: dict) -> torch.Tensor:
        """The targets of a (global) batch: `labels` (else `input_ids`)
        shifted, ignored where they would cross a packed document boundary
        or land on padding."""
        cfg = self.config
        as_t = torch.as_tensor
        labels = shift_labels(as_t(batch.get("labels", batch["input_ids"])).long(),
                              cfg.ignore_index)
        segment_ids = batch.get("segment_ids")
        if segment_ids is not None:
            segment_ids = as_t(segment_ids)
            next_seg = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], 1)
            valid = (segment_ids > 0) & (segment_ids == next_seg)
            labels = torch.where(valid, labels, cfg.ignore_index)
        return labels

    def loss_and_metrics(
        self,
        batch: dict[str, torch.Tensor],
        rng: prng.Key | None = None,
        train: bool = True,
        with_health: bool = False,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: input_ids [B, S]; optional labels (pre-shift), segment_ids,
        position_ids. `rng` is the step's key (NEFTune). `with_health` (the
        trainer's health steps) adds an MoE model's `health/moe/*` metrics.
        Returns (mean loss fp32, metrics)."""
        cfg = self.config
        model = self.model
        input_ids = batch["input_ids"].long()
        # on a sequence-sharded mesh the labels were shifted on the global batch
        labels = batch.get("shifted_labels")
        labels = self.global_labels(batch) if labels is None else labels.long()
        segment_ids = batch.get("segment_ids")
        position_ids = batch.get("position_ids")
        # a mesh rank holds a block of the global batch: NEFTune's noise and
        # its scale are the global batch's, and RoPE selects by the global width
        shard = getattr(batch, "shard", None)
        global_seq = shard.global_seq if shard is not None else input_ids.shape[1]

        embeds_noise = None
        if train and cfg.neftune_alpha:
            if rng is None:
                raise ValueError("NEFTune needs the step's PRNG key")

            def embeds_noise(embeds: torch.Tensor) -> torch.Tensor:
                # uniform noise on the input embeddings, scale alpha / sqrt(tokens * dim);
                # a mesh rank draws its own block of the global batch's noise
                mag = cfg.neftune_alpha / math.sqrt(global_seq * embeds.shape[-1])
                shape, block = embeds.shape, None
                if shard is not None:
                    shape = (shard.global_rows, shard.global_seq, shape[-1])
                    block = (shard.rows, shard.seq)
                noise = prng.uniform(rng, shape, embeds.dtype, -mag, mag, embeds.device, block)
                return embeds + noise

        out = model(
            input_ids=input_ids,
            segment_ids=segment_ids,
            position_ids=position_ids,
            compute_logits=False,
            return_last_hidden_states=True,
            embeds_noise=embeds_noise,
            rope_length=global_seq,
        )
        hidden = out.last_hidden_states
        head, bias = head_and_bias(model)
        total, count = fused_linear_cross_entropy(
            hidden, head.to(hidden.dtype), labels, ignore_index=cfg.ignore_index,
            chunk_size=cfg.ce_chunk_size, bias=bias,
            logits_soft_cap=getattr(model.config, "final_logit_softcapping", None),
        )
        # the global batch's mean and token count on every rank of a mesh
        count = batch_sum(count)
        loss = batch_sum(total) / count.clamp_min(1).float()
        metrics = {"loss": loss.detach(), "target_tokens": count}
        if cfg.log_perplexity:
            # the token-level cross entropy's only, never the MoE penalty's
            metrics["perplexity"] = torch.exp(loss.detach())
        router, aux_loss = out.router_stats, out.aux_loss
        if router is not None and batch_group() is not None:
            router, aux_loss = _global_router_stats(router, segment_ids, input_ids,
                                                    model.config.num_experts)
        if aux_loss is not None:
            # the model returns it unscaled; the coefficient is the config's
            loss = loss + model.config.router_aux_loss_coef * aux_loss
            metrics["aux_loss"] = aux_loss.detach()
            metrics["loss"] = loss.detach()
        if out.ep_dropped_rows is not None:
            metrics["ep_dropped_rows"] = out.ep_dropped_rows.detach()
        if with_health and router is not None:
            # the global batch's tokens, as JAX's dropped fraction counts them
            group = batch_group()
            ways = 1 if group is None else torch.distributed.get_world_size(group)
            health = moe_router_health(router, n_tokens=labels.numel() * ways)
            metrics.update({k: v.detach() for k, v in health.items()})
        return loss, metrics


def _global_router_stats(router: RouterStats, segment_ids, input_ids,
                         num_experts: int) -> tuple[RouterStats, torch.Tensor]:
    """A mesh rank's router statistics pooled over the batch's ranks, each
    weighted by its counted tokens (the model's pad mask: segment id > 0),
    and the aux loss of the pooled ones: JAX computes both over the global
    batch, and a mean of per-rank products would be another loss."""
    if segment_ids is None:
        counted = torch.tensor(float(input_ids.numel()), device=router.sel_frac.device)
    else:
        counted = (torch.as_tensor(segment_ids) > 0).sum().float().to(router.sel_frac.device)
    total = batch_sum(counted).clamp_min(1.0)
    sel_frac = batch_sum(router.sel_frac * counted) / total
    mean_prob = batch_sum(router.mean_prob * counted) / total
    aux_loss = num_experts * (sel_frac.mean(0) * mean_prob.mean(0)).sum()
    # the dropped count is the global batch's already (`moe._bucketed_apply`)
    return RouterStats(sel_frac=sel_frac, mean_prob=mean_prob,
                       dropped=router.dropped, layer_ids=router.layer_ids), aux_loss
