"""gpt-oss decoder, for training.

Counterpart of `llm_training_tpu/models/gpt_oss/model.py`:

- attention: GQA with biased q/k/v/o, per-head learned sinks (through K1-K3
  on CUDA, the plain path's extra softmax column on the CPU), a 128-token
  window on alternating layers, yarn rotary without truncation;
- MoE on every layer: a biased router, top-k on the logits (`moe.top_k`,
  JAX's tie order), a softmax over the k chosen; the experts' fused
  gate_up stack `[E, H, 2I]` whose gate and up COLUMNS interleave
  (`[..., ::2]` / `[..., 1::2]`), with per-expert biases gathered by row
  after each G1 product on the ragged path; the activation clamps gate
  above at 7 and up to [-7, 7] with JAX's gradient at the limits (0.5:
  `torch.minimum` / `torch.maximum` split a tie, `torch.clamp` does not),
  then (up + 1) * gate * sigmoid(1.702 gate);
- the load-balancing aux loss over the per-layer statistics pooled across
  depth (the CLM objective applies `router_aux_loss_coef`).
"""

from __future__ import annotations

import torch
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.gpt_oss.config import GptOssConfig
from llm_training_tpu_torch.models.llama.model import _linear
from llm_training_tpu_torch.models.moe_decoder import (
    Attention,
    DecoderLayer,
    MoEFamilyLM,
    linear,
    param,
)
from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg

ALPHA = 1.702
LIMIT = 7.0


def clip(x: torch.Tensor, low: float | None, high: float) -> torch.Tensor:
    """`jnp.clip` with its gradient: 0.5 at an element equal to a limit."""
    if low is not None:
        x = torch.maximum(x, x.new_tensor(low))
    return torch.minimum(x, x.new_tensor(high))


def expert_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    gate = clip(gate, None, LIMIT)
    up = clip(up, -LIMIT, LIMIT)
    return (up + 1.0) * (gate * torch.sigmoid(ALPHA * gate))


class GptOssMoE(nn.Module):
    """Router + fused clamped-SwiGLU experts with per-expert biases."""

    def __init__(self, config: GptOssConfig, device=None):
        super().__init__()
        self.config = config
        e, h, i = config.num_local_experts, config.hidden_size, config.intermediate_size
        self.router = linear(config, h, e, True, device)
        self.experts_gate_up_proj = param(config, e, h, 2 * i, device=device)
        self.experts_gate_up_proj_bias = param(config, e, 2 * i, device=device)
        self.experts_down_proj = param(config, e, i, h, device=device)
        self.experts_down_proj_bias = param(config, e, h, device=device)

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor | None = None):
        cfg = self.config
        num_experts = cfg.num_local_experts
        cd = cfg.compute_torch_dtype
        batch, seq, embed = hidden.shape
        x = hidden.reshape(-1, embed)
        logits = _linear(x.to(cd), self.router).float()
        topk_logits, topk_idx = moe.top_k(logits, cfg.num_experts_per_tok)
        # a softmax over the k chosen logits only
        topk_weights = torch.softmax(topk_logits, -1).to(cd)
        w = tuple(p.to(cd) for p in (self.experts_gate_up_proj, self.experts_gate_up_proj_bias,
                                      self.experts_down_proj, self.experts_down_proj_bias))

        def dense_fn(xc):
            wgu, bgu, wd, bd = w
            fused = torch.einsum("th,ehi->tei", xc, wgu) + bgu[None]
            act = expert_act(fused[..., ::2], fused[..., 1::2])
            return torch.einsum("tei,eih->teh", act, wd) + bd[None]

        def ragged_fn(xs, offsets, expert_order, weights):
            wgu, bgu, wd, bd = weights
            fused = gg.grouped_gemm(xs, wgu, offsets) + bgu[expert_order]
            ys = gg.grouped_gemm(expert_act(fused[..., ::2], fused[..., 1::2]), wd, offsets)
            return ys + bd[expert_order]

        out, dropped = moe.dropless_moe_apply(
            x.to(cd), topk_idx, topk_weights, num_experts, cfg.moe_impl, dense_fn, ragged_fn,
            weights=w, ep_capacity_factor=cfg.ep_capacity_factor)
        sel_frac, mean_prob = moe.router_block_stats(topk_idx, torch.softmax(logits, -1),
                                                     num_experts, pad_mask)
        return out.reshape(batch, seq, embed).to(hidden.dtype), (sel_frac, mean_prob, dropped)


class GptOss(MoEFamilyLM):
    """gpt-oss causal LM."""

    has_aux_loss = True

    def layer(self, i: int, device) -> nn.Module:
        cfg = self.config
        attention = Attention(
            cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, qkv_bias=cfg.attention_bias, out_bias=cfg.attention_bias,
            rotary_dim=cfg.head_dim, sinks=True, window=cfg.layer_sliding_window(i),
            device=device)
        return DecoderLayer(cfg, attention, GptOssMoE(cfg, device), True, device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return self.config.num_local_experts
