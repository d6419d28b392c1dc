"""HunYuan V1 MoE decoder, for training.

Counterpart of `llm_training_tpu/models/hunyuan_moe/model.py`: dense
HunYuan's attention (per-head RMS qk-norm AFTER rotary) in a pre-norm
block, and a Mixtral-style MoE on every layer: an fp32 softmax router,
top-k (`moe.top_k`, JAX's tie order), renormalised, the dropless experts,
plus an always-on gate-free shared SwiGLU of the experts' width
(`shared_gate_proj`, `shared_up_proj`, `shared_down_proj`). No aux loss;
the router statistics go to the health layer.
"""

from __future__ import annotations

import torch
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.hunyuan_moe.config import HunYuanMoeConfig
from llm_training_tpu_torch.models.llama.model import _linear
from llm_training_tpu_torch.models.moe_decoder import (
    Attention,
    DecoderLayer,
    MoEFamilyLM,
    linear,
    param,
    swiglu_dense,
    swiglu_ragged,
)
from llm_training_tpu_torch.ops.swiglu import silu_mul


class HunYuanMoeBlock(nn.Module):
    def __init__(self, config: HunYuanMoeConfig, device=None):
        super().__init__()
        self.config = config
        e, h, i = config.num_experts, config.hidden_size, config.intermediate_size
        self.gate_kernel = param(config, h, e, device=device)
        self.experts_gate_proj = param(config, e, h, i, device=device)
        self.experts_up_proj = param(config, e, h, i, device=device)
        self.experts_down_proj = param(config, e, i, h, device=device)
        self.shared_gate_proj = linear(config, h, i, False, device)
        self.shared_up_proj = linear(config, h, i, False, device)
        self.shared_down_proj = linear(config, i, h, False, device)

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor | None = None):
        cfg = self.config
        cd = cfg.compute_torch_dtype
        batch, seq, embed = hidden.shape
        x = hidden.reshape(-1, embed)
        probs = torch.softmax(x.float() @ self.gate_kernel.float(), -1)
        weights, topk_idx = moe.top_k(probs, cfg.moe_topk)
        weights = weights / weights.sum(-1, keepdim=True)
        w = tuple(p.to(cd) for p in (self.experts_gate_proj, self.experts_up_proj,
                                      self.experts_down_proj))
        out, dropped = moe.dropless_moe_apply(
            x.to(cd), topk_idx, weights.to(cd), cfg.num_experts, cfg.moe_impl,
            lambda xc: swiglu_dense(xc, *w), swiglu_ragged, weights=w,
            ep_capacity_factor=cfg.ep_capacity_factor)
        out = out.reshape(batch, seq, embed).to(hidden.dtype)
        gate = _linear(hidden, self.shared_gate_proj)
        shared = _linear(silu_mul(gate, _linear(hidden, self.shared_up_proj)),
                         self.shared_down_proj)
        sel_frac, mean_prob = moe.router_block_stats(topk_idx, probs, cfg.num_experts, pad_mask)
        return out + shared, (sel_frac, mean_prob, dropped)


class HunYuanMoe(MoEFamilyLM):
    """HunYuan V1 MoE causal LM."""

    def layer(self, i: int, device) -> nn.Module:
        cfg = self.config
        d = cfg.resolved_head_dim
        attention = Attention(
            cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads, head_dim=d,
            qkv_bias=cfg.attention_bias, out_bias=cfg.attention_bias, rotary_dim=d,
            qk_norm="post", device=device)
        return DecoderLayer(cfg, attention, HunYuanMoeBlock(cfg, device), True, device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return self.config.num_experts
