"""ERNIE-4.5-MoE decoder, for training.

Counterpart of `llm_training_tpu/models/ernie45_moe/model.py`: dense
ERNIE's attention (interleaved full rotary, `use_bias` over q/k/v/o) in a
pre-norm block, and `Ernie45MoeBlock`: an fp32 softmax router that SELECTS
on probabilities plus `e_score_correction_bias` (through `moe.top_k`, JAX's
tie order) while the combine takes the raw chosen probabilities,
renormalised with the `moe_norm_min` clamp; the dropless experts (biased
with `use_bias`, each bias gathered by row after its G1 product) and the
gate-free shared experts. Layers off the MoE grid take the dense MLP. A
biased config carries `lm_head_bias`, real even when the head is tied.
No aux loss; the router statistics go to the health layer.
"""

from __future__ import annotations

import torch
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.ernie45_moe.config import Ernie45MoeConfig
from llm_training_tpu_torch.models.moe_decoder import (
    Attention,
    DecoderLayer,
    MoEFamilyLM,
    SwiGLU,
    param,
)
from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg
from llm_training_tpu_torch.ops.swiglu import silu_mul


class Ernie45MoeBlock(nn.Module):
    def __init__(self, config: Ernie45MoeConfig, device=None):
        super().__init__()
        self.config = config
        e, h, i = config.moe_num_experts, config.hidden_size, config.moe_intermediate_size
        self.gate_kernel = param(config, h, e, device=device)
        self.e_score_correction_bias = param(config, e, device=device, dtype=torch.float32)
        self.experts_gate_proj = param(config, e, h, i, device=device)
        self.experts_up_proj = param(config, e, h, i, device=device)
        self.experts_down_proj = param(config, e, i, h, device=device)
        if config.use_bias:
            self.experts_gate_proj_bias = param(config, e, i, device=device)
            self.experts_up_proj_bias = param(config, e, i, device=device)
            self.experts_down_proj_bias = param(config, e, h, device=device)
        if config.moe_num_shared_experts:
            self.shared_experts = SwiGLU(config, i * config.moe_num_shared_experts,
                                         bias=config.use_bias, device=device)

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor | None = None):
        cfg = self.config
        num_experts = cfg.moe_num_experts
        cd = cfg.compute_torch_dtype
        batch, seq, embed = hidden.shape
        x = hidden.reshape(-1, embed)
        probs = torch.softmax(x.float() @ self.gate_kernel.float(), -1)
        _, topk_idx = moe.top_k(probs + self.e_score_correction_bias.detach(), cfg.moe_k)
        weights = probs.gather(1, topk_idx)
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(cfg.moe_norm_min)
        names = ("experts_gate_proj", "experts_up_proj", "experts_down_proj")
        if cfg.use_bias:
            names += ("experts_gate_proj_bias", "experts_up_proj_bias", "experts_down_proj_bias")
        w = tuple(getattr(self, n).to(cd) for n in names)

        def dense_fn(xc):
            gate = torch.einsum("th,ehi->tei", xc, w[0])
            up = torch.einsum("th,ehi->tei", xc, w[1])
            if cfg.use_bias:
                gate, up = gate + w[3][None], up + w[4][None]
            out = torch.einsum("tei,eih->teh", silu_mul(gate, up), w[2])
            return out + w[5][None] if cfg.use_bias else out

        def ragged_fn(xs, offsets, expert_order, weights):
            gate = gg.grouped_gemm(xs, weights[0], offsets)
            up = gg.grouped_gemm(xs, weights[1], offsets)
            if cfg.use_bias:
                gate = gate + weights[3][expert_order]
                up = up + weights[4][expert_order]
            out = gg.grouped_gemm(silu_mul(gate, up), weights[2], offsets)
            return out + weights[5][expert_order] if cfg.use_bias else out

        out, dropped = moe.dropless_moe_apply(
            x.to(cd), topk_idx, weights.to(cd), num_experts, cfg.moe_impl, dense_fn, ragged_fn,
            weights=w, ep_capacity_factor=cfg.ep_capacity_factor)
        out = out.reshape(batch, seq, embed).to(hidden.dtype)
        if cfg.moe_num_shared_experts:
            out = out + self.shared_experts(hidden)
        sel_frac, mean_prob = moe.router_block_stats(topk_idx, probs, num_experts, pad_mask)
        return out, (sel_frac, mean_prob, dropped)


class Ernie45Moe(MoEFamilyLM):
    """ERNIE-4.5-MoE causal LM."""

    @property
    def head_bias(self) -> bool:
        return self.config.use_bias

    def layer(self, i: int, device) -> nn.Module:
        cfg = self.config
        d = cfg.resolved_head_dim
        attention = Attention(
            cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads, head_dim=d,
            qkv_bias=cfg.use_bias, out_bias=cfg.use_bias, rotary_dim=d, interleaved=True,
            device=device)
        is_moe = cfg.layer_is_moe(i)
        mlp = (Ernie45MoeBlock(cfg, device) if is_moe
               else SwiGLU(cfg, cfg.intermediate_size, bias=cfg.use_bias, device=device))
        return DecoderLayer(cfg, attention, mlp, is_moe, device)

    def rope_setup(self):
        return self.config.rope_config, True

    @property
    def num_routed_experts(self) -> int:
        return self.config.moe_num_experts
