"""DeepSeek V2/V3 decoder, for training.

Counterpart of `llm_training_tpu/models/deepseek/model.py`, with its graph:

- MLA (multi-head latent attention): q through an optional LoRA (q_a_proj,
  RMSNorm, q_b_proj), k and v through a compressed latent
  (kv_a_proj_with_mqa, split into the latent and one rope head, RMSNorm,
  kv_b_proj). A head's q and k are [nope | rope]; k's rope part is one
  head broadcast over the q heads (autograd sums its gradient over them),
  rotated with interleaved pairs (`rope_interleave`). v is zero-padded to
  the qk head dim for the attention and sliced back (the padded columns
  get zero weight); at qk 192 the flash kernels' wrapper pads that to 256.
  The scale is `attention_scale` (yarn's squared mscale).
- `DeepseekMoE`: the fp32 router (v3: sigmoid scores, selection on scores
  plus the correction bias, top-2-sum group selection; v2: softmax, greedy
  or group-limited greedy), every top-k through `moe.top_k` (JAX's tie
  order), the dropless experts (`moe.dropless_moe_apply`: G1 on CUDA),
  always-on shared experts and `routed_scaling_factor`. No aux loss, as in
  JAX; the router statistics go to the health layer (v3's sigmoid scores
  normalised per token first).
- layers [0, first_k_dense_replace) take the dense MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.deepseek.config import DeepseekConfig
from llm_training_tpu_torch.models.llama.model import RMSNorm, _linear
from llm_training_tpu_torch.models.moe_decoder import (
    DecoderLayer,
    MoEFamilyLM,
    SwiGLU,
    linear,
    param,
    swiglu_dense,
    swiglu_ragged,
)
from llm_training_tpu_torch.ops.attention import dot_product_attention
from llm_training_tpu_torch.ops.rope import apply_rope


class MLAttention(nn.Module):
    def __init__(self, config: DeepseekConfig, device=None):
        super().__init__()
        self.config = config
        cfg, h = config, config.hidden_size
        heads, dtype = cfg.num_attention_heads, cfg.param_torch_dtype
        if cfg.q_lora_rank is None:
            self.q_proj = linear(cfg, h, heads * cfg.qk_head_dim, False, device)
        else:
            self.q_a_proj = linear(cfg, h, cfg.q_lora_rank, cfg.attention_bias, device)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps, dtype, device)
            self.q_b_proj = linear(cfg, cfg.q_lora_rank, heads * cfg.qk_head_dim, False, device)
        self.kv_a_proj_with_mqa = linear(cfg, h, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                         cfg.attention_bias, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dtype, device)
        self.kv_b_proj = linear(cfg, cfg.kv_lora_rank,
                                heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), False, device)
        self.o_proj = linear(cfg, heads * cfg.v_head_dim, h, cfg.attention_bias, device)

    def forward(self, hidden, segment_ids, cos, sin):
        cfg = self.config
        batch, seq, _ = hidden.shape
        heads, qk_dim, nope = cfg.num_attention_heads, cfg.qk_head_dim, cfg.qk_nope_head_dim
        if cfg.q_lora_rank is None:
            q = _linear(hidden, self.q_proj)
        else:
            q = _linear(self.q_a_layernorm(_linear(hidden, self.q_a_proj)), self.q_b_proj)
        q = q.reshape(batch, seq, heads, qk_dim)
        q_nope, q_rot = q[..., :nope], q[..., nope:]
        compressed = _linear(hidden, self.kv_a_proj_with_mqa)
        latent = self.kv_a_layernorm(compressed[..., :cfg.kv_lora_rank])
        k_rot = compressed[..., cfg.kv_lora_rank:][:, :, None, :]
        kv = _linear(latent, self.kv_b_proj).reshape(batch, seq, heads, nope + cfg.v_head_dim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        q_rot, k_rot = apply_rope(q_rot, k_rot, cos, sin, interleaved=cfg.rope_interleave)
        k_rot = k_rot.expand(batch, seq, heads, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_rot], -1)
        k = torch.cat([k_nope, k_rot], -1)
        v = F.pad(v, (0, qk_dim - cfg.v_head_dim))
        out = dot_product_attention(q, k, v, segment_ids=segment_ids, causal=True,
                                    scale=cfg.attention_scale, impl=cfg.attention_impl)
        out = out[..., :cfg.v_head_dim].to(hidden.dtype).reshape(batch, seq, -1)
        return _linear(out, self.o_proj)


class DeepseekMoE(nn.Module):
    """Router + dropless experts + always-on shared experts. `forward(hidden
    [B, S, H], pad_mask)` returns (out, (sel_frac [E], mean_prob [E],
    dropped)). GLM-4.5 uses it as it is."""

    def __init__(self, config, device=None):
        super().__init__()
        self.config = config
        e, h, i = config.n_routed_experts, config.hidden_size, config.moe_intermediate_size
        self.gate_kernel = param(config, h, e, device=device)
        if config.version == 3:
            self.e_score_correction_bias = param(config, e, device=device, dtype=torch.float32)
        self.experts_gate_proj = param(config, e, h, i, device=device)
        self.experts_up_proj = param(config, e, h, i, device=device)
        self.experts_down_proj = param(config, e, i, h, device=device)
        self.shared_experts = SwiGLU(config, i * config.n_shared_experts, device=device)

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores [T, E] fp32, topk_idx [T, K], topk_weights [T, K] fp32)."""
        cfg = self.config
        num_experts = cfg.n_routed_experts
        logits = x.float() @ self.gate_kernel.float()
        if cfg.version == 3:
            scores = torch.sigmoid(logits)
            # selection sees scores + bias, the combine the raw scores; no
            # gradient reaches the bias (HF's buffer)
            choice = scores + self.e_score_correction_bias.detach()
        else:
            scores = torch.softmax(logits, -1)
            choice = scores
        if cfg.n_group and (cfg.version == 3 or cfg.topk_method == "group_limited_greedy"):
            groups = cfg.n_group
            per_group = choice.reshape(len(choice), groups, num_experts // groups)
            if cfg.version == 3:
                group_scores = moe.top_k(per_group, 2)[0].sum(-1)
            else:
                group_scores = per_group.amax(-1)
            _, group_idx = moe.top_k(group_scores, cfg.topk_group)
            mask = torch.zeros_like(group_scores).scatter(1, group_idx, 1.0)
            mask = mask.repeat_interleave(num_experts // groups, -1)
            choice = torch.where(mask > 0, choice, 0.0)
        _, topk_idx = moe.top_k(choice, cfg.num_experts_per_tok)
        weights = scores.gather(1, topk_idx)
        if cfg.version == 3 and cfg.norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return scores, topk_idx, weights * cfg.routed_scaling_factor

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor | None = None):
        cfg = self.config
        num_experts = cfg.n_routed_experts
        cd = cfg.compute_torch_dtype
        batch, seq, embed = hidden.shape
        x = hidden.reshape(-1, embed)
        scores, topk_idx, weights = self.route(x)
        w = tuple(p.to(cd) for p in (self.experts_gate_proj, self.experts_up_proj,
                                      self.experts_down_proj))
        out, dropped = moe.dropless_moe_apply(
            x.to(cd), topk_idx, weights.to(cd), num_experts, cfg.moe_impl,
            lambda xc: swiglu_dense(xc, *w), swiglu_ragged, weights=w,
            ep_capacity_factor=cfg.ep_capacity_factor)
        out = out.reshape(batch, seq, embed).to(hidden.dtype)
        if cfg.version == 3:
            scores = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
        sel_frac, mean_prob = moe.router_block_stats(topk_idx, scores, num_experts, pad_mask)
        return out + self.shared_experts(hidden), (sel_frac, mean_prob, dropped)


class Deepseek(MoEFamilyLM):
    """DeepSeek V2/V3 causal LM."""

    def layer(self, i: int, device) -> nn.Module:
        cfg = self.config
        is_moe = cfg.layer_is_moe(i)
        mlp = (DeepseekMoE(cfg, device) if is_moe
               else SwiGLU(cfg, cfg.intermediate_size, device=device))
        return DecoderLayer(cfg, MLAttention(cfg, device), mlp, is_moe, device)

    def rope_setup(self):
        return self.config.rope_config, self.config.rope_interleave

    @property
    def num_routed_experts(self) -> int:
        return self.config.n_routed_experts
