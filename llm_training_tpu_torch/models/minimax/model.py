"""MiniMax decoder, for training.

Counterpart of `llm_training_tpu/models/minimax/model.py`:

- the layer stack (`layer_types`): lightning linear attention on most
  layers, softmax attention (GQA, rotary over the head, the config's
  window: `moe_decoder.Attention`, K1-K3 on CUDA) on the rest; every
  layer's MLP the Llama graph's `MoEMLP` (Mixtral's routing, G1 on CUDA)
  under HF's name `block_sparse_moe`;
- lightning attention: silu over `qkv_proj`, split per head; no softmax and
  no 1/sqrt(d); `lightning_attention` with each head's fixed decay slope
  (`slope_rate`: a geometric ladder scaled by the layer's ABSOLUTE index
  over the config's depth, so each layer module holds its own); v zeroed at
  padding; the output norm's eps is 1e-6 whatever `rms_norm_eps` is (HF
  hard-codes it), and the sigmoid output gate is computed from the block's
  input;
- the residual scheme: the input is normed first and the normed value is
  also the residual, hidden = normed * alpha + block(normed) * beta, with
  each kind's factors (attention, then the MoE);
- the load-balancing aux loss over the per-layer statistics pooled across
  depth (the CLM objective applies the coefficient).

`lightning_attention` is JAX's block-chunked scan in plain PyTorch, fp32,
a Python loop over blocks for JAX's `lax.scan` (XLA in JAX, so no kernel
here). Like JAX's and HF's, the state persists across packed documents.

Like JAX's, the forward takes no `decode_state`: the family does not decode.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.llama.model import RMSNorm, _linear
from llm_training_tpu_torch.models.minimax.config import MiniMaxConfig
from llm_training_tpu_torch.models.moe_decoder import Attention, MoEFamilyLM, linear
from llm_training_tpu_torch.models.qwen3_next.model import _pad_seq


def slope_rate(num_heads: int, layer_idx: int, num_layers: int) -> np.ndarray:
    """Each head's fixed decay slope `[H]` fp32 (HF's get_slope_rate)."""
    base = 1.0 / (2.0 ** (8.0 / num_heads))
    rate = base ** (np.arange(num_heads) + 1)
    factor = 1.0 - layer_idx / (num_layers - 1 + 1e-5) + 1e-5
    return (rate * factor).astype(np.float32)


def lightning_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slope: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """Block-chunked linear attention with exponential decay, fp32: q, k, v
    `[B, S, H, d]`, `slope [H]`. Per block: intra = (QK^T * the pairwise
    decay) V, inter = (Q * the query decay) S, and the state S updates as
    exp(-slope * block) S + (K * the key decay)^T V. Returns `[B, S, H, d]`
    in q's dtype."""
    in_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    batch, seq, heads, d = q.shape
    c = block_size
    pad = (-seq) % c
    if pad:
        q, k, v = (_pad_seq(x, pad) for x in (q, k, v))
    nc = (seq + pad) // c

    def chunked(x):  # -> [nc, B, H, c, d]
        return x.reshape(batch, nc, c, heads, d).permute(1, 0, 3, 2, 4)

    q_s, k_s, v_s = chunked(q), chunked(k), chunked(v)
    pos = torch.arange(c, dtype=torch.float32, device=q.device) + 1.0
    sl = slope.float()[:, None]  # [H, 1]
    query_decay = (-sl * pos[None, :]).exp()[:, :, None]  # [H, c, 1]
    key_decay = (-sl * (c - pos)[None, :]).exp()[:, :, None]
    diff = pos[:, None] - pos[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    diag_decay = torch.where(diff >= 0, (-sl[..., None] * diff[None]).exp(), zero)  # [H, c, c]
    block_decay = (-slope.float() * c).exp()[None, :, None, None]
    state = torch.zeros((batch, heads, d, d), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nc):
        q_i, k_i, v_i = q_s[i], k_s[i], v_s[i]  # [B, H, c, d]
        intra = ((q_i @ k_i.transpose(-1, -2)) * diag_decay[None]) @ v_i
        inter = (q_i * query_decay[None]) @ state
        outs.append(intra + inter)
        state = state * block_decay + (k_i * key_decay[None]).transpose(-1, -2) @ v_i
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(batch, nc * c, heads, d)
    return out[:, :seq].to(in_dtype)


class LightningAttention(nn.Module):
    """The linear-attention block of layer `layer_idx` (HF's
    MiniMaxLightningAttention)."""

    def __init__(self, config: MiniMaxConfig, layer_idx: int, device=None):
        super().__init__()
        self.config = config
        cfg, h = config, config.hidden_size
        width = cfg.num_attention_heads * cfg.resolved_head_dim
        self.qkv_proj = linear(cfg, h, 3 * width, False, device)
        self.norm = RMSNorm(width, 1e-6, cfg.param_torch_dtype, device)
        self.output_gate = linear(cfg, h, width, False, device)
        self.out_proj = linear(cfg, width, h, False, device)
        self.slope = slope_rate(cfg.num_attention_heads, layer_idx, cfg.num_hidden_layers)

    def forward(self, hidden, pad_mask):
        cfg = self.config
        batch, seq, _ = hidden.shape
        heads, d = cfg.num_attention_heads, cfg.resolved_head_dim
        qkv = F.silu(_linear(hidden, self.qkv_proj)).reshape(batch, seq, heads, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        if pad_mask is not None:  # padding writes nothing into the state
            v = v * pad_mask[..., None, None].to(v.dtype)
        out = lightning_attention(q, k, v, torch.as_tensor(self.slope, device=q.device),
                                  cfg.block_size)
        out = self.norm(out.reshape(batch, seq, heads * d))
        gate = _linear(hidden, self.output_gate)
        out = torch.sigmoid(gate.float()).to(out.dtype) * out
        return _linear(out, self.out_proj)


class MiniMaxDecoderLayer(nn.Module):
    """The normed input is the residual: hidden = normed * alpha +
    block(normed) * beta, for the attention and then the MoE."""

    is_moe = True

    def __init__(self, config: MiniMaxConfig, layer_idx: int, device=None):
        super().__init__()
        self.config = config
        cfg, dtype = config, config.param_torch_dtype
        self.is_linear = cfg.layer_is_linear(layer_idx)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        if self.is_linear:
            self.self_attn = LightningAttention(cfg, layer_idx, device)
        else:
            d = cfg.resolved_head_dim
            self.self_attn = Attention(
                cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads, head_dim=d,
                qkv_bias=cfg.attention_bias, out_bias=cfg.attention_bias, rotary_dim=d,
                window=cfg.sliding_window, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.block_sparse_moe = moe.MoEMLP(cfg, device)

    def forward(self, hidden, segment_ids, cos, sin):
        cfg = self.config
        pad_mask = None if segment_ids is None else segment_ids > 0
        hidden = self.input_layernorm(hidden)
        if self.is_linear:
            attn = self.self_attn(hidden, pad_mask)
            alpha, beta = cfg.linear_attn_alpha_factor, cfg.linear_attn_beta_factor
        else:
            attn = self.self_attn(hidden, segment_ids, cos, sin)
            alpha, beta = cfg.full_attn_alpha_factor, cfg.full_attn_beta_factor
        hidden = hidden * alpha + attn * beta
        hidden = self.post_attention_layernorm(hidden)
        out, stats = self.block_sparse_moe(hidden, pad_mask)
        return hidden * cfg.mlp_alpha_factor + out * cfg.mlp_beta_factor, stats


class MiniMax(MoEFamilyLM):
    """MiniMax causal LM."""

    has_aux_loss = True

    def layer(self, i: int, device) -> nn.Module:
        return MiniMaxDecoderLayer(self.config, i, device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return self.config.num_experts
