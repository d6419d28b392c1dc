"""Bamba decoder (Mamba-2 SSD / attention hybrid), for training.

Counterpart of `llm_training_tpu/models/bamba/model.py`:

- the Mamba-2 mixer: one `in_proj` emits [gate | x, B, C | dt]; a depthwise
  causal conv (biased) with silu over x|B|C (its taps kept inside a
  document under `segment_state_reset`), padded tokens zeroed at the input
  and after the conv; dt = softplus(dt + dt_bias), A = -exp(A_log) a head;
  B and C per group, repeated over the heads; `mamba2_ssd`; the D skip on
  the raw x; the gated norm (x * silu(gate) first, then the weighted norm:
  Mamba-2's order) and `out_proj`;
- the attention layers (`attn_layer_indices`): GQA with rotary on the first
  half of each head (`moe_decoder.Attention`, K1-K3 on CUDA);
- every layer ends with `pre_ff_layernorm` and the SwiGLU `feed_forward`.

`mamba2_ssd` is JAX's chunked SSD in plain PyTorch, fp32, in JAX's order:
the in-chunk einsums batched over every chunk, then a Python loop over
chunks for JAX's `lax.scan` over the carried `[N, P]` state. As in the
DeltaNet's scan (`qwen3_next/model.py`), a masked entry of the in-chunk
decay matrix is exp(-inf), so a document start inside a chunk gives finite
gradients under `segment_state_reset`, where JAX's turn NaN (ROADMAP C.50).

Like JAX's, the forward takes no `decode_state`: the family does not decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models.bamba.config import BambaConfig
from llm_training_tpu_torch.models.llama.model import RMSNorm, _linear
from llm_training_tpu_torch.models.moe_decoder import (
    Attention,
    MoEFamilyLM,
    SwiGLU,
    linear,
    param,
)
from llm_training_tpu_torch.models.qwen3_next.model import (
    _pad_seq,
    _rms,
    causal_conv,
    masked_exp,
    prefix_sum,
    segment_reset_decay,
)


class MambaRMSNormGated(nn.Module):
    """Mamba-2's gated norm: x * silu(gate) first, then the RMS norm, then
    the weight, in fp32 (HF's BambaRMSNormGated)."""

    init_fill = {"weight": 1.0}

    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        x32 = x.float() * F.silu(gate.float())
        return (self.weight.float() * _rms(x32, self.eps)).to(x.dtype)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, chunk_size: int,
               reset_decay: torch.Tensor | None = None) -> torch.Tensor:
    """The chunked Mamba-2 SSD (HF torch_forward's naive branch), fp32: x
    `[B, S, H, P]` before discretisation, dt `[B, S, H]` after the softplus,
    a `[H]` the negative decay rates, B and C `[B, S, H, N]`, `reset_decay`
    `[B, S]` from `segment_reset_decay`. Returns `[B, S, H, P]` in x's
    dtype."""
    in_dtype = x.dtype
    x, dt, b_mat, c_mat = x.float(), dt.float(), b_mat.float(), c_mat.float()
    batch, seq, heads, p = x.shape
    xbar = x * dt[..., None]
    abar = a.float()[None, None, :] * dt  # [B, S, H]
    if reset_decay is not None:
        abar = abar + reset_decay.float()[..., None]
    c = chunk_size
    pad = (-seq) % c
    if pad:
        xbar, b_mat, c_mat, abar = (_pad_seq(t, pad) for t in (xbar, b_mat, c_mat, abar))
    nc = (seq + pad) // c

    def chunked(t):  # -> [nc, B, H, c, d]
        return t.reshape(batch, nc, c, heads, -1).permute(1, 0, 3, 2, 4)

    x_s, b_s, c_s = chunked(xbar), chunked(b_mat), chunked(c_mat)
    a_cs = prefix_sum(abar.reshape(batch, nc, c, heads).permute(1, 0, 3, 2))  # [nc, B, H, c]
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    # L_ij = exp(sum of abar over j+1..i) on the causal triangle
    l_mat = masked_exp(a_cs[..., :, None] - a_cs[..., None, :], tril)
    g_mat = c_s @ b_s.transpose(-1, -2)
    y_diag = (g_mat * l_mat) @ x_s

    decay_states = (a_cs[..., -1:] - a_cs).exp()  # [nc, B, H, c]
    states = (b_s * decay_states[..., None]).transpose(-1, -2) @ x_s  # [nc, B, H, N, P]
    chunk_decay = a_cs[..., -1].exp()  # [nc, B, H]
    carry = torch.zeros((batch, heads, b_s.shape[-1], p), dtype=torch.float32, device=x.device)
    prev_states = []
    for k in range(nc):
        prev_states.append(carry)
        carry = carry * chunk_decay[k][..., None, None] + states[k]
    prev = torch.stack(prev_states)
    y_off = (c_s * a_cs.exp()[..., None]) @ prev
    y = (y_diag + y_off).permute(1, 0, 3, 2, 4).reshape(batch, nc * c, heads, p)[:, :seq]
    return y.to(in_dtype)


class BambaMixer(nn.Module):
    """The Mamba-2 mixer (HF's BambaMixer, torch_forward); parameters in
    JAX's order and layouts (`conv_kernel [K, C]`)."""

    init_fill = {"A_log": 0.0, "dt_bias": 0.0, "D": 1.0, "conv_bias": 0.0}

    def __init__(self, config: BambaConfig, device=None):
        super().__init__()
        self.config = config
        cfg = config
        inter, conv_dim, heads = cfg.mamba_intermediate, cfg.mamba_conv_dim, cfg.mamba_n_heads
        self.in_proj = linear(cfg, cfg.hidden_size, inter + conv_dim + heads,
                              cfg.mamba_proj_bias, device)
        self.conv_kernel = param(cfg, cfg.mamba_d_conv, conv_dim, device=device)
        self.conv_bias = param(cfg, conv_dim, device=device) if cfg.mamba_conv_bias else None
        self.A_log = param(cfg, heads, device=device, dtype=torch.float32)
        self.dt_bias = param(cfg, heads, device=device, dtype=torch.float32)
        self.D = param(cfg, heads, device=device, dtype=torch.float32)
        self.norm = MambaRMSNormGated(inter, cfg.rms_norm_eps, cfg.param_torch_dtype, device)
        self.out_proj = linear(cfg, inter, cfg.hidden_size, cfg.mamba_proj_bias, device)

    def forward(self, hidden, pad_mask, segment_ids=None):
        cfg = self.config
        batch, seq, _ = hidden.shape
        inter, conv_dim = cfg.mamba_intermediate, cfg.mamba_conv_dim
        heads, p = cfg.mamba_n_heads, cfg.mamba_d_head
        groups, n = cfg.mamba_n_groups, cfg.mamba_d_state
        if pad_mask is not None:
            hidden = hidden * pad_mask[..., None].to(hidden.dtype)
        proj = _linear(hidden, self.in_proj)
        gate, xbc, dt = proj[..., :inter], proj[..., inter:inter + conv_dim], \
            proj[..., inter + conv_dim:]
        reset_on = cfg.segment_state_reset and segment_ids is not None
        conv = causal_conv(xbc, self.conv_kernel.to(xbc.dtype), segment_ids if reset_on else None)
        if self.conv_bias is not None:
            conv = conv + self.conv_bias.to(conv.dtype)
        xbc = F.silu(conv)
        if pad_mask is not None:
            xbc = xbc * pad_mask[..., None].to(xbc.dtype)
        x = xbc[..., :inter].reshape(batch, seq, heads, p)
        b_mat = xbc[..., inter:inter + groups * n].reshape(batch, seq, groups, n)
        c_mat = xbc[..., inter + groups * n:].reshape(batch, seq, groups, n)
        b_mat = b_mat.repeat_interleave(heads // groups, 2)
        c_mat = c_mat.repeat_interleave(heads // groups, 2)
        dt = F.softplus(dt.float() + self.dt_bias)
        y = mamba2_ssd(x, dt, -self.A_log.exp(), b_mat, c_mat, cfg.mamba_chunk_size,
                       reset_decay=segment_reset_decay(segment_ids) if reset_on else None)
        y = y + (self.D[None, None, :, None] * x.float()).to(y.dtype)
        y = self.norm(y.reshape(batch, seq, inter), gate)
        return _linear(y, self.out_proj)


class BambaDecoderLayer(nn.Module):
    """Pre-norm block: the mixer (`mamba`) or attention (`self_attn`), then
    `pre_ff_layernorm` and the SwiGLU `feed_forward`."""

    is_moe = False

    def __init__(self, config: BambaConfig, is_attention: bool, device=None):
        super().__init__()
        cfg, dtype = config, config.param_torch_dtype
        self.is_attention = is_attention
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        if is_attention:
            d = cfg.resolved_head_dim
            self.self_attn = Attention(
                cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
                head_dim=d, qkv_bias=cfg.attention_bias, out_bias=cfg.attention_bias,
                rotary_dim=int(d * cfg.partial_rotary_factor), device=device)
        else:
            self.mamba = BambaMixer(cfg, device)
        self.pre_ff_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.feed_forward = SwiGLU(cfg, cfg.intermediate_size, cfg.mlp_bias, device)

    def forward(self, hidden, segment_ids, cos, sin):
        normed = self.input_layernorm(hidden)
        if self.is_attention:
            hidden = hidden + self.self_attn(normed, segment_ids, cos, sin)
        else:
            pad_mask = None if segment_ids is None else segment_ids > 0
            hidden = hidden + self.mamba(normed, pad_mask, segment_ids)
        return hidden + self.feed_forward(self.pre_ff_layernorm(hidden))


class Bamba(MoEFamilyLM):
    """Bamba causal LM (dense: no router statistics, no aux loss)."""

    final_norm_name = "final_layernorm"

    def layer(self, i: int, device) -> nn.Module:
        return BambaDecoderLayer(self.config, self.config.layer_is_attention(i), device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return 0
