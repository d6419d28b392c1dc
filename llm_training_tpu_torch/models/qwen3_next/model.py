"""Qwen3-Next decoder, for training.

Counterpart of `llm_training_tpu/models/qwen3_next/model.py`:

- the layer stack: gated DeltaNet linear attention on most layers, gated
  softmax attention on the rest (`layer_is_linear`), every layer's MLP the
  Llama graph's qwen-style `MoEMLP` (G1 on CUDA) or, without experts, the
  dense SwiGLU;
- gated attention: `q_proj` emits [q | gate] per head, zero-centred (1 + w)
  qk-norms, rotary on the first `partial_rotary_factor` of each head, the
  attention (K1-K3 on CUDA), then sigmoid(gate) on its output;
- gated DeltaNet: the fused `in_proj_qkvz` / `in_proj_ba` in HF's per-k-head
  interleave, a depthwise causal conv with silu over q|k|v (its taps kept
  inside a document under `segment_state_reset`), the per-head decay
  g = -exp(A_log) * softplus(a + dt_bias) and write strength sigmoid(b),
  the k heads repeated over the value groups, `chunk_gated_delta_rule`, and
  the gated norm norm(x) * w * silu(z);
- the load-balancing aux loss over the per-layer statistics pooled across
  depth, as JAX computes it (the CLM objective applies the coefficient).

`chunk_gated_delta_rule` is JAX's chunked scan in plain PyTorch, fp32, in
JAX's order: one unit-lower-triangular solve a chunk, then a Python loop
over chunks for JAX's `lax.scan`. JAX is no kernel there (XLA einsums), so
neither is the port. One difference: a masked entry of a decay matrix is
exp(-inf) here, where JAX takes exp() of the unmasked difference and masks
the result; the values are the same, but under `segment_state_reset` a
document start inside a chunk makes JAX's masked exp() overflow and its
backward multiply 0 by inf, so JAX's gradients turn NaN there while the
port's stay finite (ROADMAP C.50).

Like JAX's, the forward takes no `decode_state`: the family does not decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models import moe
from llm_training_tpu_torch.models.llama.model import _linear
from llm_training_tpu_torch.models.moe_decoder import MoEFamilyLM, SwiGLU, linear, param
from llm_training_tpu_torch.models.qwen3_next.config import Qwen3NextConfig
from llm_training_tpu_torch.ops.attention import dot_product_attention
from llm_training_tpu_torch.ops.rope import apply_rope


def _rms(x32: torch.Tensor, eps: float) -> torch.Tensor:
    return x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)


class ZeroCenteredRMSNorm(nn.Module):
    """(1 + w) RMSNorm with fp32 statistics, the product taken before the
    downcast (HF's Qwen3NextRMSNorm); w starts at zero."""

    init_fill = {"weight": 0.0}

    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (_rms(x.float(), self.eps) * (1.0 + self.weight.float())).to(x.dtype)


class GatedRMSNorm(nn.Module):
    """norm(x) * w * silu(z): the weighted norm rounded to x's dtype, then
    the gate in fp32 (HF's Qwen3NextRMSNormGated)."""

    init_fill = {"weight": 1.0}

    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        out = (self.weight.float() * _rms(x.float(), self.eps)).to(x.dtype)
        return (out.float() * F.silu(gate.float())).to(x.dtype)


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps)


RESET_LOG_DECAY = -1e4  # exp() of it is exactly 0.0 in fp32


def segment_reset_decay(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] fp32 extra log-decay: `RESET_LOG_DECAY` at each document's
    start (a segment id unlike its left neighbour's), else 0. Added to a
    recurrence's log-decay, every product of decays across a boundary
    underflows to 0, an exact state reset."""
    prev = torch.cat([segment_ids[:, :1], segment_ids[:, :-1]], 1)
    zero = torch.zeros((), dtype=torch.float32, device=segment_ids.device)
    return torch.where(segment_ids != prev, zero + RESET_LOG_DECAY, zero)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """The cumulative sum over the last dim as JAX's `cumsum` computes it
    on the CPU (XLA's reduce-window): each prefix added left to right in
    fp32. torch's CPU `cumsum` accumulates in double, which rounds apart by
    up to ~1e-3 once a document start's -1e4 log-decay joins the sum."""
    sums = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        sums.append(sums[-1] + x[..., i])
    return torch.stack(sums, -1)


def masked_exp(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(x) where `mask`, else 0: exp(-inf) off the mask, so its backward
    never meets an overflowed exp() (JAX's `where(mask, exp(x), 0)` gives
    the same values)."""
    return torch.exp(x.masked_fill(~mask, float("-inf")))


def causal_conv(x: torch.Tensor, weight: torch.Tensor,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv of x `[B, S, C]` with `weight [K, C]` (JAX's
    layout: tap i reads position t - (K - 1) + i), summed tap by tap in x's
    dtype as JAX sums them; with `segment_ids`, a tap across a document's
    start reads the zero a document run alone would see."""
    taps, seq = weight.shape[0], x.shape[1]
    padded = F.pad(x, (0, 0, taps - 1, 0))
    if segment_ids is None:
        return sum(padded[:, i:i + seq] * weight[i] for i in range(taps))
    seg = F.pad(segment_ids, (taps - 1, 0))
    return sum(padded[:, i:i + seq] * weight[i] * (seg[:, i:i + seq] == segment_ids)[..., None]
               for i in range(taps))


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x `[B, S, ...]` with `pad` zero rows appended along S."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def chunk_gated_delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                           beta: torch.Tensor, chunk_size: int = 64,
                           reset_decay: torch.Tensor | None = None) -> torch.Tensor:
    """The chunked gated delta rule (HF's `torch_chunk_gated_delta_rule`),
    fp32: q, k `[B, S, H, dk]`, v `[B, S, H, dv]`, g `[B, S, H]` the
    (negative) log-decay, beta `[B, S, H]` the write strength, `reset_decay`
    `[B, S]` from `segment_reset_decay`. Within a chunk the delta rule's
    corrections solve a unit-lower-triangular system; across chunks a loop
    carries the `[dk, dv]` state. Returns `[B, S, H, dv]` in q's dtype."""
    in_dtype = q.dtype
    q, k = _l2norm(q.float()), _l2norm(k.float())
    v, g, beta = v.float(), g.float(), beta.float()
    if reset_decay is not None:
        g = g + reset_decay.float()[..., None]
    batch, seq, heads, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    pad = (-seq) % c
    if pad:
        q, k, v, g, beta = (_pad_seq(x, pad) for x in (q, k, v, g, beta))
    nc = (seq + pad) // c

    def chunked(x):  # -> [B, H, nc, c, d]
        return x.reshape(batch, nc, c, heads, -1).permute(0, 3, 1, 2, 4)

    q = chunked(q) * dk**-0.5
    k, v = chunked(k), chunked(v)
    g = g.reshape(batch, nc, c, heads).permute(0, 3, 1, 2)  # [B, H, nc, c]
    beta = beta.reshape(batch, nc, c, heads).permute(0, 3, 1, 2)
    v_beta = v * beta[..., None]
    k_beta = k * beta[..., None]

    g = prefix_sum(g)
    tril = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    # decay_ij = exp(g_i - g_j) on the lower triangle (i >= j), else 0
    decay = masked_exp(g[..., :, None] - g[..., None, :], tril)
    # the strictly lower correction matrix A, then T = (I - A)^-1 by one
    # triangular solve a chunk (the reference's per-row loop)
    strict = tril.tril(-1)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    a_mat = torch.where(strict, -(k_beta @ k.transpose(-1, -2)) * decay, zero)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    t_mat = torch.linalg.solve_triangular(eye - a_mat, eye.expand(a_mat.shape), upper=False,
                                          unitriangular=True)
    v_corr = t_mat @ v_beta
    k_cumdecay = t_mat @ (k_beta * g.exp()[..., None])

    state = torch.zeros((batch, heads, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nc):
        q_i, k_i, v_i, kc_i, g_i = q[:, :, i], k[:, :, i], v_corr[:, :, i], k_cumdecay[:, :, i], \
            g[:, :, i]
        attn = torch.where(tril, (q_i @ k_i.transpose(-1, -2)) * decay[:, :, i], zero)
        v_new = v_i - kc_i @ state
        inter = (q_i * g_i.exp()[..., None]) @ state
        outs.append(inter + attn @ v_new)
        g_last = g_i[..., -1]
        state = state * g_last.exp()[..., None, None] + (
            k_i * (g_last[..., None] - g_i).exp()[..., None]).transpose(-1, -2) @ v_new
    out = torch.stack(outs, 2).reshape(batch, heads, nc * c, dv)
    return out.transpose(1, 2)[:, :seq].to(in_dtype)


class GatedDeltaNet(nn.Module):
    """The linear-attention mixer (HF's Qwen3NextGatedDeltaNet); parameters
    in JAX's order and layouts (`conv_kernel [K, C]`)."""

    init_fill = {"A_log": 0.0, "dt_bias": 0.0}

    def __init__(self, config: Qwen3NextConfig, device=None):
        super().__init__()
        self.config = config
        cfg, h = config, config.hidden_size
        kh, vh = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        key_dim = kh * cfg.linear_key_head_dim
        value_dim = vh * cfg.linear_value_head_dim
        self.in_proj_qkvz = linear(cfg, h, 2 * key_dim + 2 * value_dim, False, device)
        self.in_proj_ba = linear(cfg, h, 2 * vh, False, device)
        self.conv_kernel = param(cfg, cfg.linear_conv_kernel_dim, 2 * key_dim + value_dim,
                                 device=device)
        self.A_log = param(cfg, vh, device=device, dtype=torch.float32)
        self.dt_bias = param(cfg, vh, device=device, dtype=torch.float32)
        self.norm = GatedRMSNorm(cfg.linear_value_head_dim, cfg.rms_norm_eps,
                                 cfg.param_torch_dtype, device)
        self.out_proj = linear(cfg, value_dim, h, False, device)

    def forward(self, hidden, pad_mask, segment_ids=None):
        cfg = self.config
        batch, seq, _ = hidden.shape
        kh, vh = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
        group = vh // kh
        key_dim = kh * dk
        if pad_mask is not None:  # HF zeroes padded tokens at the layer's input
            hidden = hidden * pad_mask[..., None].to(hidden.dtype)
        # HF interleaves per k head: [q (dk) | k (dk) | v (group dv) | z (group dv)]
        qkvz = _linear(hidden, self.in_proj_qkvz).reshape(batch, seq, kh, 2 * dk + 2 * group * dv)
        ba = _linear(hidden, self.in_proj_ba).reshape(batch, seq, kh, 2 * group)
        z = qkvz[..., 2 * dk + group * dv:].reshape(batch, seq, vh, dv)
        b = ba[..., :group].reshape(batch, seq, vh)
        a = ba[..., group:].reshape(batch, seq, vh)
        mixed = torch.cat([qkvz[..., :dk].reshape(batch, seq, key_dim),
                           qkvz[..., dk:2 * dk].reshape(batch, seq, key_dim),
                           qkvz[..., 2 * dk:2 * dk + group * dv].reshape(batch, seq, vh * dv)],
                          -1)
        reset_on = cfg.segment_state_reset and segment_ids is not None
        mixed = F.silu(causal_conv(mixed, self.conv_kernel.to(mixed.dtype),
                                   segment_ids if reset_on else None))
        q = mixed[..., :key_dim].reshape(batch, seq, kh, dk).repeat_interleave(group, 2)
        k = mixed[..., key_dim:2 * key_dim].reshape(batch, seq, kh, dk).repeat_interleave(group, 2)
        v = mixed[..., 2 * key_dim:].reshape(batch, seq, vh, dv)
        beta = torch.sigmoid(b.float())
        g = -self.A_log.exp() * F.softplus(a.float() + self.dt_bias)
        out = chunk_gated_delta_rule(
            q, k, v, g, beta, chunk_size=cfg.delta_chunk_size,
            reset_decay=segment_reset_decay(segment_ids) if reset_on else None)
        out = self.norm(out, z).reshape(batch, seq, vh * dv)
        return _linear(out, self.out_proj)


class GatedAttention(nn.Module):
    """Softmax attention with an output gate: `q_proj` emits [q | gate] per
    head; zero-centred qk-norms; partial rotary; sigmoid(gate) * out."""

    def __init__(self, config: Qwen3NextConfig, device=None):
        super().__init__()
        self.config = config
        cfg, h = config, config.hidden_size
        heads, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        bias = cfg.attention_bias
        self.q_proj = linear(cfg, h, heads * d * 2, bias, device)
        self.k_proj = linear(cfg, h, kv * d, bias, device)
        self.v_proj = linear(cfg, h, kv * d, bias, device)
        self.o_proj = linear(cfg, heads * d, h, bias, device)
        dtype = cfg.param_torch_dtype
        self.q_norm = ZeroCenteredRMSNorm(d, cfg.rms_norm_eps, dtype, device)
        self.k_norm = ZeroCenteredRMSNorm(d, cfg.rms_norm_eps, dtype, device)

    def forward(self, hidden, segment_ids, cos, sin):
        cfg = self.config
        batch, seq, _ = hidden.shape
        heads, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        qg = _linear(hidden, self.q_proj).reshape(batch, seq, heads, 2 * d)
        q, gate = qg[..., :d], qg[..., d:].reshape(batch, seq, heads * d)
        k = _linear(hidden, self.k_proj).reshape(batch, seq, kv, d)
        v = _linear(hidden, self.v_proj).reshape(batch, seq, kv, d)
        q, k = self.q_norm(q), self.k_norm(k)
        rot = int(d * cfg.partial_rotary_factor)
        q_rot, k_rot = apply_rope(q[..., :rot], k[..., :rot], cos, sin)
        q = torch.cat([q_rot, q[..., rot:]], -1)
        k = torch.cat([k_rot, k[..., rot:]], -1)
        out = dot_product_attention(q, k, v, segment_ids=segment_ids, causal=True,
                                    impl=cfg.attention_impl)
        out = out.to(hidden.dtype).reshape(batch, seq, heads * d)
        out = out * torch.sigmoid(gate.float()).to(out.dtype)
        return _linear(out, self.o_proj)


class Qwen3NextDecoderLayer(nn.Module):
    """Pre-norm block with zero-centred norms: the mixer (`linear_attn` or
    `self_attn`), then the MoE (returning its router statistics) or the
    dense MLP."""

    def __init__(self, config: Qwen3NextConfig, is_linear: bool, device=None):
        super().__init__()
        cfg, dtype = config, config.param_torch_dtype
        self.is_linear, self.is_moe = is_linear, bool(cfg.num_experts)
        self.input_layernorm = ZeroCenteredRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        if is_linear:
            self.linear_attn = GatedDeltaNet(cfg, device)
        else:
            self.self_attn = GatedAttention(cfg, device)
        self.post_attention_layernorm = ZeroCenteredRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                            dtype, device)
        self.mlp = (moe.MoEMLP(cfg, device) if self.is_moe
                    else SwiGLU(cfg, cfg.intermediate_size, cfg.mlp_bias, device))

    def forward(self, hidden, segment_ids, cos, sin):
        pad_mask = None if segment_ids is None else segment_ids > 0
        normed = self.input_layernorm(hidden)
        if self.is_linear:
            hidden = hidden + self.linear_attn(normed, pad_mask, segment_ids)
        else:
            hidden = hidden + self.self_attn(normed, segment_ids, cos, sin)
        normed = self.post_attention_layernorm(hidden)
        if not self.is_moe:
            return hidden + self.mlp(normed)
        out, stats = self.mlp(normed, pad_mask)
        return hidden + out, stats


class Qwen3Next(MoEFamilyLM):
    """Qwen3-Next causal LM."""

    has_aux_loss = True

    def layer(self, i: int, device) -> nn.Module:
        return Qwen3NextDecoderLayer(self.config, self.config.layer_is_linear(i), device)

    def build_final_norm(self, device) -> nn.Module:
        cfg = self.config
        return ZeroCenteredRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_torch_dtype, device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return self.config.num_experts
