"""Reference attention: segment-id masks, GQA, sliding window, soft cap.

Counterpart of `llm_training_tpu/ops/attention.py` (`make_attention_mask`
and `_xla_attention`, without gpt-oss sinks). This is the plain path the
serving slice runs for chunked prefill and on the CPU.
"""

from __future__ import annotations

import torch

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_mask(
    segment_ids_q: torch.Tensor | None,
    segment_ids_kv: torch.Tensor | None,
    q_len: int,
    kv_len: int,
    causal: bool = True,
    sliding_window: int | None = None,
    q_offset: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Boolean mask `[batch, 1, q_len, kv_len]` (True = attend); `q_offset`
    is the absolute position of query row 0 in the kv sequence."""
    if device is None and segment_ids_q is not None:
        device = segment_ids_q.device
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= q_pos - kv_pos < sliding_window
    mask = mask[None, None]
    if segment_ids_q is not None:
        seg_q = segment_ids_q[:, None, :, None]
        seg_kv = segment_ids_kv[:, None, None, :]
        mask = mask & (seg_q == seg_kv) & (seg_q > 0) & (seg_kv > 0)
    return mask


def _xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    scale: float,
    logits_soft_cap: float | None,
) -> torch.Tensor:
    """Einsum attention with an fp32 softmax; GQA without repeating kv.

    q `[B, Sq, Hq, D]`, k/v `[B, Skv, Hkv, D]`, mask `[B, 1, Sq, Skv]`.
    q heads are kv-major: head `h*G + g` reads kv head `h`. A fully masked
    row emits exactly 0."""
    batch, q_len, num_q_heads, head_dim = q.shape
    num_kv_heads = k.shape[2]
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be divisible by num_kv_heads ({num_kv_heads})"
        )
    group = num_q_heads // num_kv_heads

    qg = q.reshape(batch, q_len, num_kv_heads, group, head_dim)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) * scale
    if logits_soft_cap is not None:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        probs = torch.where(mask[:, :, None].any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(batch, q_len, num_q_heads, head_dim)
