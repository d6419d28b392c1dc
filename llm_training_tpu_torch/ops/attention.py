"""Attention with segment-id packing, GQA, sliding window, soft cap and
gpt-oss sinks.

Counterpart of `llm_training_tpu/ops/attention.py`: `make_attention_mask`,
the reference attention `_xla_attention` (the plain path: chunked prefill
when serving, everything on the CPU) and the dispatcher
`dot_product_attention`, which sends the training path's attention to the
flash kernels (`ops/kernels/flash_attention.py`) on a CUDA tensor.
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
    sinks: torch.Tensor | None = None,
    return_lse: bool = False,
):
    """Einsum attention with an fp32 softmax; GQA without repeating kv.

    q `[B, Sq, Hq, D]`, k/v `[B, Skv, Hkv, D]`, mask `[B, 1, Sq, Skv]`.
    q heads are kv-major: head `h*G + g` reads kv head `h`. `sinks` `[Hq]`:
    one logit per q head joins each row's softmax denominator with zero
    value (gpt-oss). A fully masked row emits exactly 0. With `return_lse`
    also returns the row logsumexp `[B, Hq, Sq]` fp32 over the visible
    scores and the sink (-inf for a row that sees nothing and has no sink),
    as the flash kernel does."""
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
    visible = None if mask is None else mask[:, :, None]
    if visible is not None:
        scores = torch.where(visible, scores, _MASK_VALUE)
    sink = None
    if sinks is not None:
        sink = sinks.to(torch.float32).reshape(num_kv_heads, group)[None, :, :, None]
        m = torch.maximum(scores.amax(-1), sink)
        p = torch.exp(scores - m[..., None])
        if visible is not None:
            p = torch.where(visible, p, 0.0)
        probs = p / (p.sum(-1) + torch.exp(sink - m))[..., None]
    else:
        probs = torch.softmax(scores, dim=-1)
    if visible is not None:
        probs = torch.where(visible.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    out = out.reshape(batch, q_len, num_q_heads, head_dim)
    if not return_lse:
        return out
    logits = scores if visible is None else scores.masked_fill(~visible, float("-inf"))
    if sink is not None:
        logits = torch.cat([logits, sink[..., None].expand(*logits.shape[:-1], 1)], -1)
    lse = torch.logsumexp(logits, -1).reshape(batch, num_q_heads, q_len)
    return out, lse


IMPLS = ("auto", "kernel", "torch")
# the JAX config's names for the same choices
_JAX_IMPLS = {"xla": "torch", "pallas": "kernel"}


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    causal: bool = True,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    impl: str = "auto",
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention over packed sequences (the JAX dispatcher's
    contract): q `[B, Sq, Hq, D]`, k/v `[B, Skv, Hkv, D]`, segment ids
    `[B, S]` (0 = padding), `q_segment_ids` defaulting to `segment_ids`
    when Sq == Skv, `q_offset` the position of q row 0 in kv.

    impl: 'auto' (the flash kernels on a CUDA tensor, the plain path on a
    CPU tensor) | 'kernel' (the kernels, or raise) | 'torch' (always the
    plain path); JAX's 'pallas' and 'xla' name the latter two."""
    impl = _JAX_IMPLS.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} (or 'xla', 'pallas'), got {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q_segment_ids is None and segment_ids is not None:
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                "q_segment_ids is required when segment_ids is given and "
                f"q_len ({q.shape[1]}) != kv_len ({k.shape[1]})"
            )
        q_segment_ids = segment_ids
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(f"impl='kernel' runs the CUDA flash kernels; q is on {q.device}")
    if impl == "kernel" or (impl == "auto" and q.is_cuda):
        from llm_training_tpu_torch.ops.kernels.flash_attention import flash_attention

        return flash_attention(
            q, k, v, segment_ids=segment_ids, q_segment_ids=q_segment_ids, causal=causal,
            sliding_window=sliding_window, logits_soft_cap=logits_soft_cap, scale=scale,
            q_offset=q_offset, sinks=sinks,
        )
    mask = None
    if segment_ids is not None or causal or sliding_window is not None:
        mask = make_attention_mask(
            q_segment_ids, segment_ids, q.shape[1], k.shape[1], causal=causal,
            sliding_window=sliding_window, q_offset=q_offset, device=q.device,
        )
    return _xla_attention(q, k, v, mask, scale, logits_soft_cap, sinks=sinks)
