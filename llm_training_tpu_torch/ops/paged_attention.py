"""Paged KV-cache attention: scatter-append, then ragged attention.

Counterpart of `llm_training_tpu/ops/paged_attention.py`. The cache is a
pool of fixed-size blocks (`[num_blocks, block_size, kv_heads, head_dim]`
per layer) owned by `serve/paged_cache.py`; each row addresses it through
a block table and its own length.

Two attention paths behind one call:

- single-token decode on a CUDA tensor: the hand-written ragged
  paged-decode kernel (`ops/kernels/paged_attention.py`);
- everything else (chunked prefill, the CPU): a gather path -- the block
  table gathers a dense `[B, P*page, H, D]` view and a per-row position
  mask feeds the reference attention.
"""

from __future__ import annotations

import torch

from llm_training_tpu_torch.ops.attention import _xla_attention
from llm_training_tpu_torch.ops.kernels.paged_attention import paged_decode_attention

IMPLS = ("auto", "kernel", "torch")


def paged_append(
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    segment_ids: torch.Tensor | None,
) -> None:
    """Scatter this chunk's k/v `[B, S, H, D]` into the pool at each row's
    next positions (`lengths[b] + i`), IN PLACE (the JAX version returns
    new pools, which its jitted step donates). Padded positions (segment id
    0) and out-of-table positions go to trash block 0."""
    batch, seq = k.shape[:2]
    page_size = pool_k.shape[1]
    num_pages = block_tables.shape[1]
    pos = lengths.long()[:, None] + torch.arange(seq, device=k.device)[None, :]
    valid = torch.ones((batch, seq), dtype=torch.bool, device=k.device)
    if segment_ids is not None:
        valid &= segment_ids > 0
    valid &= pos < num_pages * page_size
    page = torch.gather(
        block_tables.long(), 1, torch.clamp(pos // page_size, max=num_pages - 1)
    )
    page = torch.where(valid, page, 0)
    offset = torch.where(valid, pos % page_size, 0)
    pool_k.index_put_((page, offset), k.to(pool_k.dtype))
    pool_v.index_put_((page, offset), v.to(pool_v.dtype))


def _gather_attention(
    q, pool_k, pool_v, lengths, block_tables, segment_ids,
    sliding_window, logits_soft_cap, scale,
):
    """Dense gather of each row's pages + per-row causal mask. `lengths`
    is the PRE-append count: q position i of row b sits at slot
    `lengths[b] + i`."""
    batch, seq = q.shape[:2]
    page_size = pool_k.shape[1]
    num_pages = block_tables.shape[1]
    tables = block_tables.long()
    gk = pool_k[tables].reshape(batch, num_pages * page_size, *pool_k.shape[2:])
    gv = pool_v[tables].reshape(batch, num_pages * page_size, *pool_v.shape[2:])
    q_pos = lengths.long()[:, None] + torch.arange(seq, device=q.device)[None, :]
    kv_pos = torch.arange(num_pages * page_size, device=q.device)
    mask = kv_pos[None, None, None, :] <= q_pos[:, None, :, None]
    if sliding_window is not None:
        mask &= q_pos[:, None, :, None] - kv_pos[None, None, None, :] < sliding_window
    if segment_ids is not None:
        mask &= (segment_ids > 0)[:, None, :, None]
    return _xla_attention(
        q, gk.to(q.dtype), gv.to(q.dtype), mask, scale, logits_soft_cap
    )


def paged_cached_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    layer_kv: tuple[torch.Tensor, torch.Tensor],
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    segment_ids: torch.Tensor | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Append this chunk's k/v through the block table (in place), then
    attend each row against its own cache. q/k/v `[B, S, H*, D]`;
    `layer_kv` is this layer's pool pair; `lengths [B]` counts tokens in
    each row's cache BEFORE this chunk. Returns `out [B, S, Hq, D]`.

    impl: 'auto' (the kernel for single-token decode on a CUDA tensor, the
    gather path otherwise) | 'kernel' (the kernel, or raise) | 'torch'
    (always the gather path)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    pool_k, pool_v = layer_kv
    lengths = lengths.to(torch.int32)
    paged_append(pool_k, pool_v, k, v, lengths, block_tables, segment_ids)

    seq = q.shape[1]
    if impl == "kernel" and (seq != 1 or not q.is_cuda):
        raise ValueError(
            f"impl='kernel' needs single-token decode on a CUDA tensor "
            f"(q_len {seq}, device {q.device})"
        )
    if impl == "kernel" or (impl == "auto" and seq == 1 and q.is_cuda):
        # k/v were appended above, so the kernel sees this token too
        return paged_decode_attention(
            q[:, 0].contiguous(), pool_k, pool_v,
            block_tables.to(torch.int32).contiguous(), lengths + 1,
            scale=scale, sliding_window=sliding_window,
            logits_soft_cap=logits_soft_cap,
        )[:, None]
    return _gather_attention(
        q, pool_k, pool_v, lengths, block_tables, segment_ids,
        sliding_window, logits_soft_cap, scale,
    )
