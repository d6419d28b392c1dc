"""Rotary position embedding, HF half-rotation layout.

Counterpart of `llm_training_tpu/ops/rope.py` (`rotate_half`, `apply_rope`).
"""

from __future__ import annotations

import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Rotate the second half of the last dim into the (negated) first half."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """q `[B, S, Hq, D]`, k `[B, S, Hkv, D]`, cos/sin `[B, S, D]` or `[S, D]`
    in fp32. The tables are cast to each tensor's dtype on their own, as in
    the JAX package, so q and k never see a doubly rounded table."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q_rot = q * cos.to(q.dtype) + rotate_half(q) * sin.to(q.dtype)
    k_rot = k * cos.to(k.dtype) + rotate_half(k) * sin.to(k.dtype)
    return q_rot, k_rot
