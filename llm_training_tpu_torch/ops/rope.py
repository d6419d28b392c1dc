"""Rotary position embedding: HF's half-rotation layout, or the GPT-J /
Cohere interleaved pairing.

Counterpart of `llm_training_tpu/ops/rope.py` (`rotate_half`,
`rotate_interleaved`, `apply_rope`).
"""

from __future__ import annotations

import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Rotate the second half of the last dim into the (negated) first half."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    """GPT-J/Cohere pairing: rotate within (even, odd) pairs of the last
    dim, (x0, x1) -> (-x1, x0)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    interleaved: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q `[B, S, Hq, D]`, k `[B, S, Hkv, D]`, cos/sin `[B, S, D]` or `[S, D]`
    in fp32. The tables are cast to each tensor's dtype on their own, as in
    the JAX package, so q and k never see a doubly rounded table.
    `interleaved` pairs (even, odd) dims instead of (i, i + D/2); the caller
    supplies `repeat_interleave(freqs, 2)` tables."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    rotate = rotate_interleaved if interleaved else rotate_half
    q_rot = q * cos.to(q.dtype) + rotate(q) * sin.to(q.dtype)
    k_rot = k * cos.to(k.dtype) + rotate(k) * sin.to(k.dtype)
    return q_rot, k_rot
