"""RMS normalization. Counterpart of `llm_training_tpu/ops/rms_norm.py`."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = weight * (x / rms(x)).

    Normalises in fp32, rounds the normalised value to x's dtype, THEN
    multiplies by the weight -- the JAX package's order, so bf16
    activations round at the same places."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    variance = x32.square().mean(dim=-1, keepdim=True)
    x_normed = (x32 * torch.rsqrt(variance + eps)).to(dtype)
    return weight * x_normed
