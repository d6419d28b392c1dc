"""SwiGLU activation. Counterpart of `llm_training_tpu/ops/swiglu.py`."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up -- the SwiGLU elementwise core."""
    return F.silu(gate) * up
