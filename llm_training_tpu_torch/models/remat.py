"""Activation checkpointing of decoder layers.

Counterpart of `llm_training_tpu/models/remat.py` (`remat_policy`):

- 'full': `torch.utils.checkpoint` around each decoder layer saves only
  the layer's input and recomputes the whole layer in the backward, so the
  flash forward kernel runs twice per layer per micro-step;
- 'selective': the same checkpoint with a policy that saves the outputs of
  the flash forward op (the attention output and its LSE, JAX's
  `save_only_these_names("flash_out", "flash_lse")`) and recomputes
  everything else, so the forward kernel runs once. On the plain attention
  path (the CPU) nothing carries that op, so 'selective' recomputes the
  whole layer there (ROADMAP C).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# registers the flash forward op (and builds nothing)
from llm_training_tpu_torch.ops.kernels import flash_attention  # noqa: F401


def _selective_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op == torch.ops.llm_training_tpu_torch.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(config: Any) -> Callable | None:
    """The checkpoint wrapper for a layer call, from a config carrying
    `enable_gradient_checkpointing` and `recompute_granularity`: None (no
    checkpointing), or `wrap(fn, *args)` that runs `fn(*args)` under it."""
    if not config.enable_gradient_checkpointing:
        return None
    if config.recompute_granularity == "full":
        return functools.partial(checkpoint, use_reentrant=False)
    if config.recompute_granularity == "selective":
        return functools.partial(
            checkpoint, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _selective_policy),
        )
    raise ValueError(
        f"recompute_granularity must be 'full' or 'selective', got {config.recompute_granularity!r}"
    )


def run_layer(wrap: Callable | None, layer: torch.nn.Module, *args) -> torch.Tensor:
    """`layer(*args)`, under the checkpoint wrapper when gradients flow."""
    if wrap is None or not torch.is_grad_enabled():
        return layer(*args)
    return wrap(layer, *args)
