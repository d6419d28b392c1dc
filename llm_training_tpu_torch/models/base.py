"""Dtype names and the model output / paged decode-state records.

Counterpart of `llm_training_tpu/models/base.py`: `resolve_dtype`,
`PagedDecodeState` and `CausalLMOutput`, with only the fields the serving
and training paths read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPE_MAP = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPE_MAP[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; expected one of {sorted(_DTYPE_MAP)}"
        ) from None


@dataclass
class PagedDecodeState:
    """Block-table KV cache threaded through the decoder stack.

    `k`/`v` are the `[num_layers, num_blocks, block_size, num_kv_heads,
    head_dim]` pool buffers (physical block 0 is the trash block: idle
    decode rows and padded chunk positions write there). `block_tables
    [batch, max_blocks_per_request]` maps each row's logical block to a
    pool block; `lengths [batch]` counts the tokens already written per row.

    Unlike the JAX state, the pools are updated IN PLACE by the layers
    (JAX donated the buffers to the jitted step for the same effect); the
    model returns a state whose `lengths` have advanced."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor


@dataclass
class CausalLMOutput:
    """`logits` is None when the caller asks for the hidden states only
    (the fused-linear cross-entropy consumes the pre-head activations)."""

    logits: torch.Tensor | None = None
    last_hidden_states: torch.Tensor | None = None
    decode_state: PagedDecodeState | None = None
