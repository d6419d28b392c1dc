"""Dtype names and the model output / paged decode-state records.

Counterpart of `llm_training_tpu/models/base.py`: `resolve_dtype`,
`DecodeState` (the dense cache of `generate`), `PagedDecodeState` (the
serving pool) and `CausalLMOutput`, with only the fields the inference,
serving and training paths read.
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
class DecodeState:
    """Static-shape dense KV cache threaded through the decoder stack for
    batched generation (`infer/engine.py`).

    `k`/`v` are `[num_layers, batch, max_length, num_kv_heads, head_dim]`
    buffers in the cache dtype. `index` is the number of tokens already
    written: the position the incoming chunk appends at, SHARED across the
    batch (prompts are left-padded to a common width). `segment_ids
    [batch, max_length]` marks which slots hold real tokens (1) and which
    are left-pad or not yet written (0); the attention mask's `seg > 0` term
    makes the latter unreachable and its causal term (`q_offset = index`)
    hides slots written after the chunk.

    As with the paged pool, the layers write `k`, `v` and `segment_ids` IN
    PLACE (the JAX engine donates the buffers to its jitted programs); the
    model returns a state whose `index` has advanced by the chunk width."""

    k: torch.Tensor
    v: torch.Tensor
    index: int
    segment_ids: torch.Tensor
    # the length the generation will reach (padded prompt width plus
    # max_new_tokens): length-dependent RoPE variants (longrope's short or
    # long factors, dynamic NTK) select their tables from it, not from the
    # cache's capacity. None: the capacity
    rope_length: int | None = None

    @property
    def max_length(self) -> int:
        return self.k.shape[2]

    @property
    def table_length(self) -> int:
        """The length RoPE table selection sees."""
        return self.rope_length or self.max_length


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
    # the planned sequence length for length-dependent RoPE tables (as
    # `DecodeState.rope_length`); None: the tokens a row's table can address
    rope_length: int | None = None

    @property
    def table_length(self) -> int:
        """The length RoPE table selection sees."""
        return self.rope_length or self.block_tables.shape[1] * self.k.shape[2]


@dataclass
class CausalLMOutput:
    """`logits` is None when the caller asks for the hidden states only
    (the fused-linear cross-entropy consumes the pre-head activations)."""

    logits: torch.Tensor | None = None
    last_hidden_states: torch.Tensor | None = None
    decode_state: DecodeState | PagedDecodeState | None = None
