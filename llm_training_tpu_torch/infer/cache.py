"""KV-cache sizing, dtype policy and construction.

Counterpart of `cache_dims`, `resolve_cache_dtype`, `init_decode_state`
and `cache_bytes` in `llm_training_tpu/infer/cache.py`. The port has no
mesh: the cache is allocated whole on the engine's device.
"""

from __future__ import annotations

import torch

from llm_training_tpu_torch.models.base import DecodeState, resolve_dtype


def cache_dims(config) -> tuple[int, int, int]:
    """(num_layers, num_kv_heads, head_dim) of a decoder config."""
    head_dim = getattr(config, "resolved_head_dim", None) or config.head_dim
    return config.num_hidden_layers, config.num_key_value_heads, head_dim


def resolve_cache_dtype(config, cache_dtype: str | None) -> torch.dtype:
    """None / 'param' -> the model's param dtype; otherwise a dtype name
    ('float32' for an exactness oracle, 'bfloat16' to halve the cache)."""
    if cache_dtype in (None, "param"):
        return config.param_torch_dtype
    return resolve_dtype(cache_dtype)


def init_decode_state(
    config,
    batch_size: int,
    max_length: int,
    cache_dtype: str | None = None,
    device: torch.device | str | None = None,
    rope_length: int | None = None,
) -> DecodeState:
    """A fresh all-zeros dense cache on `device`: index 0, no slot filled;
    `rope_length` is the length RoPE table selection sees (None: the
    capacity)."""
    num_layers, kv_heads, head_dim = cache_dims(config)
    dtype = resolve_cache_dtype(config, cache_dtype)
    shape = (num_layers, batch_size, max_length, kv_heads, head_dim)
    return DecodeState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        index=0,
        segment_ids=torch.zeros((batch_size, max_length), dtype=torch.int32, device=device),
        rope_length=rope_length,
    )


def cache_bytes(state: DecodeState) -> int:
    """Device footprint of the cache buffers (the `decode/cache_bytes`
    gauge)."""
    return sum(t.numel() * t.element_size() for t in (state.k, state.v))
