"""KV-cache sizing and dtype policy.

Counterpart of `cache_dims` and `resolve_cache_dtype` in
`llm_training_tpu/infer/cache.py`.
"""

from __future__ import annotations

import torch

from llm_training_tpu_torch.models.base import resolve_dtype


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
