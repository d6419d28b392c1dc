"""Llama model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/llama/config.py`. Field names are
the JAX package's (which are HF's). Only the plain Llama decoder is ported:
fields that select another architecture raise `NotImplementedError` when
set to anything but the Llama value.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Any

import torch

from llm_training_tpu_torch.models.base import resolve_dtype
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf

# field -> the only value the port implements
_LLAMA_ONLY = {
    "num_experts": None,
    "norm_scheme": "pre",
    "norm_type": "rmsnorm",
    "mlp_type": "swiglu",
    "qk_norm": False,
    "clip_qkv": None,
    "partial_rotary_factor": 1.0,
    "position_embedding_type": "rope",
    "layer_types": None,
    "attention_bias": False,
    "mlp_bias": False,
}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int | None = None  # defaults to hidden_size // num_attention_heads
    max_position_embeddings: int = 4096
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    eos_token_id: int | list[int] | None = 2
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    sliding_window: int | None = None
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # architecture selectors of the JAX config; only the Llama values are ported
    num_experts: int | None = None
    norm_scheme: str = "pre"
    norm_type: str = "rmsnorm"
    mlp_type: str = "swiglu"
    qk_norm: bool = False
    clip_qkv: float | None = None
    partial_rotary_factor: float = 1.0
    position_embedding_type: str = "rope"
    layer_types: list[str] | None = None
    attention_bias: bool = False
    mlp_bias: bool = False

    def __post_init__(self):
        for name, value in _LLAMA_ONLY.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported (only {value!r})"
                )
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be divisible "
                f"by num_key_value_heads ({self.num_key_value_heads})"
            )
        resolve_dtype(self.compute_dtype)
        resolve_dtype(self.param_dtype)
        self.rope_config  # construct to validate the rope fields

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(
            self.rope_scaling, self.rope_theta, self.resolved_head_dim,
            self.max_position_embeddings,
        )

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        """A config file is a JSON object of this dataclass's fields."""
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown LlamaConfig fields {unknown} in {path}")
        return cls(**data)


# meta-llama/Llama-3.1-8B config.json widths
PRESETS: dict[str, dict[str, Any]] = {
    "llama-3.1-8b": dict(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
        },
        eos_token_id=128001,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> LlamaConfig:
    """A named published configuration, optionally with fields replaced
    (e.g. `num_hidden_layers` to cut depth)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return LlamaConfig(**{**base, **overrides})
