"""Phi-3 model config.

Counterpart of `llm_training_tpu/models/phi3/config.py`: the Llama config
with Phi-3-mini's defaults, `original_max_position_embeddings`,
`attention_compute_dtype` (run q, k and v in this dtype whatever the
compute dtype), the dropout fields (refused unless 0.0), and the longrope
validation with factor defaulting, raising JAX's errors in JAX's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.base import resolve_dtype
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig


@dataclass
class Phi3Config(LlamaConfig):
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    original_max_position_embeddings: int | None = None
    sliding_window: int | None = None
    bos_token_id: int | None = 1
    eos_token_id: int | list[int] | None = 32000
    pad_token_id: int | None = 32000
    resid_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    attention_compute_dtype: str | None = None

    def __post_init__(self):
        super().__post_init__()  # builds rope_config below: its errors come first, as in JAX
        if self.resid_pdrop != 0.0 or self.embd_pdrop != 0.0:
            raise ValueError("dropout is not supported; set resid/embd_pdrop to 0.0")
        if self.attention_compute_dtype is not None:
            resolve_dtype(self.attention_compute_dtype)
        if self.rope_scaling:
            rope_type = self.rope_scaling.get("rope_type", self.rope_scaling.get("type"))
            if rope_type == "longrope":
                dim = self.resolved_head_dim // 2
                for key in ("short_factor", "long_factor"):
                    factors = self.rope_scaling.get(key)
                    if factors is None or len(factors) != dim:
                        raise ValueError(f"longrope {key} must have length head_dim/2={dim}")
                if self.original_max_position_embeddings is None:
                    raise ValueError("longrope requires original_max_position_embeddings")

    @property
    def rope_config(self) -> RoPEConfig:
        scaling: dict[str, Any] | None = dict(self.rope_scaling) if self.rope_scaling else None
        rope_type = "default"
        if scaling:
            for key in ("rope_type", "type"):
                if key in scaling:
                    rope_type = scaling.pop(key)
        max_pos = self.max_position_embeddings
        if rope_type == "longrope":
            # factor = max_pos / original max_pos by default; frequencies are
            # computed against the original context window
            original = self.original_max_position_embeddings
            if original is None:
                raise ValueError("longrope requires original_max_position_embeddings")
            scaling.setdefault("factor", max_pos / original)
            max_pos = original
        return RoPEConfig(
            dim=self.resolved_head_dim, max_position_embeddings=max_pos, type=rope_type,
            base=self.rope_theta, scaling=scaling or None,
        )
