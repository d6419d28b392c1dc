"""Gemma 1/2/3 model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/gemma/config.py`: the same fields
and defaults (gemma-2b's), JAX's validation in JAX's order (v1 refuses the
v2 features; v2 under `scan_layers` needs an even layer count, because JAX
scans (sliding, full) pairs; v3 needs an explicit `layer_types` when
windowed, turns `use_qk_norm` on unless it was given, and loops its
layers), `attention_scale`, `layer_sliding_window`, `rope_config` and
`local_rope_config`. `scan_layers` changes nothing the port computes: it
names the JAX tree's layout (`from_jax.py`, the `frozen_modules` paths).

`PRESETS` are the published `config.json`s of gemma-2-9b, gemma-3-4b (its
text model) and gemma-2b, written out field by field.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import torch

from llm_training_tpu_torch.models.base import resolve_dtype
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class GemmaConfig:
    version: int = 1

    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 8192
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False
    pad_token_id: int | None = 0
    bos_token_id: int | None = 2
    eos_token_id: int | list[int] | None = 1
    tie_word_embeddings: bool = True  # always, every version

    # gemma 2: the attention scale's base (None: head_dim), the soft caps,
    # and a window on even layers (version 3 takes it from layer_types)
    query_pre_attn_scalar: int | None = None
    attn_logit_softcapping: float | None = None
    final_logit_softcapping: float | None = None
    sliding_window: int | None = None

    # gemma 3: per-layer 'sliding_attention' / 'full_attention'; sliding
    # layers rotate with rope_local_base_freq, full ones with rope_theta
    # and rope_scaling; per-head qk-norm
    layer_types: list[str] | None = None
    rope_local_base_freq: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    use_qk_norm: bool | None = None  # None: JAX's "not set"

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None
    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"
    ring_attention: bool = False

    def __post_init__(self):
        if self.version not in (1, 2, 3):
            raise ValueError(f"version must be 1, 2 or 3, got {self.version!r}")
        if self.recompute_granularity not in ("full", "selective"):
            raise ValueError(
                f"recompute_granularity must be 'full' or 'selective', got "
                f"{self.recompute_granularity!r}"
            )
        if self.attention_impl not in ("auto", "xla", "pallas", "torch", "kernel"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        resolve_dtype(self.compute_dtype)
        resolve_dtype(self.param_dtype)
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be divisible "
                f"by num_key_value_heads ({self.num_key_value_heads})"
            )
        if self.version == 1 and (
            self.attn_logit_softcapping or self.final_logit_softcapping or self.sliding_window
        ):
            raise ValueError("softcapping/sliding_window are Gemma-2 (version=2) features")
        if self.version == 2 and self.scan_layers and self.num_hidden_layers % 2 != 0:
            raise ValueError(
                "gemma-2 scan_layers scans (sliding, full) layer pairs; "
                "num_hidden_layers must be even (disable scan_layers otherwise)"
            )
        if self.version == 3:
            if self.layer_types is not None and len(self.layer_types) != self.num_hidden_layers:
                raise ValueError(
                    f"layer_types has {len(self.layer_types)} entries for "
                    f"{self.num_hidden_layers} layers"
                )
            if self.sliding_window and self.layer_types is None:
                raise ValueError(
                    "version=3 with sliding_window requires an explicit "
                    "layer_types pattern"
                )
            if self.use_qk_norm is None:
                self.use_qk_norm = True
            self.scan_layers = False
        if self.layer_types is not None and self.version != 3:
            raise ValueError("layer_types is a Gemma-3 (version=3) feature")
        if self.use_qk_norm is None:
            self.use_qk_norm = False
        self.rope_config  # construct to validate the rope fields

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    @property
    def rope_config(self) -> RoPEConfig:
        """Global rope: rope_theta, plus Gemma-3's optional rope_scaling
        (linear factor 8 on the 4B and larger checkpoints)."""
        return rope_config_from_hf(
            self.rope_scaling, self.rope_theta, self.head_dim, self.max_position_embeddings,
        )

    @property
    def local_rope_config(self) -> RoPEConfig:
        """Gemma-3's sliding layers: rope_local_base_freq, never scaled."""
        return RoPEConfig(
            type="default", base=self.rope_local_base_freq, dim=self.head_dim,
            max_position_embeddings=self.max_position_embeddings,
        )

    @property
    def attention_scale(self) -> float:
        base = self.query_pre_attn_scalar if self.query_pre_attn_scalar else self.head_dim
        return float(base) ** -0.5

    def layer_sliding_window(self, layer_idx: int) -> int | None:
        """Gemma-2: 'sliding_attention' on even indices; Gemma-3: the
        explicit `layer_types` pattern."""
        if self.version == 3:
            if self.sliding_window and self.layer_types is not None:
                if self.layer_types[layer_idx] == "sliding_attention":
                    return self.sliding_window
            return None
        if self.version == 2 and self.sliding_window and layer_idx % 2 == 0:
            return self.sliding_window
        return None

    @property
    def paired(self) -> bool:
        """Whether JAX scans this config's layers as (sliding, full) pairs."""
        return self.version == 2 and bool(self.sliding_window)

    @classmethod
    def from_dict(cls, data: dict[str, Any], where: str = "config") -> "GemmaConfig":
        """From a mapping of this dataclass's fields; unknown keys raise."""
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown GemmaConfig fields {unknown} in {where}")
        return cls(**data)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/google/gemma-2-9b
    "gemma-2-9b": dict(
        version=2,
        vocab_size=256000,
        hidden_size=3584,
        intermediate_size=14336,
        num_hidden_layers=42,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=256,
        query_pre_attn_scalar=256,
        sliding_window=4096,
        attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_position_embeddings=8192,
        pad_token_id=0,
        bos_token_id=2,
        eos_token_id=1,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
    # the text model of huggingface.co/google/gemma-3-4b-pt (text_config):
    # a 5:1 sliding/full pattern, dual rotary tables, qk-norm
    "gemma-3-4b": dict(
        version=3,
        vocab_size=262208,
        hidden_size=2560,
        intermediate_size=10240,
        num_hidden_layers=34,
        num_attention_heads=8,
        num_key_value_heads=4,
        head_dim=256,
        query_pre_attn_scalar=256,
        sliding_window=1024,
        layer_types=["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                     for i in range(34)],
        rope_local_base_freq=10000.0,
        rope_theta=1000000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        use_qk_norm=True,
        rms_norm_eps=1e-6,
        max_position_embeddings=131072,
        pad_token_id=0,
        bos_token_id=2,
        eos_token_id=1,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
    # the config.json of huggingface.co/google/gemma-2b: MQA (one kv head)
    "gemma-2b": dict(
        version=1,
        vocab_size=256000,
        hidden_size=2048,
        intermediate_size=16384,
        num_hidden_layers=18,
        num_attention_heads=8,
        num_key_value_heads=1,
        head_dim=256,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_position_embeddings=8192,
        pad_token_id=0,
        bos_token_id=2,
        eos_token_id=1,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> GemmaConfig:
    """A named published configuration, optionally with fields replaced
    (e.g. `num_hidden_layers` to cut depth, `layer_types` with it)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return GemmaConfig(**{**base, **overrides})
