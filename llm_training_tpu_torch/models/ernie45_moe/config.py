"""ERNIE-4.5-MoE model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/ernie45_moe/config.py`: dense
ERNIE's attention (interleaved full rotary, one `use_bias` over q/k/v/o
and every MLP) with a softmax router that selects on probabilities plus
the correction bias, gate-free shared experts and a dense prefix; JAX's
validation, `layer_is_moe` (HF's start/end/interval rule) and
`num_scanned_layers` (JAX scans only when every layer from
`moe_layer_start_index` on is MoE); `jax_layout` names the JAX tree's
layout (`moe_scan_io.py`).

`PRESETS["ernie-4.5-21b-a3b"]` is the published `config.json` of
baidu/ERNIE-4.5-21B-A3B-PT, written out field by field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, SUFFIX, JaxLayout
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class Ernie45MoeConfig(FamilyConfig):
    vocab_size: int = 103424
    hidden_size: int = 2560
    intermediate_size: int = 12288  # dense layers (the MoE-free prefix)
    num_hidden_layers: int = 28
    num_attention_heads: int = 20
    num_key_value_heads: int = 4
    head_dim: int | None = None
    max_position_embeddings: int = 131072
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = None
    bos_token_id: int | None = 1
    eos_token_id: int | list[int] | None = 2
    tie_word_embeddings: bool = True
    rope_theta: float = 500000.0
    rope_scaling: dict[str, Any] | None = None
    use_bias: bool = False

    # MoE
    moe_num_experts: int = 64
    moe_k: int = 6
    moe_intermediate_size: int | None = None
    moe_num_shared_experts: int = 2
    moe_layer_start_index: int = 1
    moe_layer_end_index: int = -1  # -1: the last layer
    moe_layer_interval: int = 1
    moe_norm_min: float = 1e-12
    moe_impl: str = "auto"
    ep_capacity_factor: float = 2.0

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None
    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"

    def __post_init__(self):
        self._check_common()
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_key_value_heads ({self.num_key_value_heads})")
        if self.moe_intermediate_size is None:
            raise ValueError("ernie4_5_moe requires moe_intermediate_size")
        if self.moe_k > self.moe_num_experts:
            raise ValueError("moe_k exceeds moe_num_experts")
        self.rope_config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.resolved_head_dim,
                                   self.max_position_embeddings)

    @property
    def _end(self) -> int:
        return (self.moe_layer_end_index if self.moe_layer_end_index >= 0
                else self.num_hidden_layers - 1)

    def layer_is_moe(self, layer_idx: int) -> bool:
        """HF's rule: (i + 1) % interval == 0 within [start, end]."""
        return (self.moe_layer_start_index <= layer_idx <= self._end
                and (layer_idx + 1) % self.moe_layer_interval == 0)

    @property
    def num_scanned_layers(self) -> int:
        """Depth of JAX's scanned MoE suffix (0: every layer looped)."""
        if (not self.scan_layers or self.moe_layer_interval != 1
                or self._end != self.num_hidden_layers - 1):
            return 0
        return self.num_hidden_layers - self.moe_layer_start_index

    @property
    def jax_layout(self) -> JaxLayout:
        if not self.num_scanned_layers:
            return JaxLayout(LOOPED)
        return JaxLayout(SUFFIX, self.num_hidden_layers - self.num_scanned_layers)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/baidu/ERNIE-4.5-21B-A3B-PT: 20 q
    # heads and 4 kv heads of 128, 64 experts of width 1536 (6 a token) and
    # 2 shared, one dense layer first, tied embeddings, no biases
    "ernie-4.5-21b-a3b": dict(
        vocab_size=103424,
        hidden_size=2560,
        intermediate_size=12288,
        moe_intermediate_size=1536,
        num_hidden_layers=28,
        num_attention_heads=20,
        num_key_value_heads=4,
        head_dim=128,
        use_bias=False,
        moe_num_experts=64,
        moe_k=6,
        moe_num_shared_experts=2,
        moe_layer_start_index=1,
        moe_layer_end_index=27,
        moe_layer_interval=1,
        moe_norm_min=1e-12,
        max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        pad_token_id=0,
        bos_token_id=1,
        eos_token_id=2,
        tie_word_embeddings=True,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> Ernie45MoeConfig:
    """A named published configuration, optionally with fields replaced."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return Ernie45MoeConfig(**{**base, **overrides})
