"""HunYuan V1 MoE model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/hunyuan_moe/config.py`: dense
HunYuan's attention (per-head qk-norm after rotary) over a Mixtral-style
softmax top-k MoE with an always-on gate-free shared MLP of the experts'
width; JAX's validation and `rope_config`; `jax_layout` names the JAX
tree's layout (every layer scanned under `layers/layer`, or looped).

`PRESETS["hunyuan-a13b"]` is the published `config.json` of
tencent/Hunyuan-A13B-Instruct with its per-layer lists (`moe_topk`,
`num_experts`, all equal) written as the scalars JAX takes and its
dynamic-NTK `rope_scaling` left out (JAX's rotary has no `alpha` form):
the widths are the published ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, SCANNED, JaxLayout
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class HunYuanMoeConfig(FamilyConfig):
    vocab_size: int = 290943
    hidden_size: int = 4096
    intermediate_size: int = 3072  # an expert's and the shared MLP's width
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int | None = None
    max_position_embeddings: int = 32768
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = None
    bos_token_id: int | None = 1
    eos_token_id: int | list[int] | None = 2
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    attention_bias: bool = False

    num_experts: int = 16
    moe_topk: int = 2

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None
    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"
    moe_impl: str = "auto"
    ep_capacity_factor: float = 2.0

    def __post_init__(self):
        self._check_common()
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_key_value_heads ({self.num_key_value_heads})")
        if self.moe_topk > self.num_experts:
            raise ValueError("moe_topk exceeds num_experts")
        self.rope_config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.resolved_head_dim,
                                   self.max_position_embeddings)

    @property
    def jax_layout(self) -> JaxLayout:
        return JaxLayout(SCANNED if self.scan_layers else LOOPED)


PRESETS: dict[str, dict[str, Any]] = {
    # huggingface.co/tencent/Hunyuan-A13B-Instruct's config.json: 32 q heads
    # and 8 kv heads of 128, 64 experts of width 3072 (8 a token) and one
    # shared MLP, tied embeddings
    "hunyuan-a13b": dict(
        vocab_size=128167,
        hidden_size=4096,
        intermediate_size=3072,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        num_experts=64,
        moe_topk=8,
        attention_bias=False,
        max_position_embeddings=32768,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        bos_token_id=1,
        eos_token_id=127960,
        tie_word_embeddings=True,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> HunYuanMoeConfig:
    """A named published configuration, optionally with fields replaced."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return HunYuanMoeConfig(**{**base, **overrides})
