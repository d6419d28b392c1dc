"""GLM-4.5 (glm4_moe, and dots1) model config, as a dataclass that validates
on construction.

Counterpart of `llm_training_tpu/models/glm4_moe/config.py`: GQA attention
with partial rotary and an optional per-head qk-norm, plus DeepSeek-V3's
MoE (its field names, `version` pinned to 3), JAX's validation,
`rope_config`, `layer_is_moe`, `layer_sliding_window` and
`num_scanned_layers` (a suffix mixing sliding and full layers loops);
`jax_layout` names the JAX tree's layout (`moe_scan_io.py`). `hf_flavor`
is the HF architecture the config round-trips as.

`PRESETS["glm-4.5-air"]` is the published `config.json` of
zai-org/GLM-4.5-Air, written out field by field (its one multi-token
prediction layer, `num_nextn_predict_layers`, is not part of the graph in
JAX either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, SUFFIX, JaxLayout
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class Glm4MoeConfig(FamilyConfig):
    vocab_size: int = 151552
    hidden_size: int = 4096
    intermediate_size: int = 10944  # dense layers (the MoE-free prefix)
    num_hidden_layers: int = 46
    num_attention_heads: int = 96
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 131072
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = None
    bos_token_id: int | None = None
    eos_token_id: int | list[int] | None = None
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    partial_rotary_factor: float = 0.5
    attention_bias: bool = False
    # dots1 biases o_proj with the same flag; GLM-4.5 never does
    attention_out_bias: bool = False
    attention_dropout: float = 0.0
    use_qk_norm: bool = False
    sliding_window: int | None = None
    layer_types: list[str] | None = None
    hf_flavor: str = "glm4_moe"

    # DeepSeek-V3's MoE
    version: int = 3
    n_routed_experts: int = 128
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    moe_intermediate_size: int | None = None
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    n_group: int | None = None
    topk_group: int | None = None
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
        if self.hf_flavor not in ("glm4_moe", "dots1"):
            raise ValueError(f"hf_flavor must be 'glm4_moe' or 'dots1', got {self.hf_flavor!r}")
        if self.version != 3:
            raise ValueError("glm4_moe's router is DeepSeek-V3's: version must be 3")
        self._check_common()
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_key_value_heads ({self.num_key_value_heads})")
        if self.moe_intermediate_size is None:
            raise ValueError("glm4_moe requires moe_intermediate_size")
        if self.n_group is not None:
            if self.n_routed_experts % self.n_group:
                raise ValueError("n_routed_experts must divide into n_group groups")
            if self.topk_group is None:
                raise ValueError("n_group requires topk_group")
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_hidden_layers:
                raise ValueError(f"layer_types has {len(self.layer_types)} entries for "
                                 f"{self.num_hidden_layers} layers")
            bad = set(self.layer_types) - {"sliding_attention", "full_attention"}
            if bad:
                raise ValueError(f"unknown layer_types entries {sorted(bad)}; expected "
                                 "'sliding_attention' or 'full_attention'")
            if "sliding_attention" in self.layer_types and not self.sliding_window:
                raise ValueError("sliding layer_types require sliding_window")
        self.rope_config

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.rotary_dim,
                                   self.max_position_embeddings)

    def layer_is_moe(self, layer_idx: int) -> bool:
        return layer_idx >= self.first_k_dense_replace

    def layer_sliding_window(self, layer_idx: int) -> int | None:
        if self.layer_types is None or self.layer_types[layer_idx] == "sliding_attention":
            return self.sliding_window
        return None

    @property
    def num_scanned_layers(self) -> int:
        """Depth of JAX's scanned MoE suffix (0: every layer looped)."""
        if not self.scan_layers:
            return 0
        if (self.layer_types is not None
                and len(set(self.layer_types[self.first_k_dense_replace:])) > 1):
            return 0
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def jax_layout(self) -> JaxLayout:
        if not self.num_scanned_layers:
            return JaxLayout(LOOPED)
        return JaxLayout(SUFFIX, self.num_hidden_layers - self.num_scanned_layers)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/zai-org/GLM-4.5-Air: 96 q heads and
    # 8 kv heads of 128, half rotary, biased q/k/v, 128 experts of width
    # 1408 (8 a token, renormalised) and one shared, one dense layer first
    "glm-4.5-air": dict(
        vocab_size=151552,
        hidden_size=4096,
        intermediate_size=10944,
        moe_intermediate_size=1408,
        num_hidden_layers=46,
        num_attention_heads=96,
        num_key_value_heads=8,
        head_dim=128,
        partial_rotary_factor=0.5,
        attention_bias=True,
        use_qk_norm=False,
        n_routed_experts=128,
        n_shared_experts=1,
        num_experts_per_tok=8,
        first_k_dense_replace=1,
        norm_topk_prob=True,
        routed_scaling_factor=1.0,
        n_group=1,
        topk_group=1,
        max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_theta=1000000.0,
        rope_scaling=None,
        pad_token_id=151329,
        eos_token_id=[151329, 151336, 151338],
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> Glm4MoeConfig:
    """A named published configuration, optionally with fields replaced."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return Glm4MoeConfig(**{**base, **overrides})
