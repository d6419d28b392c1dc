"""Qwen3-Next model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/qwen3_next/config.py`: the same
fields and defaults, JAX's validation, `rope_config` (rotary over
`partial_rotary_factor` of a head), `layer_is_linear` (HF's default: full
attention on every 4th layer) and `scan_period` (JAX scans one period of
the linear/full pattern as its body); `jax_layout` names the JAX tree's
layout (`moe_scan_io.py`). The MoE block is the Llama graph's `MoEMLP`
(qwen-style: softmax top-k, a sigmoid-gated shared expert), which reads the
routing knobs below that JAX's block takes by default.

`PRESETS["qwen3-next-80b-a3b"]` is the published `config.json` of
Qwen/Qwen3-Next-80B-A3B-Instruct, written out field by field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, PERIOD, JaxLayout, detect_period
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class Qwen3NextConfig(FamilyConfig):
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 256
    max_position_embeddings: int = 32768
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    pad_token_id: int | None = None
    bos_token_id: int | None = None
    eos_token_id: int | list[int] | None = None
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    partial_rotary_factor: float = 0.25
    attention_bias: bool = False
    attention_dropout: float = 0.0
    mlp_bias: bool = False

    # per-layer 'linear_attention' / 'full_attention'; None: HF's default
    # (full attention on every 4th layer)
    layer_types: list[str] | None = None

    # gated DeltaNet (the linear-attention layers)
    linear_num_key_heads: int = 16
    linear_num_value_heads: int = 32
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    delta_chunk_size: int = 64
    # reset the DeltaNet state (and confine the causal conv) at packed
    # documents' starts; HF leaks the state across them
    segment_state_reset: bool = False

    # MoE on every layer (None: the dense SwiGLU MLP)
    num_experts: int | None = None
    num_experts_per_tok: int = 10
    moe_intermediate_size: int | None = None
    norm_topk_prob: bool = True
    shared_expert_intermediate_size: int | None = None
    router_aux_loss_coef: float = 0.001
    moe_impl: str = "auto"
    ep_capacity_factor: float = 2.0

    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"
    moe_style: str = "qwen"

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None

    # `MoEMLP`'s routing knobs at the values JAX's block takes for this
    # family (class attributes, not fields)
    shared_expert_gated = True
    moe_router_impl = "softmax"
    moe_capacity_factor = 1.25

    def __post_init__(self):
        self._check_common()
        if self.layer_types is not None and len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"layer_types has {len(self.layer_types)} entries for "
                             f"{self.num_hidden_layers} layers")
        if self.linear_num_value_heads % self.linear_num_key_heads:
            raise ValueError(
                "linear_num_value_heads must be a multiple of linear_num_key_heads")
        if self.num_experts is not None and self.moe_intermediate_size is None:
            raise ValueError("num_experts requires moe_intermediate_size")
        self.rope_config

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta,
                                   int(self.head_dim * self.partial_rotary_factor),
                                   self.max_position_embeddings)

    def layer_is_linear(self, layer_idx: int) -> bool:
        kind = (self.layer_types[layer_idx] if self.layer_types is not None
                else "full_attention" if layer_idx % 4 == 3 else "linear_attention")
        return kind == "linear_attention"

    @property
    def scan_period(self) -> int:
        """JAX's scan-body depth (0: loop): 4 for the stock 3 x linear +
        full pattern."""
        if not self.scan_layers:
            return 0
        return detect_period([self.layer_is_linear(i) for i in range(self.num_hidden_layers)])

    @property
    def jax_layout(self) -> JaxLayout:
        period = self.scan_period
        return JaxLayout(PERIOD, period) if period else JaxLayout(LOOPED)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/Qwen/Qwen3-Next-80B-A3B-Instruct: 48
    # layers (gated DeltaNet, full attention every 4th), 16 q and 2 kv heads
    # of 256 with rotary on a quarter of each, DeltaNet 16 key and 32 value
    # heads of 128 with a 4-tap conv, 512 experts of 512 (10 a token) and a
    # gated shared expert of 512
    "qwen3-next-80b-a3b": dict(
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=5120,
        num_hidden_layers=48,
        num_attention_heads=16,
        num_key_value_heads=2,
        head_dim=256,
        max_position_embeddings=262144,
        rms_norm_eps=1e-6,
        rope_theta=10000000.0,
        partial_rotary_factor=0.25,
        layer_types=["full_attention" if i % 4 == 3 else "linear_attention" for i in range(48)],
        linear_num_key_heads=16,
        linear_num_value_heads=32,
        linear_key_head_dim=128,
        linear_value_head_dim=128,
        linear_conv_kernel_dim=4,
        num_experts=512,
        num_experts_per_tok=10,
        moe_intermediate_size=512,
        norm_topk_prob=True,
        shared_expert_intermediate_size=512,
        router_aux_loss_coef=0.001,
        bos_token_id=151643,
        eos_token_id=151645,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> Qwen3NextConfig:
    """A named published configuration, optionally with fields replaced
    (`num_hidden_layers` with `layer_types` to cut depth)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    merged = {**base, **overrides}
    if "num_hidden_layers" in overrides and "layer_types" not in overrides:
        merged["layer_types"] = base["layer_types"][:overrides["num_hidden_layers"]]
    return Qwen3NextConfig(**merged)
