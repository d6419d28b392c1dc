"""MiniMax (MiniMax-Text-01 / M1) model config, as a dataclass that validates
on construction.

Counterpart of `llm_training_tpu/models/minimax/config.py`: the same fields
and defaults, JAX's validation (`layer_types` required, one MLP width: the
experts', no biases, no shared expert, Mixtral's expert naming),
`rope_config` (rotary over the whole head), `layer_is_linear` and
`scan_period` (JAX scans one lightning/full period, feeding each cycle its
slopes); `jax_layout` names the JAX tree's layout. The MoE block is the
Llama graph's `MoEMLP` under HF's name `block_sparse_moe`.

`PRESETS["minimax-text-01"]` is the published `config.json` of
MiniMaxAI/MiniMax-Text-01 in the fields JAX's config has: its
`attn_type_list` as `layer_types`, its `layernorm_*_alpha/beta` as the six
residual factors, `num_local_experts` as `num_experts`. Its `rotary_dim`
(64 of each 128-wide head) has no field here: JAX's MiniMax, like HF
transformers' port of the model, rotates the whole head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, PERIOD, JaxLayout, detect_period
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf

LAYER_KINDS = ("linear_attention", "full_attention")


@dataclass
class MiniMaxConfig(FamilyConfig):
    vocab_size: int = 32000
    hidden_size: int = 4096
    # derived: HF MiniMax's one width field is the experts'
    intermediate_size: int | None = None
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int | None = None
    max_position_embeddings: int = 4096 * 32
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = None
    bos_token_id: int | None = None
    eos_token_id: int | list[int] | None = None
    tie_word_embeddings: bool = False
    rope_theta: float = 1e6
    rope_scaling: dict[str, Any] | None = None
    attention_bias: bool = False
    attention_dropout: float = 0.0
    sliding_window: int | None = None

    # per-layer 'linear_attention' / 'full_attention' (required: HF's
    # configs always carry the list)
    layer_types: list[str] | None = None
    block_size: int = 256  # the lightning attention's chunk

    # the residual combiners: hidden = residual * alpha + block_out * beta
    full_attn_alpha_factor: float = 1.0
    full_attn_beta_factor: float = 1.0
    linear_attn_alpha_factor: float = 1.0
    linear_attn_beta_factor: float = 1.0
    mlp_alpha_factor: float = 1.0
    mlp_beta_factor: float = 1.0

    # MoE on every layer (Mixtral's: softmax top-k, renormalised)
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None
    norm_topk_prob: bool = True
    shared_expert_intermediate_size: int | None = None
    router_aux_loss_coef: float = 0.001
    moe_style: str = "mixtral"
    moe_impl: str = "auto"
    ep_capacity_factor: float = 2.0
    mlp_bias: bool = False

    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"

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
        if self.layer_types is None:
            raise ValueError(
                "layer_types is required (HF MiniMax configs always carry the "
                "materialized list)")
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"layer_types has {len(self.layer_types)} entries for "
                             f"{self.num_hidden_layers} layers")
        if self.num_experts is None or self.moe_intermediate_size is None:
            raise ValueError(
                "MiniMax requires num_experts and moe_intermediate_size "
                "(the architecture is MoE-only)")
        if self.intermediate_size is None:
            self.intermediate_size = self.moe_intermediate_size
        elif self.intermediate_size != self.moe_intermediate_size:
            raise ValueError(
                "MiniMax has one MLP width: intermediate_size must equal "
                "moe_intermediate_size (HF stores only the expert width)")
        if self.attention_bias or self.mlp_bias:
            raise ValueError(
                "HF MiniMax has no projection biases; the conversion would "
                "silently drop them")
        if self.shared_expert_intermediate_size is not None:
            raise ValueError("HF MiniMax has no shared expert")
        if self.moe_style != "mixtral":
            raise ValueError("MiniMax experts use the mixtral naming scheme")
        bad = set(self.layer_types) - set(LAYER_KINDS)
        if bad:
            raise ValueError(
                f"unknown layer_types entries {sorted(bad)}; expected "
                "'linear_attention' or 'full_attention'")
        self.rope_config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.resolved_head_dim,
                                   self.max_position_embeddings)

    def layer_is_linear(self, layer_idx: int) -> bool:
        return self.layer_types[layer_idx] == "linear_attention"

    @property
    def scan_period(self) -> int:
        """JAX's scan-body depth (0: loop), from the `layer_types`
        repetition."""
        if not self.scan_layers:
            return 0
        return detect_period(self.layer_types)

    @property
    def jax_layout(self) -> JaxLayout:
        period = self.scan_period
        return JaxLayout(PERIOD, period) if period else JaxLayout(LOOPED)


# MiniMax-Text-01's residual factors: alpha (2 x 80 layers) ** 0.25, beta 1
_ALPHA = (2 * 80) ** 0.25

PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/MiniMaxAI/MiniMax-Text-01: 80 layers,
    # softmax attention on every 8th (64 q and 8 kv heads of 128), lightning
    # attention elsewhere (64 heads of 128, blocks of 256), 32 experts of
    # 9216 (2 a token) on every layer, rope theta 1e7
    "minimax-text-01": dict(
        vocab_size=200064,
        hidden_size=6144,
        moe_intermediate_size=9216,
        num_hidden_layers=80,
        num_attention_heads=64,
        num_key_value_heads=8,
        head_dim=128,
        max_position_embeddings=10240000,
        rms_norm_eps=1e-5,
        rope_theta=10000000.0,
        layer_types=["full_attention" if i % 8 == 7 else "linear_attention" for i in range(80)],
        block_size=256,
        full_attn_alpha_factor=_ALPHA,
        full_attn_beta_factor=1.0,
        linear_attn_alpha_factor=_ALPHA,
        linear_attn_beta_factor=1.0,
        mlp_alpha_factor=_ALPHA,
        mlp_beta_factor=1.0,
        num_experts=32,
        num_experts_per_tok=2,
        router_aux_loss_coef=0.001,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> MiniMaxConfig:
    """A named published configuration, optionally with fields replaced
    (`num_hidden_layers` with `layer_types` to cut depth)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    merged = {**base, **overrides}
    if "num_hidden_layers" in overrides and "layer_types" not in overrides:
        merged["layer_types"] = base["layer_types"][:overrides["num_hidden_layers"]]
    return MiniMaxConfig(**merged)
