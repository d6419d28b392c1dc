"""Bamba (Mamba-2 / attention hybrid) model config, as a dataclass that
validates on construction.

Counterpart of `llm_training_tpu/models/bamba/config.py`: the same fields
and defaults, JAX's validation, the mixer's widths (`mamba_intermediate`,
`mamba_conv_dim`), `rope_config` (rotary over `partial_rotary_factor` of a
head), `layer_is_attention` (`attn_layer_indices`) and `scan_period` (JAX
scans one period of a periodic mamba/attention pattern, and loops the
released placement); `jax_layout` names the JAX tree's layout.

`PRESETS["bamba-9b"]` is the published `config.json` of
ibm-ai-platform/Bamba-9B, written out field by field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, PERIOD, JaxLayout, detect_period
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class BambaConfig(FamilyConfig):
    vocab_size: int = 128000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 262144
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = 0
    bos_token_id: int | None = 1
    eos_token_id: int | list[int] | None = 2
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    partial_rotary_factor: float = 0.5
    attention_bias: bool = False
    attention_dropout: float = 0.0
    mlp_bias: bool = False

    # attention instead of the mixer at these layers (None: every layer mamba)
    attn_layer_indices: list[int] | None = None

    # the Mamba-2 mixer
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_n_groups: int = 1
    mamba_d_state: int = 256
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    mamba_chunk_size: int = 256
    # reset the SSD state (and confine the causal conv) at packed documents'
    # starts; HF leaks the state across them
    segment_state_reset: bool = False

    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None

    def __post_init__(self):
        self._check_common()
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_intermediate:
            raise ValueError(
                "mamba_n_heads * mamba_d_head must equal mamba_expand * hidden_size")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_key_value_heads ({self.num_key_value_heads})")
        if self.mamba_n_heads % self.mamba_n_groups:
            raise ValueError("mamba_n_heads must be divisible by mamba_n_groups")
        if self.attn_layer_indices:
            bad = [i for i in self.attn_layer_indices if not 0 <= i < self.num_hidden_layers]
            if bad:
                raise ValueError(f"attn_layer_indices out of range: {bad}")
        self.rope_config

    @property
    def mamba_intermediate(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def mamba_conv_dim(self) -> int:
        return self.mamba_intermediate + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def resolved_head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta,
                                   int(self.resolved_head_dim * self.partial_rotary_factor),
                                   self.max_position_embeddings)

    def layer_is_attention(self, layer_idx: int) -> bool:
        return bool(self.attn_layer_indices) and layer_idx in self.attn_layer_indices

    @property
    def scan_period(self) -> int:
        """JAX's scan-body depth (0: loop), from the mamba/attention
        repetition."""
        if not self.scan_layers:
            return 0
        return detect_period([self.layer_is_attention(i) for i in range(self.num_hidden_layers)])

    @property
    def jax_layout(self) -> JaxLayout:
        period = self.scan_period
        return JaxLayout(PERIOD, period) if period else JaxLayout(LOOPED)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/ibm-ai-platform/Bamba-9B: 32 layers,
    # attention (32 q and 8 kv heads of 128, rotary on half of each) at
    # layers 9, 18 and 27, Mamba-2 elsewhere (128 heads of 64, one group,
    # d_state 128, expand 2, a 4-tap biased conv, chunks of 256), SwiGLU of
    # 14336 on every layer
    "bamba-9b": dict(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=262144,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        partial_rotary_factor=0.5,
        attn_layer_indices=[9, 18, 27],
        mamba_n_heads=128,
        mamba_d_head=64,
        mamba_n_groups=1,
        mamba_d_state=128,
        mamba_expand=2,
        mamba_d_conv=4,
        mamba_conv_bias=True,
        mamba_proj_bias=False,
        mamba_chunk_size=256,
        pad_token_id=0,
        bos_token_id=1,
        eos_token_id=2,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> BambaConfig:
    """A named published configuration, optionally with fields replaced
    (`num_hidden_layers` with `attn_layer_indices` to cut depth: the
    indices past the cut are dropped)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    merged = {**base, **overrides}
    if "num_hidden_layers" in overrides and "attn_layer_indices" not in overrides:
        merged["attn_layer_indices"] = [
            i for i in base["attn_layer_indices"] if i < overrides["num_hidden_layers"]] or None
    return BambaConfig(**merged)
