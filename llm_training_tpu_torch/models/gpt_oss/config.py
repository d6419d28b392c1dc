"""gpt-oss model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/gpt_oss/config.py`: the same fields
and defaults (gpt-oss-120b's widths), JAX's validation, `rope_config`,
`layer_sliding_window` (HF's default alternation: sliding on even layers)
and `scan_period` (JAX scans one sliding/full period as its body);
`jax_layout` names the JAX tree's layout (`moe_scan_io.py`).

`PRESETS["gpt-oss-20b"]` is the published `config.json` of
openai/gpt-oss-20b, written out field by field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, PERIOD, JaxLayout, detect_period
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class GptOssConfig(FamilyConfig):
    vocab_size: int = 201088
    hidden_size: int = 2880
    intermediate_size: int = 2880  # an expert's width
    num_hidden_layers: int = 36
    num_attention_heads: int = 64
    num_key_value_heads: int = 8
    head_dim: int = 64
    max_position_embeddings: int = 131072
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5
    pad_token_id: int | None = None
    bos_token_id: int | None = None
    eos_token_id: int | list[int] | None = None
    tie_word_embeddings: bool = False
    rope_theta: float = 150000.0
    rope_scaling: dict[str, Any] | None = None
    attention_bias: bool = True
    attention_dropout: float = 0.0
    sliding_window: int | None = 128
    # per-layer 'sliding_attention' / 'full_attention'; None: sliding on
    # even layers (HF's default)
    layer_types: list[str] | None = None

    # MoE on every layer
    num_local_experts: int = 128
    num_experts_per_tok: int = 4
    router_aux_loss_coef: float = 0.9
    moe_impl: str = "auto"
    ep_capacity_factor: float = 2.0

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pre_trained_weights: str | None = None
    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    scan_layers: bool = True
    attention_impl: str = "auto"
    ring_attention: bool = False

    def __post_init__(self):
        self._check_common()
        if self.layer_types is not None and len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"layer_types has {len(self.layer_types)} entries for "
                             f"{self.num_hidden_layers} layers")
        if self.num_experts_per_tok > self.num_local_experts:
            raise ValueError("num_experts_per_tok exceeds num_local_experts")
        if self.tie_word_embeddings:
            raise ValueError("gpt-oss does not tie word embeddings")
        self.rope_config

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.head_dim,
                                   self.max_position_embeddings)

    def layer_sliding_window(self, layer_idx: int) -> int | None:
        if not self.sliding_window:
            return None
        kind = (self.layer_types[layer_idx] if self.layer_types is not None
                else "sliding_attention" if layer_idx % 2 == 0 else "full_attention")
        return self.sliding_window if kind == "sliding_attention" else None

    @property
    def scan_period(self) -> int:
        """JAX's scan-body depth (0: loop): 2 for the stock alternation, 1
        when every layer has one window."""
        if not self.scan_layers:
            return 0
        return detect_period([self.layer_sliding_window(i)
                              for i in range(self.num_hidden_layers)])

    @property
    def jax_layout(self) -> JaxLayout:
        period = self.scan_period
        return JaxLayout(PERIOD, period) if period else JaxLayout(LOOPED)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/openai/gpt-oss-20b: 24 layers
    # alternating a 128-token window and full attention, 64 q heads and 8
    # kv heads of 64 with sinks, 32 experts of width 2880 (4 a token), yarn
    # x32 without truncation
    "gpt-oss-20b": dict(
        vocab_size=201088,
        hidden_size=2880,
        intermediate_size=2880,
        num_hidden_layers=24,
        num_attention_heads=64,
        num_key_value_heads=8,
        head_dim=64,
        attention_bias=True,
        sliding_window=128,
        layer_types=["sliding_attention" if i % 2 == 0 else "full_attention"
                     for i in range(24)],
        num_local_experts=32,
        num_experts_per_tok=4,
        router_aux_loss_coef=0.9,
        max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                      "original_max_position_embeddings": 4096, "truncate": False},
        pad_token_id=199999,
        eos_token_id=200002,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> GptOssConfig:
    """A named published configuration, optionally with fields replaced
    (`num_hidden_layers` with `layer_types` to cut depth)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    merged = {**base, **overrides}
    if "num_hidden_layers" in overrides and "layer_types" not in overrides:
        merged["layer_types"] = base["layer_types"][:overrides["num_hidden_layers"]]
    return GptOssConfig(**merged)
