"""DeepSeek V2/V3 model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/deepseek/config.py`: the same fields
and defaults (DeepSeek-V3's), JAX's validation, `qk_head_dim`,
`rope_config` (over the rope part of a head), `attention_scale` (yarn's
squared mscale), `layer_is_moe` and `num_scanned_layers`; `jax_layout`
names the JAX tree's layout (`moe_scan_io.py`). `version=2` is
DeepSeek-V2's softmax router (greedy or group-limited greedy), `version=3`
V3's sigmoid router with the selection-correction bias and top-2-sum group
selection.

`PRESETS["deepseek-v2-lite"]` is the published `config.json` of
deepseek-ai/DeepSeek-V2-Lite, written out field by field.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from llm_training_tpu_torch.models.moe_decoder import FamilyConfig
from llm_training_tpu_torch.models.moe_scan_io import LOOPED, SUFFIX, JaxLayout
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf


@dataclass
class DeepseekConfig(FamilyConfig):
    version: int = 3

    vocab_size: int = 129280
    hidden_size: int = 7168
    intermediate_size: int = 18432  # dense layers (the MoE-free prefix)
    num_hidden_layers: int = 61
    num_attention_heads: int = 128
    max_position_embeddings: int = 4096
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    pad_token_id: int | None = None
    bos_token_id: int | None = 0
    eos_token_id: int | list[int] | None = 1
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    # HF's rotation pairs (even, odd) dims; version 3 carries the flag
    rope_interleave: bool = True
    attention_bias: bool = False
    attention_dropout: float = 0.0

    # MLA
    q_lora_rank: int | None = None  # None: a full-rank q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE; n_routed_experts None: every layer dense
    n_routed_experts: int | None = None
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    moe_intermediate_size: int | None = None
    first_k_dense_replace: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    n_group: int | None = None
    topk_group: int | None = None
    topk_method: str = "greedy"  # version 2: 'greedy' or 'group_limited_greedy'
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
        if self.version not in (2, 3):
            raise ValueError(f"version must be 2 or 3, got {self.version!r}")
        if self.topk_method not in ("greedy", "group_limited_greedy"):
            raise ValueError(f"unknown topk_method {self.topk_method!r}")
        self._check_common()
        if self.n_routed_experts is not None:
            if self.moe_intermediate_size is None:
                raise ValueError("n_routed_experts requires moe_intermediate_size")
            if self.n_group is not None:
                if self.n_routed_experts % self.n_group:
                    raise ValueError("n_routed_experts must divide into n_group groups")
                if self.topk_group is None:
                    raise ValueError("n_group requires topk_group")
        self.rope_config  # construct to validate the rope fields

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(self.rope_scaling, self.rope_theta, self.qk_rope_head_dim,
                                   self.max_position_embeddings)

    @property
    def attention_scale(self) -> float:
        """1/sqrt(qk_head_dim), times yarn's mscale squared (HF's
        DeepseekV2/V3Attention)."""
        scale = self.qk_head_dim ** -0.5
        if self.rope_scaling:
            mscale_all_dim = self.rope_scaling.get("mscale_all_dim", 0)
            factor = self.rope_scaling.get("factor")
            if mscale_all_dim and factor and factor > 1:
                mscale = 0.1 * mscale_all_dim * math.log(factor) + 1.0
                scale = scale * mscale * mscale
        return scale

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.n_routed_experts is not None and layer_idx >= self.first_k_dense_replace

    @property
    def num_scanned_layers(self) -> int:
        """Depth of JAX's scanned MoE suffix (0: every layer looped)."""
        if not self.scan_layers or self.n_routed_experts is None:
            return 0
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def jax_layout(self) -> JaxLayout:
        if not self.num_scanned_layers:
            return JaxLayout(LOOPED)
        return JaxLayout(SUFFIX, self.num_hidden_layers - self.num_scanned_layers)


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/deepseek-ai/DeepSeek-V2-Lite: MLA
    # with a full-rank q, 64 routed experts of width 1408 (6 a token) and 2
    # shared ones, one dense layer first, yarn x40
    "deepseek-v2-lite": dict(
        version=2,
        vocab_size=102400,
        hidden_size=2048,
        intermediate_size=10944,
        moe_intermediate_size=1408,
        num_hidden_layers=27,
        num_attention_heads=16,
        q_lora_rank=None,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        n_routed_experts=64,
        n_shared_experts=2,
        num_experts_per_tok=6,
        first_k_dense_replace=1,
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        topk_method="greedy",
        n_group=1,
        topk_group=1,
        max_position_embeddings=163840,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                      "mscale": 0.707, "mscale_all_dim": 0.707,
                      "original_max_position_embeddings": 4096},
        bos_token_id=100000,
        eos_token_id=100001,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> DeepseekConfig:
    """A named published configuration, optionally with fields replaced."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return DeepseekConfig(**{**base, **overrides})
