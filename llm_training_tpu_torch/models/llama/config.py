"""Llama model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/llama/config.py`. Field names are
the JAX package's (which are HF's), and every JAX field is accepted. Only
the plain Llama decoder is ported (with Phi-3 over it, `models/phi3/`):
fields that select another architecture (or a mesh layout) raise
`NotImplementedError` when set to anything but the Llama value, naming the
ROADMAP queue that brings them. `bos_token_id` and `pre_trained_weights`
are carried as JAX carries them (`lms/base.py` loads the HF directory the
latter names), and `attention_dropout` raises unless 0.0, as JAX's does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Any

import torch

from llm_training_tpu_torch.models.base import resolve_dtype
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf

# field -> the only value the port implements (JAX's default), for fields
# that select another family or the MoE stack (ROADMAP A.8)
_LLAMA_ONLY = {
    "num_experts": None,
    "norm_scheme": "pre",
    "norm_type": "rmsnorm",
    "mlp_type": "swiglu",
    "qk_norm": False,
    "clip_qkv": None,
    "partial_rotary_factor": 1.0,
    "position_embedding_type": "rope",
    "layer_types": None,
    "attention_bias": False,
    "mlp_bias": False,
    "attention_out_bias": False,
    "lm_head_bias": False,
    "attention_multiplier": None,
    "embedding_multiplier": 1.0,
    "residual_multiplier": 1.0,
    "logits_scaling": 1.0,
    "logit_scale": None,
    "dual_local_rope": False,
    "no_rope_layers": None,
    "rope_interleaved": False,
    "neox_naming": False,
    "fused_gate_up": False,
    "gelu_approximate": True,
    "qk_norm_position": "pre_rope",
    "qk_norm_scope": "head",
    "num_experts_per_tok": 2,
    "moe_intermediate_size": None,
    "shared_expert_intermediate_size": None,
    "shared_expert_gated": True,
    "norm_topk_prob": True,
    "moe_style": "qwen",
    "moe_impl": "auto",
    "moe_router_impl": "softmax",
    "moe_capacity_factor": 1.25,
    "ep_capacity_factor": 2.0,
    "router_aux_loss_coef": 0.001,
    "router_jitter_eps": 0.01,
}
# the same for pipeline parallelism (ROADMAP A.9b)
_ONE_DEVICE_ONLY = {
    "pipeline_stages": 1,
    "pipeline_microbatches": None,
}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int | None = None  # defaults to hidden_size // num_attention_heads
    max_position_embeddings: int = 4096
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    bos_token_id: int | None = 1
    eos_token_id: int | list[int] | None = 2
    pad_token_id: int | None = None  # generate's left-pad id (0 when None)
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    sliding_window: int | None = None
    attention_dropout: float = 0.0  # JAX refuses anything else
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # an HF checkpoint to initialize from (the objective's own field wins)
    pre_trained_weights: str | None = None
    # training: activation checkpointing per decoder layer (models/remat.py)
    # and the attention path (ops/attention.py: 'auto' = the flash kernels
    # on CUDA; JAX's 'xla' / 'pallas' name the plain path / the kernels)
    enable_gradient_checkpointing: bool = False
    recompute_granularity: str = "full"
    attention_impl: str = "auto"
    # the JAX parameter tree's layout (one scanned `layers/layer` stack, or
    # `layers_{i}`): it changes nothing the port computes, only the paths
    # that `frozen_modules` patterns match (optim/builder.py)
    scan_layers: bool = True
    # architecture selectors of the JAX config; only the Llama values are ported
    num_experts: int | None = None
    norm_scheme: str = "pre"
    norm_type: str = "rmsnorm"
    mlp_type: str = "swiglu"
    qk_norm: bool = False
    clip_qkv: float | None = None
    partial_rotary_factor: float = 1.0
    position_embedding_type: str = "rope"
    layer_types: list[str] | None = None
    attention_bias: bool = False
    mlp_bias: bool = False
    # None follows attention_bias, as in JAX
    attention_out_bias: bool | None = None
    lm_head_bias: bool = False
    attention_multiplier: float | None = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    logit_scale: float | None = None
    dual_local_rope: bool = False
    no_rope_layers: list[int] | None = None
    rope_interleaved: bool = False
    neox_naming: bool = False
    fused_gate_up: bool = False
    gelu_approximate: bool = True
    qk_norm_position: str = "pre_rope"
    qk_norm_scope: str = "head"
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None
    shared_expert_intermediate_size: int | None = None
    shared_expert_gated: bool = True
    norm_topk_prob: bool = True
    moe_style: str = "qwen"
    moe_impl: str = "auto"
    moe_router_impl: str = "softmax"
    moe_capacity_factor: float = 1.25
    ep_capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.001
    router_jitter_eps: float = 0.01
    ring_attention: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: int | None = None

    def __post_init__(self):
        if self.attention_out_bias is None:
            self.attention_out_bias = self.attention_bias
        for queue, only in (("A.8", _LLAMA_ONLY), ("A.9b", _ONE_DEVICE_ONLY)):
            for name, value in only.items():
                if getattr(self, name) != value:
                    raise NotImplementedError(
                        f"{name}={getattr(self, name)!r} is not ported (only {value!r}; "
                        f"ROADMAP {queue})"
                    )
        if self.attention_dropout != 0.0:
            # as JAX: fail loudly rather than train without the dropout asked for
            raise ValueError("attention_dropout is not supported; set it to 0.0")
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be divisible "
                f"by num_key_value_heads ({self.num_key_value_heads})"
            )
        if self.recompute_granularity not in ("full", "selective"):
            raise ValueError(
                f"recompute_granularity must be 'full' or 'selective', got "
                f"{self.recompute_granularity!r}"
            )
        if self.attention_impl not in ("auto", "xla", "pallas", "torch", "kernel"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        resolve_dtype(self.compute_dtype)
        resolve_dtype(self.param_dtype)
        self.rope_config  # construct to validate the rope fields

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(
            self.rope_scaling, self.rope_theta, self.resolved_head_dim,
            self.max_position_embeddings,
        )

    @classmethod
    def from_dict(cls, data: dict[str, Any], where: str = "config") -> "LlamaConfig":
        """From a mapping of this dataclass's fields; unknown keys raise."""
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown LlamaConfig fields {unknown} in {where}")
        return cls(**data)

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        """A config file is a JSON object of this dataclass's fields."""
        with open(path) as f:
            return cls.from_dict(json.load(f), path)


# meta-llama/Llama-3.1-8B config.json widths
PRESETS: dict[str, dict[str, Any]] = {
    "llama-3.1-8b": dict(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
        },
        eos_token_id=128001,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
}


def preset(name: str, **overrides: Any) -> LlamaConfig:
    """A named published configuration, optionally with fields replaced
    (e.g. `num_hidden_layers` to cut depth)."""
    try:
        base = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; expected one of {sorted(PRESETS)}") from None
    return LlamaConfig(**{**base, **overrides})
