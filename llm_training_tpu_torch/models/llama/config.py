"""Llama model config, as a dataclass that validates on construction.

Counterpart of `llm_training_tpu/models/llama/config.py`. Field names are
the JAX package's (which are HF's), and every JAX field is accepted. The
Llama graph's variants are ported: norm schemes and types, qk-norm, biases,
partial and interleaved rotary, learned positions, per-layer windows and
NoPE layers, the Granite multipliers and the non-gated MLPs (with Phi-3
over the same stack, `models/phi3/`), and so is the MoE stack
(`num_experts` and its fields, validated as JAX validates them: a config
is all-MoE or all-dense). The fields of a mesh's pipeline raise
`NotImplementedError` when set to anything but the one-device value,
naming ROADMAP A.9b.
`bos_token_id` and `pre_trained_weights` are carried as JAX carries them
(`lms/base.py` loads the HF directory the latter names), and
`attention_dropout` raises unless 0.0, as JAX's does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Any

import torch

from llm_training_tpu_torch.models.base import resolve_dtype
from llm_training_tpu_torch.ops.rope_utils import RoPEConfig, rope_config_from_hf

# the choices of JAX's Literal fields
_CHOICES = {
    "norm_scheme": ("pre", "post", "parallel", "parallel2", "sandwich"),
    "norm_type": ("rmsnorm", "layernorm", "layernorm_nobias", "layernorm1p",
                  "layernorm_nonparam"),
    "mlp_type": ("swiglu", "gelu", "relu2", "xielu"),
    "qk_norm_scope": ("head", "full"),
    "qk_norm_position": ("pre_rope", "post_rope"),
    "position_embedding_type": ("rope", "learned"),
    "moe_style": ("qwen", "mixtral", "granite"),
    "moe_router_impl": ("softmax", "sparsemixer"),
    "moe_impl": ("auto", "dense", "ragged", "bucketed"),
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
    # that `frozen_modules` patterns match (optim/builder.py). None is
    # JAX's default (True), which `layer_types` and `no_rope_layers` turn
    # off; an explicit True beside them raises, as in JAX
    scan_layers: bool | None = None
    # the Llama graph's variants (see the JAX config for each family):
    # 'pre' Llama; 'post' OLMo-2 (norm each block's output, no input
    # norms); 'parallel' Cohere/Phi (one input norm feeds attention and
    # mlp, one residual add); 'parallel2' GPT-NeoX (two norms over the same
    # input); 'sandwich' GLM-4 (input and output norms around both blocks)
    norm_scheme: str = "pre"
    # 'layernorm' biased (Starcoder2), 'layernorm_nobias' Cohere's
    # weight-only, 'layernorm1p' Nemotron's (1 + w), 'layernorm_nonparam'
    # OLMo-1's without parameters
    norm_type: str = "rmsnorm"
    # 'gelu' c_fc -> gelu -> c_proj, 'relu2' up -> relu^2 -> down, 'xielu'
    # Apertus' up -> xIELU -> down with two learnable scalars
    mlp_type: str = "swiglu"
    # per-head RMSNorm on q and k (Qwen3); scope 'full' is OLMo-2's one
    # norm over the projected width; HunYuan applies it after rotary
    qk_norm: bool = False
    qk_norm_scope: str = "head"
    qk_norm_position: str = "pre_rope"
    # OLMo: clamp q/k/v to [-clip_qkv, clip_qkv] after the projections
    clip_qkv: float | None = None
    # Phi: rotate only the first int(factor * head_dim) dims of each head
    partial_rotary_factor: float = 1.0
    # GPT-2: learned absolute positions (wpe) instead of rotary
    position_embedding_type: str = "rope"
    # per-layer 'sliding_attention' / 'full_attention' (OLMo-3, Ministral,
    # EXAONE-4, Cohere2); sliding layers take sliding_window
    layer_types: list[str] | None = None
    attention_bias: bool = False
    mlp_bias: bool = False
    # None follows attention_bias, as in JAX
    attention_out_bias: bool | None = None
    lm_head_bias: bool = False
    # Granite's multipliers (None: the standard 1/sqrt(head_dim) scale)
    attention_multiplier: float | None = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # Cohere's multiplicative logit scale
    logit_scale: float | None = None
    # OLMo-3: sliding layers rotate with the unscaled tables. None is
    # JAX's "not set", resolved by its back-compat rule
    dual_local_rope: bool | None = None
    # SmolLM3 NoPE: per-layer rope flags (1 rotate, 0 NoPE)
    no_rope_layers: list[int] | None = None
    # Cohere/GLM/Ernie/Helium: (even, odd) rotation pairs
    rope_interleaved: bool = False
    # GPT-NeoX checkpoint naming (gpt_neox. prefix, fused query_key_value)
    neox_naming: bool = False
    # GLM: gate and up stored as one gate_up_proj in HF files
    fused_gate_up: bool = False
    # tanh-approximate gelu (exact for GPT-NeoX's 'gelu')
    gelu_approximate: bool = True
    # the MoE stack (models/moe.py); None is dense. `moe_style` names the
    # HF expert layout (qwen, mixtral, granite), `moe_impl` the dispatch
    # ('auto': grouped GEMMs on CUDA, the exact dense path on the CPU)
    num_experts: int | None = None
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
        for name, value in _ONE_DEVICE_ONLY.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported (only {value!r}; "
                    "ROADMAP A.9b)"
                )
        for name, choices in _CHOICES.items():
            if getattr(self, name) not in choices:
                raise ValueError(f"{name} must be one of {choices}, got {getattr(self, name)!r}")
        if self.attention_dropout != 0.0:
            # as JAX: fail loudly rather than train without the dropout asked for
            raise ValueError("attention_dropout is not supported; set it to 0.0")
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be divisible "
                f"by num_key_value_heads ({self.num_key_value_heads})"
            )
        if self.num_experts is not None:
            if self.mlp_type != "swiglu":
                raise ValueError("MoE layers only support the swiglu mlp_type")
            if (self.moe_style == "granite" and self.shared_expert_intermediate_size
                    and self.shared_expert_gated):
                # the granite layout has no gate tensor: export would drop it
                raise ValueError(
                    "moe_style='granite' shared experts are always-on; set "
                    "shared_expert_gated=False (granitemoeshared has no "
                    "shared gate parameter)"
                )
            if self.moe_intermediate_size is None:
                raise ValueError("num_experts requires moe_intermediate_size")
            if not 0 < self.num_experts_per_tok <= self.num_experts:
                raise ValueError(
                    f"num_experts_per_tok ({self.num_experts_per_tok}) must be "
                    f"in [1, num_experts={self.num_experts}]"
                )
        if self.recompute_granularity not in ("full", "selective"):
            raise ValueError(
                f"recompute_granularity must be 'full' or 'selective', got "
                f"{self.recompute_granularity!r}"
            )
        if self.attention_impl not in ("auto", "xla", "pallas", "torch", "kernel"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        explicit_scan = self.scan_layers is not None
        if self.scan_layers is None:
            self.scan_layers = True
        dual_set = self.dual_local_rope is not None
        if not dual_set:
            self.dual_local_rope = False
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_hidden_layers:
                raise ValueError(
                    f"layer_types has {len(self.layer_types)} entries for "
                    f"{self.num_hidden_layers} layers"
                )
            bad = set(self.layer_types) - {"sliding_attention", "full_attention"}
            if bad:
                raise ValueError(
                    f"unknown layer_types entries {sorted(bad)}; expected "
                    "'sliding_attention' or 'full_attention'"
                )
            if "sliding_attention" in self.layer_types and not self.sliding_window:
                raise ValueError("sliding layer_types require sliding_window")
            # per-layer windows and ropes: JAX's looped layout
            if self.scan_layers and explicit_scan:
                raise ValueError("layer_types requires looped layers; set scan_layers=False")
            self.scan_layers = False
            # JAX's back-compat rule: layer_types + rope_scaling under
            # post-norm (OLMo-3's signature) means dual tables unless set
            if not dual_set and self.rope_scaling and self.norm_scheme == "post":
                self.dual_local_rope = True
        if self.no_rope_layers is not None:
            if self.position_embedding_type == "learned":
                raise ValueError("no_rope_layers is meaningless with learned positions")
            if len(self.no_rope_layers) != self.num_hidden_layers:
                raise ValueError(
                    f"no_rope_layers has {len(self.no_rope_layers)} entries "
                    f"for {self.num_hidden_layers} layers"
                )
            if self.scan_layers and explicit_scan:
                raise ValueError(
                    "no_rope_layers requires looped layers; set scan_layers=False"
                )
            self.scan_layers = False
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
    def rotary_dim(self) -> int:
        """The rotated dims of a head (Phi's partial rotary)."""
        return int(self.resolved_head_dim * self.partial_rotary_factor)

    @property
    def rope_config(self) -> RoPEConfig:
        return rope_config_from_hf(
            self.rope_scaling, self.rope_theta, self.rotary_dim, self.max_position_embeddings,
        )

    @property
    def local_rope_config(self) -> RoPEConfig:
        """OLMo-3's sliding layers: the same theta, never scaled."""
        return rope_config_from_hf(None, self.rope_theta, self.rotary_dim,
                                   self.max_position_embeddings)

    def layer_sliding_window(self, layer_idx: int) -> int | None:
        """The window of layer `layer_idx`: `sliding_window` everywhere, or
        on the sliding layers of `layer_types` only."""
        if self.layer_types is None or self.layer_types[layer_idx] == "sliding_attention":
            return self.sliding_window
        return None

    def layer_rotates(self, layer_idx: int) -> bool:
        """Whether layer `layer_idx` applies rotary (not learned positions,
        not a NoPE layer)."""
        if self.position_embedding_type == "learned":
            return False
        return self.no_rope_layers is None or bool(self.no_rope_layers[layer_idx])

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


PRESETS: dict[str, dict[str, Any]] = {
    # the config.json of huggingface.co/meta-llama/Llama-3.1-8B
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
    # the config.json of huggingface.co/Qwen/Qwen3-8B: per-head qk-norm, no
    # biases, no rope scaling, untied
    "qwen3-8b": dict(
        vocab_size=151936,
        hidden_size=4096,
        intermediate_size=12288,
        num_hidden_layers=36,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        max_position_embeddings=40960,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        rope_scaling=None,
        qk_norm=True,
        qk_norm_scope="head",
        attention_bias=False,
        bos_token_id=151643,
        eos_token_id=151645,
        tie_word_embeddings=False,
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
    ),
    # the config.json of huggingface.co/Qwen/Qwen3-30B-A3B: 128 experts of
    # width 768, 8 a token (renormalised), per-head qk-norm, untied
    "qwen3-30b-a3b": dict(
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=6144,
        num_hidden_layers=48,
        num_attention_heads=32,
        num_key_value_heads=4,
        head_dim=128,
        max_position_embeddings=40960,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        rope_scaling=None,
        qk_norm=True,
        qk_norm_scope="head",
        attention_bias=False,
        num_experts=128,
        num_experts_per_tok=8,
        moe_intermediate_size=768,
        norm_topk_prob=True,
        router_aux_loss_coef=0.001,
        bos_token_id=151643,
        eos_token_id=151645,
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
