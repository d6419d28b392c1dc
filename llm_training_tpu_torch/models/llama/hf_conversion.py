"""Llama <-> HuggingFace state-dict and config conversion.

Counterpart of `llm_training_tpu/models/llama/hf_conversion.py`. The
port's `Llama` carries HF's parameter names (`model.layers.{i}.self_attn.
q_proj.weight`, torch's `[out, in]` layout), so the weights map one to
one: `params_from_hf` reads layers `0..num_hidden_layers-1` of the plain
Llama key set (a deeper checkpoint gives its first layers, as in JAX) and
hands each tensor to `leaf_fn` before it reads the next; `params_to_hf`
writes JAX's key set in JAX's order.

`config_from_hf` maps every HF `model_type` to the field values JAX's does
(`config_fields_from_hf`, the whole mapping); the port's `LlamaConfig`
then refuses, naming ROADMAP A.8, what it cannot run (qwen2's
`attention_bias`, any MoE, norm or MLP variant). `config_to_hf` writes a
`llama` config, or `mistral` when a sliding window is set: JAX's other
export overlays select fields that `LlamaConfig` refuses.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from llm_training_tpu_torch.models.llama.config import LlamaConfig

# in-layer HF names, in JAX's export order
LAYER_PARAMS = (
    "self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
    "self_attn.o_proj.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight",
    "mlp.down_proj.weight", "input_layernorm.weight", "post_attention_layernorm.weight",
)

LeafFn = Callable[[str, torch.Tensor], torch.Tensor]


def canonical_keys(state_dict: Mapping[str, Any]) -> dict[str, str]:
    """`{name without the "model." prefix: the state dict's key}`: HF
    checkpoints are read with or without the prefix, as JAX reads them."""
    return {key.removeprefix("model."): key for key in state_dict}


def read(state_dict: Mapping[str, Any], keys: Mapping[str, str], name: str) -> torch.Tensor:
    """The tensor of canonical `name`; a missing key names the layout."""
    try:
        return state_dict[keys[name]]
    except KeyError:
        raise KeyError(
            f"HF checkpoint has no {name!r}: the port reads the plain Llama key set only "
            "(other layouts: ROADMAP A.8)"
        ) from None


def params_from_hf(
    state_dict: Mapping[str, Any], config: LlamaConfig, leaf_fn: LeafFn | None = None
) -> dict[str, torch.Tensor]:
    """HF state dict (a lazy mapping) -> the port's `Llama` state dict.
    `leaf_fn(name, tensor)` transforms each tensor as soon as it is read
    (`hf_io` places it on the device and drops the host copy)."""
    keys = canonical_keys(state_dict)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, canonical: str) -> None:
        value = read(state_dict, keys, canonical)
        out[name] = leaf_fn(name, value) if leaf_fn else value

    put("model.embed_tokens.weight", "embed_tokens.weight")
    put("model.norm.weight", "norm.weight")
    if not config.tie_word_embeddings:
        put("lm_head.weight", "lm_head.weight")
    for i in range(config.num_hidden_layers):
        for name in LAYER_PARAMS:
            put(f"model.layers.{i}.{name}", f"layers.{i}.{name}")
    return out


def params_to_hf(params: Mapping[str, torch.Tensor], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """The port's `Llama` state dict -> HF `model.*` keys, in JAX's order
    (embeddings, final norm, head, then each layer parameter over depth)."""
    names = ["model.embed_tokens.weight", "model.norm.weight"]
    if not config.tie_word_embeddings:
        names.append("lm_head.weight")
    names += [f"model.layers.{i}.{name}" for name in LAYER_PARAMS
              for i in range(config.num_hidden_layers)]
    return {name: params[name] for name in names}


def config_to_hf(config: LlamaConfig, torch_dtype: str = "bfloat16") -> dict[str, Any]:
    """The port's LlamaConfig -> HF `config.json` dict (as JAX's)."""
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.resolved_head_dim,
        "hidden_act": "silu",
        "max_position_embeddings": config.max_position_embeddings,
        "initializer_range": config.initializer_range,
        "rms_norm_eps": config.rms_norm_eps,
        "pad_token_id": config.pad_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "tie_word_embeddings": config.tie_word_embeddings,
        "rope_theta": config.rope_theta,
        "rope_scaling": config.rope_scaling,
        "attention_bias": config.attention_bias,
        "attention_dropout": config.attention_dropout,
        "mlp_bias": config.mlp_bias,
        "use_cache": True,
        "torch_dtype": torch_dtype,
        # HF's LlamaConfig has no sliding_window; MistralConfig shares the layout
        **(
            {"model_type": "mistral", "architectures": ["MistralForCausalLM"],
             "sliding_window": config.sliding_window}
            if config.sliding_window
            else {}
        ),
    }


def _derived_no_rope(layer_types) -> list[int]:
    """EXAONE-4's and Cohere2's rule: sliding layers rotate (1), full
    layers skip rope (0)."""
    return [1 if lt == "sliding_attention" else 0 for lt in layer_types]


def config_fields_from_hf(hf_config: Any, **overrides: Any) -> dict[str, Any]:
    """HF config (object or dict) -> the LlamaConfig fields JAX's
    `config_from_hf` sets, for every model_type it routes to the Llama
    family; `overrides` win. Raises JAX's ValueErrors for what JAX refuses."""
    get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
        lambda k, d=None: getattr(hf_config, k, d)
    )
    model_type = get("model_type")
    if model_type == "gpt2":
        for drop in ("embd_pdrop", "attn_pdrop", "resid_pdrop"):
            if get(drop, 0.0):
                raise ValueError(
                    f"gpt2 {drop}={get(drop)} is not supported: dropout is "
                    "not implemented — override it to 0.0"
                )
        if get("scale_attn_by_inverse_layer_idx") or get("reorder_and_upcast_attn"):
            raise ValueError(
                "gpt2 scale_attn_by_inverse_layer_idx / reorder_and_upcast_attn "
                "are not supported"
            )
        if not get("scale_attn_weights", True):
            raise ValueError(
                "gpt2 scale_attn_weights=False is not supported (attention "
                "always scales by 1/sqrt(head_dim) here)"
            )
        if get("activation_function", "gelu_new") not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(
                f"gpt2 activation_function={get('activation_function')!r} is "
                "not supported; only the tanh-approximate gelu is implemented"
            )
        return {**dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("n_embd"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            num_hidden_layers=get("n_layer"),
            num_attention_heads=get("n_head"),
            num_key_value_heads=get("n_head"),
            max_position_embeddings=get("n_positions", 1024),
            initializer_range=get("initializer_range", 0.02),
            rms_norm_eps=get("layer_norm_epsilon", 1e-5),
            bos_token_id=get("bos_token_id", 50256),
            eos_token_id=get("eos_token_id", 50256),
            tie_word_embeddings=True,
            position_embedding_type="learned",
            norm_type="layernorm",
            mlp_type="gelu",
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
        ), **overrides}
    if model_type == "phi":
        if get("qk_layernorm", False):
            raise ValueError("phi qk_layernorm=True is not supported")
        for drop in ("resid_pdrop", "embd_pdrop"):
            if get(drop, 0.0):
                raise ValueError(
                    f"phi {drop}={get(drop)} is not supported: dropout is not "
                    "implemented — override it to 0.0 to fine-tune without it"
                )
    if model_type == "stablelm":
        if get("qk_layernorm", False):
            raise ValueError("stablelm qk_layernorm=True is not supported")
        if get("use_parallel_residual", False):
            raise ValueError(
                "stablelm use_parallel_residual=True (gpt-neox style) is "
                "not supported; sequential StableLM-2 checkpoints are"
            )
        if get("hidden_dropout", 0.0):
            raise ValueError(
                f"stablelm hidden_dropout={get('hidden_dropout')} is not "
                "supported: dropout is not implemented"
            )
    if model_type == "seed_oss" and get("residual_dropout", 0.0):
        raise ValueError(
            f"seed_oss residual_dropout={get('residual_dropout')} is not "
            "supported: dropout is not implemented — override it to 0.0 to "
            "fine-tune without it"
        )
    if model_type == "arcee" and get("hidden_act", "relu2") != "relu2":
        raise ValueError(
            f"arcee hidden_act={get('hidden_act')!r} is not supported; the "
            "Arcee graph is modeled as the non-gated relu2 MLP"
        )
    moe: dict[str, Any] = {}
    if model_type == "phimoe":
        # Phi-3.5-MoE: mixtral expert naming, SparseMixer routing, biased LayerNorms
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=False,
            moe_style="mixtral",
            moe_router_impl="sparsemixer",
            router_jitter_eps=get("router_jitter_noise", 0.01),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
        )
    elif model_type == "mixtral":
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=True,  # Mixtral always renormalizes top-k
            moe_style="mixtral",
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
        )
    elif model_type in ("olmoe", "flex_olmo"):
        # qwen-style expert naming, no shared expert; HF's intermediate_size
        # is the per-expert width
        moe = dict(
            num_experts=get("num_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 8),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=get("norm_topk_prob", False),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.01),
        )
    elif model_type in ("granitemoe", "granitemoeshared"):
        # softmax after top-k equals softmax -> top-k -> renormalize; the
        # shared MLP is always on (no gate)
        moe = dict(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("intermediate_size"),
            norm_topk_prob=True,
            moe_style="granite",
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
            shared_expert_intermediate_size=get("shared_intermediate_size"),
            shared_expert_gated=False,
        )
    elif model_type in ("qwen2_moe", "qwen3_moe"):
        if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers"):
            raise ValueError(
                "mixed dense/sparse layer schedules (decoder_sparse_step != 1 "
                "or mlp_only_layers) are not supported"
            )
        moe = dict(
            num_experts=get("num_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 4),
            moe_intermediate_size=get("moe_intermediate_size"),
            norm_topk_prob=get("norm_topk_prob", False),
            router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
            shared_expert_intermediate_size=(
                get("shared_expert_intermediate_size") if model_type == "qwen2_moe" else None
            ),
        )
    # the per-layer sliding/full pattern, resolved once (layer_types and the
    # derived NoPE list must agree): explicit, or Command R7B's fallback
    resolved_layer_types = None
    if model_type in ("olmo3", "ministral", "exaone4", "cohere2"):
        resolved_layer_types = list(get("layer_types") or []) or None
        if (resolved_layer_types is None and model_type == "cohere2"
                and get("sliding_window") is not None):
            pattern = get("sliding_window_pattern", 4)
            resolved_layer_types = [
                "full_attention" if (i + 1) % pattern == 0 else "sliding_attention"
                for i in range(get("num_hidden_layers"))
            ]

    return {**dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings"),
        initializer_range=get("initializer_range", 0.02),
        rms_norm_eps=(
            1e-5 if model_type == "olmo"  # OlmoLayerNorm's F.layer_norm default
            else get("norm_epsilon", 1e-5) if model_type == "starcoder2"
            else get("layer_norm_eps", 1e-5)
            if model_type in ("cohere", "cohere2", "phi", "stablelm", "gpt_neox")
            else get("norm_eps", 1e-5) if model_type == "nemotron"
            else get("rms_norm_eps", 1e-6)
        ),
        pad_token_id=get("pad_token_id"),
        bos_token_id=get("bos_token_id", 1),
        eos_token_id=get("eos_token_id", 2),
        tie_word_embeddings=get("tie_word_embeddings", False),
        # raw Pythia config.json stores the base as rotary_emb_base
        rope_theta=(
            get("rope_theta") or get("rotary_emb_base", 10000.0)
            if model_type == "gpt_neox"
            else get("rope_theta", 10000.0)
        ),
        # Qwen2 / Qwen2-MoE hardcode q/k/v biases without an o_proj bias;
        # an explicit attention_bias wins, present-but-None counts as absent
        attention_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else get("attention_bias", True) if model_type == "gpt_neox"
            else True if model_type == "phi"
            else get("use_bias", False) if model_type == "ernie4_5"
            else get("use_qkv_bias", False) if model_type == "stablelm"
            else get("attention_bias")
            if get("attention_bias") is not None
            else model_type in ("qwen2", "qwen2_moe")
        ),
        attention_out_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else get("attention_bias", True) if model_type == "gpt_neox"
            else True if model_type == "phi"
            else get("use_bias", False) if model_type == "ernie4_5"
            else get("attention_out_bias", False) if model_type == "seed_oss"
            else False if model_type in ("glm", "glm4", "helium", "stablelm")
            else False
            if model_type in ("qwen2", "qwen2_moe") and get("attention_bias") is None
            else (get("attention_bias") or False)
        ),
        attention_dropout=get("attention_dropout", 0.0),
        mlp_bias=(
            get("use_bias", True) if model_type == "starcoder2"
            else True if model_type in ("phi", "gpt_neox")
            else get("mlp_bias", False)
        ),
        rope_scaling=get("rope_scaling"),
        layer_types=resolved_layer_types,
        dual_local_rope=model_type == "olmo3",
        # Mistral sets sliding_window unconditionally; the Qwen families
        # gate it behind use_sliding_window (default False)
        sliding_window=(
            get("sliding_window")
            if get("use_sliding_window",
                   model_type not in ("qwen2", "qwen3", "qwen2_moe", "qwen3_moe", "smollm3"))
            else None
        ),
        no_rope_layers=(
            list(get("no_rope_layers") or []) or None
            if model_type == "smollm3"
            else _derived_no_rope(resolved_layer_types)
            if model_type in ("exaone4", "cohere2")
            and resolved_layer_types is not None
            and get("sliding_window") is not None
            else None
        ),
        qk_norm=(
            get("use_qk_norm", False) if model_type in ("cohere", "cohere2")
            else model_type in ("qwen3", "olmo2", "olmo3", "qwen3_moe", "olmoe", "flex_olmo",
                                "hunyuan_v1_dense", "exaone4", "apertus")
        ),
        qk_norm_position="post_rope" if model_type == "hunyuan_v1_dense" else "pre_rope",
        qk_norm_scope=(
            "full" if model_type in ("olmo2", "olmo3", "olmoe", "flex_olmo") else "head"
        ),
        norm_scheme=(
            "post" if model_type in ("olmo2", "olmo3", "flex_olmo", "exaone4")
            else "parallel" if model_type in ("cohere", "cohere2", "phi")
            else ("parallel2" if get("use_parallel_residual", True) else "pre")
            if model_type == "gpt_neox"
            else "sandwich" if model_type == "glm4"
            else "pre"
        ),
        clip_qkv=get("clip_qkv"),
        norm_type=(
            "layernorm" if model_type in ("starcoder2", "phi", "stablelm", "phimoe", "gpt_neox")
            else "layernorm_nonparam" if model_type == "olmo"
            else "layernorm_nobias" if model_type in ("cohere", "cohere2")
            else "layernorm1p" if model_type == "nemotron"
            else "rmsnorm"
        ),
        gelu_approximate=(
            get("hidden_act", "gelu") in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh")
            if model_type == "gpt_neox"
            else True
        ),
        neox_naming=(model_type == "gpt_neox"),
        mlp_type=(
            "gelu" if model_type in ("starcoder2", "phi", "gpt_neox")
            else "relu2" if model_type in ("nemotron", "arcee")
            else "xielu" if model_type == "apertus"
            else "swiglu"
        ),
        partial_rotary_factor=(
            get("rotary_pct", 0.25) if model_type == "gpt_neox"
            else get("partial_rotary_factor", 0.5)
            if model_type in ("phi", "glm", "glm4", "nemotron")
            else get("partial_rotary_factor", 0.25) if model_type == "stablelm"
            else 1.0
        ),
        lm_head_bias=(
            get("lm_head_bias", False) if model_type == "phimoe" else model_type == "phi"
        ),
        rope_interleaved=model_type in ("cohere", "cohere2", "glm", "glm4", "ernie4_5", "helium"),
        fused_gate_up=model_type in ("glm", "glm4"),
        logit_scale=(
            get("logit_scale", 0.0625) if model_type in ("cohere", "cohere2") else None
        ),
        # Granite's scalar multipliers (the identity elsewhere)
        embedding_multiplier=get("embedding_multiplier", 1.0),
        attention_multiplier=(
            get("attention_multiplier")
            if model_type in ("granite", "granitemoe", "granitemoeshared")
            else None
        ),
        residual_multiplier=get("residual_multiplier", 1.0),
        logits_scaling=get("logits_scaling", 1.0),
        **moe,
    ), **overrides}


def config_from_hf(hf_config: Any, **overrides: Any) -> LlamaConfig:
    """HF config (object or dict) -> the port's LlamaConfig; a model_type
    whose fields the port cannot run raises naming ROADMAP A.8."""
    return LlamaConfig(**config_fields_from_hf(hf_config, **overrides))
