"""The decoder stack the non-Llama MoE families share.

The JAX package writes DeepSeek, GLM-4.5, gpt-oss, ERNIE-4.5-MoE and
HunYuan-MoE as five modules of one shape (`llm_training_tpu/models/
{deepseek,glm4_moe,gpt_oss,ernie45_moe,hunyuan_moe}/model.py`): embed,
pre-norm decoder layers (`input_layernorm`, `self_attn`,
`post_attention_layernorm`, `mlp`), a final norm and the head, each layer's
MoE block returning its router statistics (sel_frac, mean_prob, dropped).
The port writes that shape once:

- `FamilyConfig`, the fields and checks the five configs share;
- `Attention`, GQA with the options the families pick from: biases on q/k/v
  and on o apart, a per-head RMS qk-norm before or after rotary, partial or
  interleaved rotary, learned sinks and the layer's window;
- `SwiGLU`, the dense MLP (`gate_proj`, `up_proj`, `down_proj`);
- `MoEFamilyLM`, the causal LM: the training forward over packed sequences,
  each layer under the config's activation checkpointing, the per-layer
  router statistics in layer order and, for a family with an aux loss
  (gpt-oss), the unscaled load-balancing loss.

The hybrid families (`qwen3_next/`, `minimax/`, `bamba/`) build on the same
LM with layers of their own (a recurrent mixer or `Attention`, then an MoE
or `SwiGLU`) and, where theirs differs, their own final norm.

None of these families decodes in JAX (their `__call__` takes no
`decode_state`), so the port's forward takes none either:
`infer.engine.supports_decoding` refuses them in `generate`, `serve` and
`rl-fit` as JAX's does. Parameter names are JAX's tree below `params` with
`.` for `/`, a Dense kernel as the torch `weight` (its transpose), under
`model.` and one `model.layers.{i}` a layer whatever the JAX layout
(`moe_scan_io.py`).
"""

from __future__ import annotations

from dataclasses import fields
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn

from llm_training_tpu_torch.models.base import CausalLMOutput, RouterStats, resolve_dtype
from llm_training_tpu_torch.models.llama.model import RMSNorm, _linear
from llm_training_tpu_torch.models.remat import remat_policy, run_layer
from llm_training_tpu_torch.ops.attention import dot_product_attention
from llm_training_tpu_torch.ops.kernels import grouped_gemm as gg
from llm_training_tpu_torch.ops.rope import apply_rope
from llm_training_tpu_torch.ops.rope_utils import (
    LENGTH_DEPENDENT,
    compute_rope_cos_sin,
    compute_rope_frequencies,
)
from llm_training_tpu_torch.ops.swiglu import silu_mul
from llm_training_tpu_torch.parallel.ring_attention import dispatch_ring_attention

MOE_IMPLS = ("auto", "dense", "ragged")


class FamilyConfig:
    """The surface the five family configs share (dataclasses inheriting
    it): JAX's `BaseModelConfig` fields, the dtype properties and
    `from_dict`."""

    def _check_common(self) -> None:
        resolve_dtype(self.compute_dtype)
        resolve_dtype(self.param_dtype)
        if self.compute_dtype == "float16":
            raise ValueError("compute_dtype='float16' is not supported")
        if self.recompute_granularity not in ("full", "selective"):
            raise ValueError(
                f"recompute_granularity must be 'full' or 'selective', got "
                f"{self.recompute_granularity!r}")
        if self.attention_impl not in ("auto", "xla", "pallas", "torch", "kernel"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        moe_impl = getattr(self, "moe_impl", "auto")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {moe_impl!r}")
        if getattr(self, "attention_dropout", 0.0) != 0.0:
            raise ValueError("attention_dropout is not supported; set it to 0.0")

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    @classmethod
    def from_dict(cls, data: dict[str, Any], where: str = "config"):
        """From a mapping of the dataclass's fields; unknown keys raise."""
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown {cls.__name__} fields {unknown} in {where}")
        return cls(**data)


def linear(config, fan_in: int, fan_out: int, bias: bool, device) -> nn.Linear:
    return nn.Linear(fan_in, fan_out, bias=bias, dtype=config.param_torch_dtype, device=device)


def param(config, *shape: int, device=None, dtype: torch.dtype | None = None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype or config.param_torch_dtype,
                                    device=device))


class Attention(nn.Module):
    """GQA attention over packed segments: q/k/v (`qkv_bias`), o
    (`out_bias`), an optional per-head RMS qk-norm (`qk_norm` 'pre' or
    'post' rotary, one weight over head_dim), rotary over the first
    `rotary_dim` dims (interleaved pairs or halves), learned sinks
    (`[heads]`, joining every softmax denominator with a zero value) and
    the layer's window."""

    def __init__(self, config, *, heads: int, kv_heads: int, head_dim: int, qkv_bias: bool,
                 out_bias: bool, rotary_dim: int, interleaved: bool = False,
                 qk_norm: str | None = None, sinks: bool = False, window: int | None = None,
                 device=None):
        super().__init__()
        self.config = config
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.rotary_dim, self.interleaved, self.qk_norm = rotary_dim, interleaved, qk_norm
        self.window = window
        h = config.hidden_size
        self.q_proj = linear(config, h, heads * head_dim, qkv_bias, device)
        self.k_proj = linear(config, h, kv_heads * head_dim, qkv_bias, device)
        self.v_proj = linear(config, h, kv_heads * head_dim, qkv_bias, device)
        self.o_proj = linear(config, heads * head_dim, h, out_bias, device)
        if qk_norm:
            dtype = config.param_torch_dtype
            self.q_norm = RMSNorm(head_dim, config.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(head_dim, config.rms_norm_eps, dtype, device)
        self.sinks = param(config, heads, device=device) if sinks else None

    def forward(self, hidden, segment_ids, cos, sin):
        cfg = self.config
        batch, seq, _ = hidden.shape
        q = _linear(hidden, self.q_proj).reshape(batch, seq, self.heads, self.head_dim)
        k = _linear(hidden, self.k_proj).reshape(batch, seq, self.kv_heads, self.head_dim)
        v = _linear(hidden, self.v_proj).reshape(batch, seq, self.kv_heads, self.head_dim)
        if self.qk_norm == "pre":
            q, k = self.q_norm(q), self.k_norm(k)
        rot = self.rotary_dim
        if rot == self.head_dim:
            q, k = apply_rope(q, k, cos, sin, interleaved=self.interleaved)
        else:
            q_rot, k_rot = apply_rope(q[..., :rot], k[..., :rot], cos, sin,
                                      interleaved=self.interleaved)
            q, k = torch.cat([q_rot, q[..., rot:]], -1), torch.cat([k_rot, k[..., rot:]], -1)
        if self.qk_norm == "post":
            q, k = self.q_norm(q), self.k_norm(k)
        sinks = None if self.sinks is None else self.sinks.float()
        out = None
        if getattr(cfg, "ring_attention", False):
            out = dispatch_ring_attention(q, k, v, segment_ids, sliding_window=self.window,
                                          sinks=sinks, impl=cfg.attention_impl)
        if out is None:
            out = dot_product_attention(q, k, v, segment_ids=segment_ids, causal=True,
                                        sliding_window=self.window, impl=cfg.attention_impl,
                                        sinks=sinks)
        return _linear(out.to(hidden.dtype).reshape(batch, seq, -1), self.o_proj)


class SwiGLU(nn.Module):
    """gate_proj / up_proj / down_proj with silu(gate) * up between."""

    def __init__(self, config, intermediate_size: int, bias: bool = False, device=None):
        super().__init__()
        h = config.hidden_size
        self.gate_proj = linear(config, h, intermediate_size, bias, device)
        self.up_proj = linear(config, h, intermediate_size, bias, device)
        self.down_proj = linear(config, intermediate_size, h, bias, device)

    def forward(self, hidden):
        gate = _linear(hidden, self.gate_proj)
        return _linear(silu_mul(gate, _linear(hidden, self.up_proj)), self.down_proj)


class DecoderLayer(nn.Module):
    """Pre-norm block. An MoE layer returns (hidden, (sel_frac [E],
    mean_prob [E], dropped)), padding (segment id 0) left out of the
    statistics; a dense one returns hidden."""

    def __init__(self, config, attention: nn.Module, mlp: nn.Module, is_moe: bool, device=None):
        super().__init__()
        dtype, eps = config.param_torch_dtype, config.rms_norm_eps
        self.is_moe = is_moe
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype, device)
        self.self_attn = attention
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, dtype, device)
        self.mlp = mlp

    def forward(self, hidden, segment_ids, cos, sin):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), segment_ids, cos, sin)
        normed = self.post_attention_layernorm(hidden)
        if not self.is_moe:
            return hidden + self.mlp(normed)
        out, stats = self.mlp(normed, None if segment_ids is None else segment_ids > 0)
        return hidden + out, stats


class DecoderStack(nn.Module):
    """HF's `model.` prefix: the embedding, the layers and the final norm
    (`norm`, or the name a family gives it: Bamba's `final_layernorm`)."""

    def __init__(self, config, layers: list[nn.Module], device=None, norm: nn.Module | None = None,
                 norm_name: str = "norm"):
        super().__init__()
        dtype = config.param_torch_dtype
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, dtype=dtype,
                                         device=device)
        self.layers = nn.ModuleList(layers)
        self.norm_name = norm_name
        setattr(self, norm_name,
                norm or RMSNorm(config.hidden_size, config.rms_norm_eps, dtype, device))

    def final_norm(self, hidden: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.norm_name)(hidden)


class MoEFamilyLM(nn.Module):
    """A family's causal LM. Subclasses define `layer(i, device)` (the i-th
    decoder layer), `rope_setup()` and `num_routed_experts`, and set
    `has_aux_loss` (gpt-oss), `head_bias` (ERNIE's `lm_head_bias`) and,
    where the family's final norm is not the Llama graph's `norm`,
    `build_final_norm(device)` and `final_norm_name` (the hybrids)."""

    has_aux_loss = False
    head_bias = False
    final_norm_name = "norm"
    # the mesh's FSDP2 and tensor-parallel plans know the Llama graph's
    # parameters only (parallel/sharding.py): these families refuse a mesh
    mesh_ported = False

    def __init__(self, config, device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.model = DecoderStack(
            config, [self.layer(i, device) for i in range(config.num_hidden_layers)], device,
            self.build_final_norm(device), self.final_norm_name)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = linear(config, config.hidden_size, config.vocab_size, False, device)
        if self.head_bias:
            self.lm_head_bias = param(config, config.vocab_size, device=device)
        self._rope_by_length: dict = {}

    # -- what a family supplies
    def layer(self, i: int, device) -> nn.Module:
        raise NotImplementedError

    def rope_setup(self) -> tuple[Any, bool]:
        """(the rotary config, whether the tables are interleaved)."""
        raise NotImplementedError

    @property
    def num_routed_experts(self) -> int:
        raise NotImplementedError

    def build_final_norm(self, device) -> nn.Module | None:
        """The final norm (None: the Llama graph's RMSNorm)."""
        return None

    # -- the shared forward
    def rope_tables(self, position_ids: torch.Tensor, rope_len: int):
        rope, interleaved = self.rope_setup()
        key = (rope_len if rope.type in LENGTH_DEPENDENT else None, position_ids.device)
        if key not in self._rope_by_length:
            inv_freq, factor = compute_rope_frequencies(rope, rope_len)
            self._rope_by_length[key] = (
                torch.as_tensor(inv_freq, device=position_ids.device), factor)
        inv_freq, factor = self._rope_by_length[key]
        cos, sin = compute_rope_cos_sin(inv_freq, position_ids, factor)
        if interleaved:
            half = cos.shape[-1] // 2
            cos = cos[..., :half].repeat_interleave(2, -1)
            sin = sin[..., :half].repeat_interleave(2, -1)
        return cos, sin

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights as JAX's initializers draw them: a normal of std
        `initializer_range` for projections, embeddings, routers, expert
        stacks (their biases too) and sinks; zeros for a Dense's bias, a
        router's bias and the selection-correction bias; ones for norms; a
        module's `init_fill` ({leaf: value}) where JAX draws a constant (a
        zero-centred norm's zeros, a mixer's decay rates)."""
        std = self.config.initializer_range
        modules = dict(self.named_modules())
        for name, value in self.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = modules[owner_name]
            if leaf in getattr(owner, "init_fill", {}):
                value.fill_(owner.init_fill[leaf])
            elif isinstance(owner, RMSNorm):
                value.fill_(1.0)
            elif leaf in ("bias", "e_score_correction_bias", "lm_head_bias"):
                value.zero_()
            else:
                value.normal_(0.0, std, generator=generator)

    def output_embeddings(self):
        """The head's `weight [vocab, hidden]` (the embedding table when
        tied) and its `bias` (ERNIE's `lm_head_bias`, None elsewhere)."""
        head = self.model.embed_tokens if self.lm_head is None else self.lm_head
        if not self.head_bias:
            return head
        return SimpleNamespace(weight=head.weight, bias=self.lm_head_bias)

    def forward(
        self,
        input_ids: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
        position_ids: torch.Tensor | None = None,
        inputs_embeds: torch.Tensor | None = None,
        compute_logits: bool = True,
        return_last_hidden_states: bool = False,
        embeds_noise=None,
        rope_length: int | None = None,
    ) -> CausalLMOutput:
        """The training forward over packed rows (`segment_ids` 0 =
        padding). `embeds_noise` adds NEFTune's noise to the embeddings in
        the compute dtype; `rope_length` is the table-selection length of a
        chunk of a longer row."""
        cfg = self.config
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("one of input_ids / inputs_embeds is required")
            inputs_embeds = self.model.embed_tokens(input_ids)
        hidden = inputs_embeds.to(cfg.compute_torch_dtype)
        if embeds_noise is not None:
            hidden = embeds_noise(hidden)
        seq = hidden.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq, device=hidden.device)[None, :]
        cos, sin = self.rope_tables(position_ids, rope_length or seq)
        wrap = remat_policy(cfg)
        stats, moe_ids = [], []
        for i, layer in enumerate(self.model.layers):
            hidden = run_layer(wrap, layer, hidden, segment_ids, cos, sin)
            if layer.is_moe:
                hidden, layer_stats = hidden
                stats.append(layer_stats)
                moe_ids.append(i)
        hidden = self.model.final_norm(hidden)
        dropped = router_stats = aux_loss = None
        if stats:
            sel_frac, mean_prob, layer_dropped = (torch.stack(x) for x in zip(*stats))
            dropped = layer_dropped.float().sum()
            router_stats = RouterStats(sel_frac=sel_frac, mean_prob=mean_prob, dropped=dropped,
                                       layer_ids=tuple(moe_ids))
            if self.has_aux_loss:
                # pooled across depth before the E * sum(f * P) product
                aux_loss = self.num_routed_experts * (sel_frac.mean(0) * mean_prob.mean(0)).sum()
        logits = _linear(hidden, self.output_embeddings()) if compute_logits else None
        return CausalLMOutput(
            logits=logits,
            last_hidden_states=hidden if return_last_hidden_states else None,
            aux_loss=aux_loss,
            ep_dropped_rows=dropped,
            router_stats=router_stats,
        )


def swiglu_dense(x, w_gate, w_up, w_down):
    """The dense impl's `dense_fn` of a SwiGLU expert stack: every expert
    on every token."""
    gate = torch.einsum("th,ehi->tei", x, w_gate)
    up = torch.einsum("th,ehi->tei", x, w_up)
    return torch.einsum("tei,eih->teh", silu_mul(gate, up), w_down)


def swiglu_ragged(xs, offsets, expert_order, w):
    """The ragged impl's `ragged_fn` of a SwiGLU expert stack: the three
    projections as G1's grouped GEMMs over the expert-sorted rows."""
    wg, wu, wd = w
    gate = gg.grouped_gemm(xs, wg, offsets)
    up = gg.grouped_gemm(xs, wu, offsets)
    return gg.grouped_gemm(silu_mul(gate, up), wd, offsets)
