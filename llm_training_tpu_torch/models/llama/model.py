"""The Llama graph and its variants, for training and serving.

Counterpart of `llm_training_tpu/models/llama/model.py`: `RMSNorm`,
`LayerNorm` (biased, weight-only, zero-centered and non-parametric),
`LlamaAttention` (biases, qk-norm, `clip_qkv`, partial and interleaved
rotary, Granite's scale, the layer's window), `LlamaMLP` (SwiGLU, gelu,
relu^2, xIELU), `LlamaDecoderLayer` (the pre, post, parallel, parallel2
and sandwich schemes) and `Llama` (learned positions, per-layer rope
tables, the embedding and logit multipliers), with one `nn.ModuleList`
over depth. Parameter names are those of JAX's tree in HF's spelling
(`model.layers.{i}.self_attn.q_proj.weight`, `...q_norm.weight`,
`model.wpe.weight`); `hf_conversion.py` maps each family's checkpoint
names onto them.

`Llama.forward` runs either the training forward over packed sequences
(segment ids; attention through `dot_product_attention`, each layer under
the config's activation checkpointing) or a chunk against a KV cache,
which it updates in place: the dense cache of `generate` (`DecodeState`,
returned with an advanced `index`) or the serving pool
(`PagedDecodeState`, returned with advanced lengths). Each layer gets its
own rope tables (none on a NoPE layer, OLMo-3's unscaled ones on its
sliding layers) and its own window on every attention path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from llm_training_tpu_torch.models.base import (
    CausalLMOutput,
    DecodeState,
    PagedDecodeState,
    RouterStats,
    resolve_dtype,
)
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.moe import MoEMLP
from llm_training_tpu_torch.models.remat import remat_policy, run_layer
from llm_training_tpu_torch.ops.attention import dot_product_attention
from llm_training_tpu_torch.ops.paged_attention import paged_cached_attention
from llm_training_tpu_torch.ops.rms_norm import rms_norm
from llm_training_tpu_torch.ops.rope import apply_rope
from llm_training_tpu_torch.ops.rope_utils import (
    LENGTH_DEPENDENT,
    compute_rope_cos_sin,
    compute_rope_frequencies,
)
from llm_training_tpu_torch.ops.swiglu import silu_mul
from llm_training_tpu_torch.parallel.ring_attention import dispatch_ring_attention

# xIELU's constants (HF's beta and eps) and its scalars' initial values,
# softplus pre-images of 0.8 and 0.8 - beta
XIELU_BETA, XIELU_EPS = 0.5, -1e-6
XIELU_INIT = (math.log(math.expm1(0.8)), math.log(math.expm1(0.8 - XIELU_BETA)))


def _linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    if isinstance(layer.weight, DTensor):
        # a tensor-parallel projection: the plan's hooks take the plain
        # activation and give back the local (or reduced) plain output; the
        # mesh gathers parameters in the compute dtype, and a rowwise
        # projection's bias is added once, to the reduced sum
        return layer(x)
    # parameters live in param_dtype; the product and the bias's add run in
    # the activation's, as a flax Dense does
    out = F.linear(x, layer.weight.to(x.dtype))
    bias = getattr(layer, "bias", None)
    return out if bias is None else out + bias.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


class LayerNorm(nn.Module):
    """Mean-centred LayerNorm with fp32 statistics over the last dim: biased
    (Starcoder2), weight-only (`use_bias=False`, Cohere's, whose weight may
    span `[heads, head_dim]`), zero-centred (`zero_centered`, Nemotron's
    `1 + w`), or without parameters (`parametric=False`, OLMo-1's)."""

    def __init__(self, shape: int | tuple[int, ...], eps: float, dtype: torch.dtype,
                 device=None, use_bias: bool = True, zero_centered: bool = False,
                 parametric: bool = True):
        super().__init__()
        self.eps = eps
        self.zero_centered = zero_centered
        self.weight = self.bias = None
        if parametric:
            fill = torch.zeros if zero_centered else torch.ones
            self.weight = nn.Parameter(fill(shape, dtype=dtype, device=device))
            if use_bias:
                self.bias = nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        normed = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is None:
            return normed.to(x.dtype)
        # JAX adds the one in the parameter's dtype
        weight = self.weight + 1 if self.zero_centered else self.weight
        out = normed * weight.float()
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


def make_norm(config: LlamaConfig, shape: int | tuple[int, ...], device=None) -> nn.Module:
    """JAX's `_norm_cls`: the block norm of `config.norm_type`."""
    dtype, eps = config.param_torch_dtype, config.rms_norm_eps
    kind = config.norm_type
    if kind == "rmsnorm":
        return RMSNorm(shape, eps, dtype, device)
    return LayerNorm(shape, eps, dtype, device, use_bias=kind in ("layernorm", "layernorm1p"),
                     zero_centered=kind == "layernorm1p",
                     parametric=kind != "layernorm_nonparam")


def _dense(config: LlamaConfig, fan_in: int, fan_out: int, bias: bool, device) -> nn.Linear:
    return nn.Linear(fan_in, fan_out, bias=bias, dtype=config.param_torch_dtype, device=device)


class LlamaAttention(nn.Module):
    """GQA attention: q/k/v projections (biased or not), the qk-norms and
    the clamp, rotary over the rotated dims, then causal attention over
    packed segments, or a cache: the dense one (append at `kv_index`, then
    attention over the whole buffer) or the paged pool (append + ragged
    attention). `window` is the layer's own; `cos`/`sin` None means no
    rotation (learned positions, a NoPE layer)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        head_dim = config.resolved_head_dim
        hq, hkv = config.num_attention_heads, config.num_key_value_heads
        qkv_bias = config.attention_bias
        self.q_proj = _dense(config, config.hidden_size, hq * head_dim, qkv_bias, device)
        self.k_proj = _dense(config, config.hidden_size, hkv * head_dim, qkv_bias, device)
        self.v_proj = _dense(config, config.hidden_size, hkv * head_dim, qkv_bias, device)
        self.o_proj = _dense(config, hq * head_dim, config.hidden_size,
                             config.attention_out_bias, device)
        dtype = config.param_torch_dtype
        if config.qk_norm and config.qk_norm_scope == "full":
            # OLMo-2: one RMSNorm over the whole projected width
            self.q_norm = RMSNorm(hq * head_dim, config.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(hkv * head_dim, config.rms_norm_eps, dtype, device)
        elif config.qk_norm and config.norm_type == "layernorm_nobias":
            # Cohere: a weight per head, [heads, head_dim]
            self.q_norm = LayerNorm((hq, head_dim), config.rms_norm_eps, dtype, device,
                                    use_bias=False)
            self.k_norm = LayerNorm((hkv, head_dim), config.rms_norm_eps, dtype, device,
                                    use_bias=False)
        elif config.qk_norm:
            # Qwen3 / HunYuan: one RMSNorm over head_dim, shared by the heads
            self.q_norm = RMSNorm(head_dim, config.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(head_dim, config.rms_norm_eps, dtype, device)
        name = getattr(config, "attention_compute_dtype", None)
        self.attention_dtype = None if name is None else resolve_dtype(name)

    def _qk_norm(self, q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if q.shape[-2] != self.config.num_attention_heads and isinstance(self.q_norm, LayerNorm):
            raise NotImplementedError(
                "Cohere's per-head qk-norm weights under tensor parallelism are not ported "
                "(ROADMAP A.9b)"
            )
        return self.q_norm(q), self.k_norm(k)

    def _rotate(self, q, k, cos, sin):
        cfg = self.config
        rot = cfg.rotary_dim
        if rot == q.shape[-1]:
            return apply_rope(q, k, cos, sin, interleaved=cfg.rope_interleaved)
        # Phi: the first `rot` dims of each head rotate, the rest pass
        q_rot, k_rot = apply_rope(q[..., :rot], k[..., :rot], cos, sin,
                                  interleaved=cfg.rope_interleaved)
        return torch.cat([q_rot, q[..., rot:]], -1), torch.cat([k_rot, k[..., rot:]], -1)

    def forward(
        self,
        hidden: torch.Tensor,
        segment_ids: torch.Tensor | None,
        cos: torch.Tensor | None,
        sin: torch.Tensor | None,
        window: int | None,
        layer_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        lengths: torch.Tensor | None = None,
        block_tables: torch.Tensor | None = None,
        paged_impl: str = "auto",
        kv_index: int | None = None,
        kv_segment_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        head_dim = cfg.resolved_head_dim
        batch, seq, _ = hidden.shape
        q = _linear(hidden, self.q_proj)
        k = _linear(hidden, self.k_proj)
        v = _linear(hidden, self.v_proj)
        head_norm = cfg.qk_norm and cfg.qk_norm_scope == "head"
        if cfg.qk_norm and not head_norm:
            if q.shape[-1] != cfg.num_attention_heads * head_dim:
                raise NotImplementedError(
                    "a full-width qk-norm under tensor parallelism is not ported (ROADMAP A.9b)"
                )
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.clip_qkv is not None:  # OLMo's clamp, after a full-width qk-norm
            q = q.clamp(-cfg.clip_qkv, cfg.clip_qkv)
            k = k.clamp(-cfg.clip_qkv, cfg.clip_qkv)
            v = v.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        # -1 heads: under tensor parallelism a rank holds its local heads
        q = q.reshape(batch, seq, -1, head_dim)
        k = k.reshape(batch, seq, -1, head_dim)
        v = v.reshape(batch, seq, -1, head_dim)
        if head_norm and cfg.qk_norm_position == "pre_rope":
            q, k = self._qk_norm(q, k)
        if cos is not None:
            q, k = self._rotate(q, k, cos, sin)
        if head_norm and cfg.qk_norm_position == "post_rope":
            q, k = self._qk_norm(q, k)  # HunYuan: after rotary
        if self.attention_dtype is not None:
            # Phi-3's attention precision: q, k and v in this dtype on every
            # path (the kernels take their fp32 paths), as in JAX
            q, k, v = q.to(self.attention_dtype), k.to(self.attention_dtype), v.to(self.attention_dtype)
        # Granite replaces 1/sqrt(head_dim) with a config scalar
        scale = cfg.attention_multiplier if cfg.attention_multiplier is not None else head_dim**-0.5
        if kv_index is not None:
            # the dense cache: write this chunk's k/v at the shared index,
            # attend over the whole buffer (unwritten and pad slots carry
            # segment id 0; the causal term hides slots after the chunk).
            # Always the plain einsum path, as in the reference
            ck, cv = layer_kv
            ck[:, kv_index:kv_index + seq] = k.to(ck.dtype)
            cv[:, kv_index:kv_index + seq] = v.to(cv.dtype)
            out = dot_product_attention(
                q, ck.to(k.dtype), cv.to(v.dtype), segment_ids=kv_segment_ids,
                q_segment_ids=segment_ids, causal=True, sliding_window=window,
                scale=scale, q_offset=kv_index, impl="xla",
            )
        elif layer_kv is not None:
            out = paged_cached_attention(
                q, k, v, layer_kv, lengths, block_tables,
                segment_ids=segment_ids, sliding_window=window, scale=scale, impl=paged_impl,
            )
        else:
            out = None
            if cfg.ring_attention:
                # over the active mesh's sequence ranks, or None off a mesh
                out = dispatch_ring_attention(
                    q, k, v, segment_ids, sliding_window=window, scale=scale,
                    impl=cfg.attention_impl,
                )
            if out is None:
                out = dot_product_attention(
                    q, k, v, segment_ids=segment_ids, causal=True,
                    sliding_window=window, scale=scale, impl=cfg.attention_impl,
                )
        out = out.to(hidden.dtype).reshape(batch, seq, -1)
        return _linear(out, self.o_proj)


class LlamaMLP(nn.Module):
    """SwiGLU (gate/up/down), or a non-gated form: gelu (c_fc/c_proj,
    Starcoder2, Phi, GPT-NeoX, GPT-2), relu^2 (Nemotron, Arcee) or xIELU
    with two learnable scalars (Apertus)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        h, i, bias = config.hidden_size, config.intermediate_size, config.mlp_bias
        kind = config.mlp_type
        if kind == "gelu":
            self.c_fc = _dense(config, h, i, bias, device)
            self.c_proj = _dense(config, i, h, bias, device)
            return
        if kind == "swiglu":
            self.gate_proj = _dense(config, h, i, bias, device)
        self.up_proj = _dense(config, h, i, bias, device)
        self.down_proj = _dense(config, i, h, bias, device)
        if kind == "xielu":
            dtype = config.param_torch_dtype
            self.xielu_alpha_p = nn.Parameter(torch.full((1,), XIELU_INIT[0], dtype=dtype,
                                                         device=device))
            self.xielu_alpha_n = nn.Parameter(torch.full((1,), XIELU_INIT[1], dtype=dtype,
                                                         device=device))

    def _xielu(self, up: torch.Tensor) -> torch.Tensor:
        x = up.float()
        a_p = F.softplus(self.xielu_alpha_p.float())
        a_n = XIELU_BETA + F.softplus(self.xielu_alpha_n.float())
        act = torch.where(x > 0, a_p * x * x + XIELU_BETA * x,
                          (torch.expm1(x.clamp(max=XIELU_EPS)) - x) * a_n + XIELU_BETA * x)
        return act.to(up.dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        kind = self.config.mlp_type
        if kind == "gelu":
            up = _linear(hidden, self.c_fc)
            approximate = "tanh" if self.config.gelu_approximate else "none"
            return _linear(F.gelu(up, approximate=approximate), self.c_proj)
        if kind == "swiglu":
            gate = _linear(hidden, self.gate_proj)
            return _linear(silu_mul(gate, _linear(hidden, self.up_proj)), self.down_proj)
        up = _linear(hidden, self.up_proj)
        act = torch.relu(up).square() if kind == "relu2" else self._xielu(up)
        return _linear(act, self.down_proj)


# each scheme's norms, in JAX's order of use
SCHEME_NORMS = {
    "pre": ("input_layernorm", "post_attention_layernorm"),
    "post": ("post_attention_layernorm", "post_feedforward_layernorm"),
    "parallel": ("input_layernorm",),
    "parallel2": ("input_layernorm", "post_attention_layernorm"),
    "sandwich": ("input_layernorm", "post_self_attn_layernorm", "post_attention_layernorm",
                 "post_mlp_layernorm"),
}


class LlamaDecoderLayer(nn.Module):
    """One block of `config.norm_scheme` (see `SCHEME_NORMS`), each block
    output scaled by Granite's `residual_multiplier` before it joins the
    residual stream. An MoE config's layer returns `(hidden, stats)`: the
    block's router statistics (sel_frac, mean_prob, dropped), with padding
    (`segment_ids` 0) left out; a dense one returns `hidden`."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        first, *rest = SCHEME_NORMS[config.norm_scheme]
        # registered in JAX's order of use: the parameter order (and so the
        # order of `init_weights`' draws) of the plain decoder is unchanged
        setattr(self, first, make_norm(config, config.hidden_size, device))
        self.self_attn = LlamaAttention(config, device)
        for name in rest:
            setattr(self, name, make_norm(config, config.hidden_size, device))
        # a config is all-MoE or all-dense, as in JAX
        self.mlp = MoEMLP(config, device) if config.num_experts else LlamaMLP(config, device)

    def forward(self, hidden, segment_ids, cos, sin, window, **cache):
        stats = []
        out = self._blocks(hidden, segment_ids, cos, sin, window, stats, **cache)
        return (out, stats[0]) if stats else out

    def _blocks(self, hidden, segment_ids, cos, sin, window, stats, **cache) -> torch.Tensor:
        cfg = self.config
        rm = cfg.residual_multiplier
        join = (lambda x: x) if rm == 1.0 else (lambda x: x * torch.tensor(rm, dtype=x.dtype))

        def attention(x):
            return self.self_attn(x, segment_ids, cos, sin, window, **cache)

        def mlp(x):
            if not cfg.num_experts:
                return self.mlp(x)
            out, layer_stats = self.mlp(x, None if segment_ids is None else segment_ids > 0)
            stats.append(layer_stats)
            return out

        scheme = cfg.norm_scheme
        if scheme == "parallel":
            # Cohere/Phi: one input norm feeds both blocks, one residual add
            normed = self.input_layernorm(hidden)
            return hidden + join(attention(normed)) + join(mlp(normed))
        if scheme == "parallel2":
            # GPT-NeoX: two norms over the same block input
            attn = attention(self.input_layernorm(hidden))
            return hidden + join(attn) + join(mlp(self.post_attention_layernorm(hidden)))
        if scheme == "sandwich":
            # GLM-4: input and output norms around both blocks
            attn = attention(self.input_layernorm(hidden))
            hidden = hidden + join(self.post_self_attn_layernorm(attn))
            out = mlp(self.post_attention_layernorm(hidden))
            return hidden + join(self.post_mlp_layernorm(out))
        if scheme == "post":
            # OLMo-2: no input norms; each block's output is normed
            hidden = hidden + join(self.post_attention_layernorm(attention(hidden)))
            return hidden + join(self.post_feedforward_layernorm(mlp(hidden)))
        hidden = hidden + join(attention(self.input_layernorm(hidden)))
        return hidden + join(mlp(self.post_attention_layernorm(hidden)))


class LlamaModel(nn.Module):
    """The decoder stack (HF's `model.` prefix)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dtype = config.param_torch_dtype
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size, dtype=dtype, device=device
        )
        if config.position_embedding_type == "learned":
            # GPT-2: learned absolute positions into the residual stream
            self.wpe = nn.Embedding(config.max_position_embeddings, config.hidden_size,
                                    dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, device) for _ in range(config.num_hidden_layers)
        )
        self.norm = make_norm(config, config.hidden_size, device)


def _interleave(cos: torch.Tensor, sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tables of the interleaved pairing: repeat_interleave(freqs, 2)
    instead of the two concatenated halves."""
    half = cos.shape[-1] // 2
    return (cos[..., :half].repeat_interleave(2, -1), sin[..., :half].repeat_interleave(2, -1))


class Llama(nn.Module):
    """Llama-graph causal LM."""

    def __init__(self, config: LlamaConfig, device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config, device)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size, bias=config.lm_head_bias,
                dtype=config.param_torch_dtype, device=device,
            )
        self._rope = config.rope_config
        inv_freq, self._rope_scaling = compute_rope_frequencies(self._rope)
        self.register_buffer(
            "inv_freq", torch.as_tensor(inv_freq, device=device), persistent=False
        )
        self._rope_by_length: dict = {}
        # OLMo-3: its sliding layers rotate with the unscaled tables
        self._local_rope = None
        if config.layer_types is not None and config.rope_scaling and config.dual_local_rope:
            local_freq, local_scaling = compute_rope_frequencies(config.local_rope_config)
            self.register_buffer("local_inv_freq", torch.as_tensor(local_freq, device=device),
                                 persistent=False)
            self._local_rope = local_scaling

    def rope_frequencies(self, rope_len: int) -> tuple[torch.Tensor, float]:
        """(inv_freq on the model's device, attention factor) for a forward
        whose table-selection length is `rope_len`: JAX's `seq_len` (the
        input width in training, the decode state's `table_length` under a
        cache). Only `dynamic` and `longrope` depend on it."""
        if self._rope.type not in LENGTH_DEPENDENT:
            return self.inv_freq, self._rope_scaling
        key = (rope_len, self.inv_freq.device)
        if key not in self._rope_by_length:
            inv_freq, factor = compute_rope_frequencies(self._rope, rope_len)
            self._rope_by_length[key] = (
                torch.as_tensor(inv_freq, device=self.inv_freq.device), factor
            )
        return self._rope_by_length[key]

    def layer_tables(self, position_ids: torch.Tensor, rope_len: int) -> list:
        """Per layer `(cos, sin, window)`: (None, None) where the layer does
        not rotate (learned positions, NoPE), OLMo-3's unscaled tables on
        its sliding layers, the layer's window (JAX's
        `sliding_window_override`)."""
        cfg = self.config
        tables = None
        if cfg.position_embedding_type != "learned":
            inv_freq, rope_factor = self.rope_frequencies(rope_len)
            tables = compute_rope_cos_sin(inv_freq, position_ids, rope_factor)
            if cfg.rope_interleaved:
                tables = _interleave(*tables)
        local = None
        if self._local_rope is not None:
            local = compute_rope_cos_sin(self.local_inv_freq, position_ids, self._local_rope)
            if cfg.rope_interleaved:
                local = _interleave(*local)
        out = []
        for i in range(cfg.num_hidden_layers):
            window = cfg.layer_sliding_window(i)
            cos_sin = (None, None)
            if cfg.layer_rotates(i):
                cos_sin = local if local is not None and window else tables
            out.append((*cos_sin, window))
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (on the parameters' device), as
        JAX's initializers draw them: a normal of std `initializer_range`
        for projections and embeddings (one draw a parameter, in parameter
        order), zeros for biases, ones for norm weights (zeros for a
        zero-centred LayerNorm's), xIELU's scalars at their constants."""
        std = self.config.initializer_range
        modules = dict(self.named_modules())
        for name, param in self.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = modules[owner_name]
            if isinstance(owner, (RMSNorm, LayerNorm)):
                zero = leaf == "bias" or getattr(owner, "zero_centered", False)
                param.fill_(0.0 if zero else 1.0)
            elif leaf == "bias":
                param.zero_()
            elif leaf in ("xielu_alpha_p", "xielu_alpha_n"):
                param.fill_(XIELU_INIT[0] if leaf == "xielu_alpha_p" else XIELU_INIT[1])
            else:
                param.normal_(0.0, std, generator=generator)

    def forward(
        self,
        input_ids: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
        position_ids: torch.Tensor | None = None,
        decode_state: DecodeState | PagedDecodeState | None = None,
        paged_impl: str = "auto",
        inputs_embeds: torch.Tensor | None = None,
        compute_logits: bool = True,
        return_last_hidden_states: bool = False,
        embeds_noise=None,
        rope_length: int | None = None,
    ) -> CausalLMOutput:
        """`embeds_noise(embeddings)` adds training noise to the input
        embeddings in the compute dtype (NEFTune) inside the forward, where
        a mesh has gathered the table, before `embedding_multiplier` scales
        them (JAX adds it to `inputs_embeds`); `rope_length` is the
        table-selection length of a training forward whose rows are one
        chunk of the sequence (the global width)."""
        cfg = self.config
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("one of input_ids / inputs_embeds is required")
            inputs_embeds = self.model.embed_tokens(input_ids)
        hidden = inputs_embeds.to(cfg.compute_torch_dtype)
        if embeds_noise is not None:
            hidden = embeds_noise(hidden)
        if cfg.embedding_multiplier != 1.0:
            # Granite scales the embeddings into the residual stream
            hidden = hidden * torch.tensor(cfg.embedding_multiplier, dtype=hidden.dtype)
        batch, seq = hidden.shape[:2]
        device = hidden.device
        if position_ids is None:
            position_ids = torch.arange(seq, device=device)[None, :]
        if cfg.position_embedding_type == "learned":
            if seq > cfg.max_position_embeddings:
                raise ValueError(
                    f"sequence length {seq} exceeds the learned position table "
                    f"({cfg.max_position_embeddings}); a lookup would read out of range"
                )
            hidden = hidden + self.model.wpe(position_ids).to(hidden.dtype)
        # JAX's table-selection length: the input width in training, the
        # cache's planned length under a cache (a 1-token decode chunk
        # spans the generation's positions)
        rope_len = (rope_length or seq) if decode_state is None else decode_state.table_length
        tables = self.layer_tables(position_ids, rope_len)

        if decode_state is not None and segment_ids is None:
            segment_ids = torch.ones((batch, seq), dtype=torch.int32, device=device)
        paged = isinstance(decode_state, PagedDecodeState)
        if decode_state is not None and not paged:
            index = decode_state.index
            if index + seq > decode_state.max_length:
                raise ValueError(
                    f"a {seq}-token chunk at index {index} overflows the cache "
                    f"({decode_state.max_length} slots)"
                )
            # the chunk's segment ids (pads 0, real tokens 1) mark the slots
            # it writes, before the layers: every layer masks the same view
            decode_state.segment_ids[:, index:index + seq] = segment_ids
            cache = dict(kv_index=index, kv_segment_ids=decode_state.segment_ids)
        elif paged:
            cache = dict(lengths=decode_state.lengths, block_tables=decode_state.block_tables,
                         paged_impl=paged_impl)
        # activation checkpointing applies to the training forward only
        wrap = remat_policy(cfg) if decode_state is None else None
        stats = []
        for i, layer in enumerate(self.model.layers):
            cos, sin, window = tables[i]
            if decode_state is None:
                hidden = run_layer(wrap, layer, hidden, segment_ids, cos, sin, window)
            else:
                hidden = layer(hidden, segment_ids, cos, sin, window,
                               layer_kv=(decode_state.k[i], decode_state.v[i]), **cache)
            if cfg.num_experts:
                hidden, layer_stats = hidden
                stats.append(layer_stats)

        new_state = None
        if decode_state is not None and not paged:
            new_state = DecodeState(
                k=decode_state.k, v=decode_state.v, index=decode_state.index + seq,
                segment_ids=decode_state.segment_ids, rope_length=decode_state.rope_length,
            )
        elif paged:
            # rows advance by the chunk's REAL token count: padded tail
            # positions of a final prefill chunk occupy no cache slot
            new_state = PagedDecodeState(
                k=decode_state.k, v=decode_state.v,
                block_tables=decode_state.block_tables,
                lengths=decode_state.lengths
                + (segment_ids > 0).sum(dim=1).to(torch.int32),
                rope_length=decode_state.rope_length,
            )
        hidden = self.model.norm(hidden)
        # Cohere's logit_scale and Granite's logits_scaling, folded into the
        # hidden states the fused CE reads (lms/clm.py), as in JAX
        if cfg.logit_scale is not None:
            hidden = hidden * torch.tensor(cfg.logit_scale, dtype=hidden.dtype)
        if cfg.logits_scaling != 1.0:
            hidden = hidden / torch.tensor(cfg.logits_scaling, dtype=hidden.dtype)
        logits = None
        if compute_logits:
            logits = _linear(hidden, self.output_embeddings())
        aux_loss = dropped = router_stats = None
        if cfg.num_experts:
            # pooled across depth BEFORE the E * sum(f * P) product, as HF's
            # load_balancing_loss_func concatenates every layer's logits
            sel_frac, mean_prob, layer_dropped = (torch.stack(x) for x in zip(*stats))
            aux_loss = cfg.num_experts * (sel_frac.mean(0) * mean_prob.mean(0)).sum()
            dropped = layer_dropped.sum()
            router_stats = RouterStats(sel_frac=sel_frac, mean_prob=mean_prob, dropped=dropped,
                                       layer_ids=tuple(range(cfg.num_hidden_layers)))
        return CausalLMOutput(
            logits=logits,
            last_hidden_states=hidden if return_last_hidden_states else None,
            aux_loss=aux_loss,
            ep_dropped_rows=dropped,
            router_stats=router_stats,
            decode_state=new_state,
        )

    def output_embeddings(self) -> nn.Module:
        """The module whose `weight [vocab, hidden]` is the head (and whose
        `bias`, if any, its bias): `lm_head`, or the embedding table when
        they are tied."""
        return self.model.embed_tokens if self.lm_head is None else self.lm_head
