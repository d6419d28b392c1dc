"""Gemma 1/2/3 decoder, for training and serving.

Counterpart of `llm_training_tpu/models/gemma/model.py`, with its graph:

- `GemmaRMSNorm` multiplies by (1 + weight), zero-initialized, in fp32
  BEFORE the downcast;
- the embeddings are scaled by sqrt(hidden_size), the factor cast to the
  compute dtype first;
- the MLP is GeGLU with tanh-approximated gelu (every dense layer biased
  when `attention_bias`, as JAX's `_dense` does);
- the head is always the embedding table, and `final_logit_softcapping`
  caps the logits (the fused CE caps them too, `lms/clm.py`).

Version 2 adds sandwich norms around both blocks, the attention soft cap
(the flash kernels' and K4's `cap`), the `query_pre_attn_scalar` scale and
a window on even layers. Version 3 adds a per-head zero-centred qk-norm
before rotary, the explicit `layer_types` pattern and dual rotary tables:
sliding layers rotate with `rope_local_base_freq`, unscaled.

Parameter names are HF's, which are JAX's module names
(`model.layers.{i}.self_attn.q_proj.weight`, `...pre_feedforward_layernorm.
weight`); `from_jax.py` maps JAX's three tree layouts (scanned, scanned
(sliding, full) pairs, looped) onto them. `Gemma.forward` runs the training
forward over packed sequences (each layer under the config's activation
checkpointing) or a chunk against a cache it updates in place: the dense
one of `generate` (`DecodeState`) or the serving pool (`PagedDecodeState`).
As in JAX, a Gemma-2 config whose layers JAX scans in (sliding, full)
pairs refuses a cache: a serving config for windowed Gemma-2 sets
`scan_layers: false`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models.base import CausalLMOutput, DecodeState, PagedDecodeState
from llm_training_tpu_torch.models.gemma.config import GemmaConfig
from llm_training_tpu_torch.models.llama.model import Llama, _linear
from llm_training_tpu_torch.models.remat import remat_policy, run_layer
from llm_training_tpu_torch.ops.attention import dot_product_attention
from llm_training_tpu_torch.ops.paged_attention import paged_cached_attention
from llm_training_tpu_torch.ops.rope import apply_rope
from llm_training_tpu_torch.ops.rope_utils import compute_rope_cos_sin, compute_rope_frequencies
from llm_training_tpu_torch.parallel.ring_attention import dispatch_ring_attention


class GemmaRMSNorm(nn.Module):
    """x / rms(x) * (1 + weight) in fp32, then rounded to x's dtype."""

    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * (1.0 + self.weight.float())).to(x.dtype)


def _dense(config: GemmaConfig, fan_in: int, fan_out: int, device) -> nn.Linear:
    return nn.Linear(fan_in, fan_out, bias=config.attention_bias,
                     dtype=config.param_torch_dtype, device=device)


class GemmaAttention(nn.Module):
    """GQA attention with the optional per-head qk-norm (Gemma-3), rotary,
    the config's scale and soft cap and the layer's window, over packed
    segments or a cache (dense: append at `kv_index`, attend over the
    buffer; paged: append, then the ragged decode kernel or the gather
    path)."""

    def __init__(self, config: GemmaConfig, device=None):
        super().__init__()
        self.config = config
        hq, hkv, head_dim = config.num_attention_heads, config.num_key_value_heads, config.head_dim
        self.q_proj = _dense(config, config.hidden_size, hq * head_dim, device)
        self.k_proj = _dense(config, config.hidden_size, hkv * head_dim, device)
        self.v_proj = _dense(config, config.hidden_size, hkv * head_dim, device)
        self.o_proj = _dense(config, hq * head_dim, config.hidden_size, device)
        if config.use_qk_norm:
            dtype = config.param_torch_dtype
            self.q_norm = GemmaRMSNorm(head_dim, config.rms_norm_eps, dtype, device)
            self.k_norm = GemmaRMSNorm(head_dim, config.rms_norm_eps, dtype, device)

    def forward(
        self,
        hidden: torch.Tensor,
        segment_ids: torch.Tensor | None,
        cos: torch.Tensor,
        sin: torch.Tensor,
        window: int | None,
        layer_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        lengths: torch.Tensor | None = None,
        block_tables: torch.Tensor | None = None,
        paged_impl: str = "auto",
        kv_index: int | None = None,
        kv_segment_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        batch, seq, _ = hidden.shape
        # -1 heads: under tensor parallelism a rank holds its local heads
        q = _linear(hidden, self.q_proj).reshape(batch, seq, -1, cfg.head_dim)
        k = _linear(hidden, self.k_proj).reshape(batch, seq, -1, cfg.head_dim)
        v = _linear(hidden, self.v_proj).reshape(batch, seq, -1, cfg.head_dim)
        if cfg.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rope(q, k, cos, sin)
        opts = dict(sliding_window=window, logits_soft_cap=cfg.attn_logit_softcapping,
                    scale=cfg.attention_scale)
        if kv_index is not None:
            # the dense cache: the plain einsum path, as in the reference
            ck, cv = layer_kv
            ck[:, kv_index:kv_index + seq] = k.to(ck.dtype)
            cv[:, kv_index:kv_index + seq] = v.to(cv.dtype)
            out = dot_product_attention(
                q, ck.to(k.dtype), cv.to(v.dtype), segment_ids=kv_segment_ids,
                q_segment_ids=segment_ids, causal=True, q_offset=kv_index, impl="xla", **opts,
            )
        elif layer_kv is not None:
            out = paged_cached_attention(q, k, v, layer_kv, lengths, block_tables,
                                         segment_ids=segment_ids, impl=paged_impl, **opts)
        else:
            out = None
            if cfg.ring_attention:
                out = dispatch_ring_attention(q, k, v, segment_ids, impl=cfg.attention_impl,
                                              **opts)
            if out is None:
                out = dot_product_attention(q, k, v, segment_ids=segment_ids, causal=True,
                                            impl=cfg.attention_impl, **opts)
        out = out.to(hidden.dtype).reshape(batch, seq, -1)
        return _linear(out, self.o_proj)


class GemmaMLP(nn.Module):
    """GeGLU: down(gelu_tanh(gate) * up)."""

    def __init__(self, config: GemmaConfig, device=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _dense(config, h, i, device)
        self.up_proj = _dense(config, h, i, device)
        self.down_proj = _dense(config, i, h, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        gate = F.gelu(_linear(hidden, self.gate_proj), approximate="tanh")
        return _linear(gate * _linear(hidden, self.up_proj), self.down_proj)


class GemmaDecoderLayer(nn.Module):
    """Version 1: residual + attn(input_norm(x)), then residual +
    mlp(post_attention_norm(x)). Versions 2 and 3: sandwich norms, each
    block's output normed before it joins the residual stream."""

    def __init__(self, config: GemmaConfig, device=None):
        super().__init__()
        self.config = config
        norm = lambda: GemmaRMSNorm(config.hidden_size, config.rms_norm_eps,  # noqa: E731
                                    config.param_torch_dtype, device)
        self.input_layernorm = norm()
        self.self_attn = GemmaAttention(config, device)
        self.post_attention_layernorm = norm()
        if config.version in (2, 3):
            self.pre_feedforward_layernorm = norm()
            self.post_feedforward_layernorm = norm()
        self.mlp = GemmaMLP(config, device)

    def forward(self, hidden, segment_ids, cos, sin, window, **cache) -> torch.Tensor:
        attn = self.self_attn(self.input_layernorm(hidden), segment_ids, cos, sin, window, **cache)
        if self.config.version == 1:
            hidden = hidden + attn
            return hidden + self.mlp(self.post_attention_layernorm(hidden))
        hidden = hidden + self.post_attention_layernorm(attn)
        out = self.mlp(self.pre_feedforward_layernorm(hidden))
        return hidden + self.post_feedforward_layernorm(out)


class GemmaModel(nn.Module):
    """The decoder stack (HF's `model.` prefix)."""

    def __init__(self, config: GemmaConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         dtype=config.param_torch_dtype, device=device)
        self.layers = nn.ModuleList(
            GemmaDecoderLayer(config, device) for _ in range(config.num_hidden_layers)
        )
        self.norm = GemmaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 config.param_torch_dtype, device)


class Gemma(nn.Module):
    """Gemma causal LM (the `Llama` model's surface: `forward`,
    `init_weights`, `output_embeddings`, `layer_tables`)."""

    def __init__(self, config: GemmaConfig, device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.model = GemmaModel(config, device)
        self._rope = config.rope_config
        inv_freq, self._rope_scaling = compute_rope_frequencies(self._rope)
        self.register_buffer("inv_freq", torch.as_tensor(inv_freq, device=device),
                             persistent=False)
        self._rope_by_length: dict = {}
        self._local_scaling = None
        if config.version == 3:
            local, self._local_scaling = compute_rope_frequencies(config.local_rope_config)
            self.register_buffer("local_inv_freq", torch.as_tensor(local, device=device),
                                 persistent=False)

    # (inv_freq, attention factor) of the global tables for a table-selection
    # length: `Llama`'s, over the same attributes
    rope_frequencies = Llama.rope_frequencies

    def layer_tables(self, position_ids: torch.Tensor, rope_len: int) -> list:
        """Per layer `(cos, sin, window)`: Gemma-3's sliding layers take the
        local tables, every other layer the global ones."""
        cfg = self.config
        inv_freq, factor = self.rope_frequencies(rope_len)
        tables = compute_rope_cos_sin(inv_freq, position_ids, factor)
        local = None
        if self._local_scaling is not None:
            local = compute_rope_cos_sin(self.local_inv_freq, position_ids, self._local_scaling)
        out = []
        for i in range(cfg.num_hidden_layers):
            window = cfg.layer_sliding_window(i)
            cos_sin = local if local is not None and window else tables
            out.append((*cos_sin, window))
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, as JAX's initializers draw them:
        a normal of std `initializer_range` for projections and the
        embedding (one draw a parameter, in parameter order), zeros for
        biases and for the norms' weights (they scale by 1 + w)."""
        std = self.config.initializer_range
        for name, param in self.named_parameters():
            if name.endswith("norm.weight") or name.endswith(".bias"):
                param.zero_()
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
        """`embeds_noise` adds NEFTune's noise to the embeddings in the
        compute dtype before the sqrt(hidden) scale (JAX adds it to
        `inputs_embeds`); `rope_length` is the table-selection length of a
        training forward whose rows are one chunk of the sequence (as
        `Llama.forward`'s)."""
        cfg = self.config
        if decode_state is not None and cfg.scan_layers and cfg.paired:
            raise NotImplementedError(
                "KV-cache decoding of gemma-2's paired (sliding, full) "
                "scan body is not supported; its cache layer axis would "
                "have to fold into [L/2, 2] pairs"
            )
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("one of input_ids / inputs_embeds is required")
            inputs_embeds = self.model.embed_tokens(input_ids)
        hidden = inputs_embeds.to(cfg.compute_torch_dtype)
        if embeds_noise is not None:
            hidden = embeds_noise(hidden)
        # sqrt(hidden) normalizer, cast before multiplying (HF numerics)
        hidden = hidden * torch.tensor(cfg.hidden_size**0.5, dtype=hidden.dtype)
        batch, seq = hidden.shape[:2]
        device = hidden.device
        if position_ids is None:
            position_ids = torch.arange(seq, device=device)[None, :]
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
            decode_state.segment_ids[:, index:index + seq] = segment_ids
            cache = dict(kv_index=index, kv_segment_ids=decode_state.segment_ids)
        elif paged:
            cache = dict(lengths=decode_state.lengths, block_tables=decode_state.block_tables,
                         paged_impl=paged_impl)
        wrap = remat_policy(cfg) if decode_state is None else None
        for i, layer in enumerate(self.model.layers):
            cos, sin, window = tables[i]
            if decode_state is None:
                hidden = run_layer(wrap, layer, hidden, segment_ids, cos, sin, window)
                continue
            hidden = layer(hidden, segment_ids, cos, sin, window,
                           layer_kv=(decode_state.k[i], decode_state.v[i]), **cache)

        new_state = None
        if decode_state is not None and not paged:
            new_state = DecodeState(
                k=decode_state.k, v=decode_state.v, index=decode_state.index + seq,
                segment_ids=decode_state.segment_ids, rope_length=decode_state.rope_length,
            )
        elif paged:
            new_state = PagedDecodeState(
                k=decode_state.k, v=decode_state.v, block_tables=decode_state.block_tables,
                lengths=decode_state.lengths + (segment_ids > 0).sum(dim=1).to(torch.int32),
                rope_length=decode_state.rope_length,
            )
        hidden = self.model.norm(hidden)
        logits = None
        if compute_logits:
            logits = _linear(hidden, self.model.embed_tokens)
            cap = cfg.final_logit_softcapping
            if cap:
                logits = cap * torch.tanh(logits / cap)
        return CausalLMOutput(
            logits=logits,
            last_hidden_states=hidden if return_last_hidden_states else None,
            decode_state=new_state,
        )

    def output_embeddings(self) -> nn.Module:
        """The head: always the embedding table."""
        return self.model.embed_tokens
