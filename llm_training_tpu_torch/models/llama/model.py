"""Llama 3.x decoder for training and serving.

Counterpart of `llm_training_tpu/models/llama/model.py`: `RMSNorm`,
`LlamaAttention`, `LlamaMLP` (SwiGLU), `LlamaDecoderLayer` (pre-norm) and
`Llama`, with one `nn.ModuleList` over depth. Parameter names are HF's
(`model.layers.{i}.self_attn.q_proj.weight`, ...), so an HF checkpoint maps
straight onto them.

`Llama.forward` runs either the training forward over packed sequences
(segment ids; attention through `dot_product_attention`, each layer under
the config's activation checkpointing) or a chunk against a KV cache,
which it updates in place: the dense cache of `generate` (`DecodeState`,
returned with an advanced `index`) or the serving pool
(`PagedDecodeState`, returned with advanced lengths).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from llm_training_tpu_torch.models.base import (
    CausalLMOutput,
    DecodeState,
    PagedDecodeState,
    resolve_dtype,
)
from llm_training_tpu_torch.models.llama.config import LlamaConfig
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


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    if isinstance(layer.weight, DTensor):
        # a tensor-parallel projection: the plan's hooks take the plain
        # activation and give back the local (or reduced) plain output; the
        # mesh gathers parameters in the compute dtype
        return layer(x)
    # parameters live in param_dtype, the product runs in the activation's
    return F.linear(x, layer.weight.to(x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaAttention(nn.Module):
    """GQA attention: q/k/v projections, RoPE, then causal attention over
    packed segments, or a cache: the dense one (append at `kv_index`, then
    attention over the whole buffer) or the paged pool (append + ragged
    attention)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        head_dim = config.resolved_head_dim
        dtype = config.param_torch_dtype
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(config.hidden_size, config.num_attention_heads * head_dim, **kw)
        self.k_proj = nn.Linear(config.hidden_size, config.num_key_value_heads * head_dim, **kw)
        self.v_proj = nn.Linear(config.hidden_size, config.num_key_value_heads * head_dim, **kw)
        self.o_proj = nn.Linear(config.num_attention_heads * head_dim, config.hidden_size, **kw)
        name = getattr(config, "attention_compute_dtype", None)
        self.attention_dtype = None if name is None else resolve_dtype(name)

    def forward(
        self,
        hidden: torch.Tensor,
        segment_ids: torch.Tensor | None,
        cos: torch.Tensor,
        sin: torch.Tensor,
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
        # -1 heads: under tensor parallelism a rank holds its local heads
        q = _linear(hidden, self.q_proj).reshape(batch, seq, -1, head_dim)
        k = _linear(hidden, self.k_proj).reshape(batch, seq, -1, head_dim)
        v = _linear(hidden, self.v_proj).reshape(batch, seq, -1, head_dim)
        q, k = apply_rope(q, k, cos, sin)
        if self.attention_dtype is not None:
            # Phi-3's attention precision: q, k and v in this dtype on every
            # path (the kernels take their fp32 paths), as in JAX
            q, k, v = q.to(self.attention_dtype), k.to(self.attention_dtype), v.to(self.attention_dtype)
        scale = head_dim**-0.5
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
                q_segment_ids=segment_ids, causal=True, sliding_window=cfg.sliding_window,
                scale=scale, q_offset=kv_index, impl="xla",
            )
        elif layer_kv is not None:
            out = paged_cached_attention(
                q, k, v, layer_kv, lengths, block_tables,
                segment_ids=segment_ids, sliding_window=cfg.sliding_window,
                scale=scale, impl=paged_impl,
            )
        else:
            out = None
            if cfg.ring_attention:
                # over the active mesh's sequence ranks, or None off a mesh
                out = dispatch_ring_attention(
                    q, k, v, segment_ids, sliding_window=cfg.sliding_window, scale=scale,
                    impl=cfg.attention_impl,
                )
            if out is None:
                out = dot_product_attention(
                    q, k, v, segment_ids=segment_ids, causal=True,
                    sliding_window=cfg.sliding_window, scale=scale, impl=cfg.attention_impl,
                )
        out = out.to(hidden.dtype).reshape(batch, seq, -1)
        return _linear(out, self.o_proj)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=config.param_torch_dtype, device=device)
        self.gate_proj = nn.Linear(config.hidden_size, config.intermediate_size, **kw)
        self.up_proj = nn.Linear(config.hidden_size, config.intermediate_size, **kw)
        self.down_proj = nn.Linear(config.intermediate_size, config.hidden_size, **kw)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        gate = _linear(hidden, self.gate_proj)
        up = _linear(hidden, self.up_proj)
        return _linear(silu_mul(gate, up), self.down_proj)


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dtype = config.param_torch_dtype
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype, device)
        self.self_attn = LlamaAttention(config, device)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, dtype, device
        )
        self.mlp = LlamaMLP(config, device)

    def forward(self, hidden, segment_ids, cos, sin, **cache) -> torch.Tensor:
        hidden = hidden + self.self_attn(
            self.input_layernorm(hidden), segment_ids, cos, sin, **cache
        )
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class LlamaModel(nn.Module):
    """The decoder stack (HF's `model.` prefix)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dtype = config.param_torch_dtype
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size, dtype=dtype, device=device
        )
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, device) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype, device)


class Llama(nn.Module):
    """Llama causal LM."""

    def __init__(self, config: LlamaConfig, device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config, device)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size, bias=False,
                dtype=config.param_torch_dtype, device=device,
            )
        self._rope = config.rope_config
        inv_freq, self._rope_scaling = compute_rope_frequencies(self._rope)
        self.register_buffer(
            "inv_freq", torch.as_tensor(inv_freq, device=device), persistent=False
        )
        self._rope_by_length: dict = {}

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

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (on the parameters' device): a
        normal of std `initializer_range` for projections and embeddings,
        ones for the norms."""
        std = self.config.initializer_range
        for name, param in self.named_parameters():
            if name.endswith("norm.weight"):
                param.fill_(1.0)
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
        a mesh has gathered the table; `rope_length` is the table-selection
        length of a training forward whose rows are one chunk of the
        sequence (the global width)."""
        cfg = self.config
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("one of input_ids / inputs_embeds is required")
            inputs_embeds = self.model.embed_tokens(input_ids)
        hidden = inputs_embeds.to(cfg.compute_torch_dtype)
        if embeds_noise is not None:
            hidden = embeds_noise(hidden)
        batch, seq = hidden.shape[:2]
        device = hidden.device
        if position_ids is None:
            position_ids = torch.arange(seq, device=device)[None, :]
        # JAX's table-selection length: the input width in training, the
        # cache's planned length under a cache (a 1-token decode chunk
        # spans the generation's positions)
        rope_len = (rope_length or seq) if decode_state is None else decode_state.table_length
        inv_freq, rope_factor = self.rope_frequencies(rope_len)
        cos, sin = compute_rope_cos_sin(inv_freq, position_ids, rope_factor)

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
        for i, layer in enumerate(self.model.layers):
            if decode_state is None:
                hidden = run_layer(wrap, layer, hidden, segment_ids, cos, sin)
                continue
            hidden = layer(hidden, segment_ids, cos, sin,
                           layer_kv=(decode_state.k[i], decode_state.v[i]), **cache)

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
        logits = None
        if compute_logits:
            logits = _linear(hidden, self.output_embeddings())
        return CausalLMOutput(
            logits=logits,
            last_hidden_states=hidden if return_last_hidden_states else None,
            decode_state=new_state,
        )

    def output_embeddings(self) -> nn.Module:
        """The module whose `weight [vocab, hidden]` is the head: `lm_head`,
        or the embedding table when they are tied."""
        return self.model.embed_tokens if self.lm_head is None else self.lm_head
