"""Llama 3.x decoder for serving.

Counterpart of `llm_training_tpu/models/llama/model.py`: `RMSNorm`,
`LlamaAttention`, `LlamaMLP` (SwiGLU), `LlamaDecoderLayer` (pre-norm) and
`Llama`, with one `nn.ModuleList` over depth. Parameter names are HF's
(`model.layers.{i}.self_attn.q_proj.weight`, ...), so an HF checkpoint maps
straight onto them.

`Llama.forward` runs either a plain causal forward over packed sequences
(segment ids) or a step against a paged KV cache (`PagedDecodeState`),
which it updates in place and returns with advanced lengths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from llm_training_tpu_torch.models.base import CausalLMOutput, PagedDecodeState
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.ops.attention import _xla_attention, make_attention_mask
from llm_training_tpu_torch.ops.paged_attention import paged_cached_attention
from llm_training_tpu_torch.ops.rms_norm import rms_norm
from llm_training_tpu_torch.ops.rope import apply_rope
from llm_training_tpu_torch.ops.rope_utils import (
    compute_rope_cos_sin,
    compute_rope_frequencies,
)
from llm_training_tpu_torch.ops.swiglu import silu_mul


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
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
    """GQA attention: q/k/v projections, RoPE, then either the causal
    reference attention or the paged cache (append + ragged attention)."""

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
    ) -> torch.Tensor:
        cfg = self.config
        head_dim = cfg.resolved_head_dim
        batch, seq, _ = hidden.shape
        q = _linear(hidden, self.q_proj).reshape(batch, seq, cfg.num_attention_heads, head_dim)
        k = _linear(hidden, self.k_proj).reshape(batch, seq, cfg.num_key_value_heads, head_dim)
        v = _linear(hidden, self.v_proj).reshape(batch, seq, cfg.num_key_value_heads, head_dim)
        q, k = apply_rope(q, k, cos, sin)
        scale = head_dim**-0.5
        if layer_kv is not None:
            out = paged_cached_attention(
                q, k, v, layer_kv, lengths, block_tables,
                segment_ids=segment_ids, sliding_window=cfg.sliding_window,
                scale=scale, impl=paged_impl,
            )
        else:
            mask = make_attention_mask(
                segment_ids, segment_ids, seq, seq, causal=True,
                sliding_window=cfg.sliding_window, device=hidden.device,
            )
            out = _xla_attention(q, k, v, mask, scale, None)
        out = out.to(hidden.dtype).reshape(batch, seq, cfg.num_attention_heads * head_dim)
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
        inv_freq, self._rope_scaling = compute_rope_frequencies(config.rope_config)
        self.register_buffer(
            "inv_freq", torch.as_tensor(inv_freq, device=device), persistent=False
        )

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
        input_ids: torch.Tensor,
        segment_ids: torch.Tensor | None = None,
        position_ids: torch.Tensor | None = None,
        decode_state: PagedDecodeState | None = None,
        paged_impl: str = "auto",
    ) -> CausalLMOutput:
        cfg = self.config
        hidden = self.model.embed_tokens(input_ids).to(cfg.compute_torch_dtype)
        batch, seq = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(seq, device=input_ids.device)[None, :]
        cos, sin = compute_rope_cos_sin(self.inv_freq, position_ids, self._rope_scaling)

        if decode_state is not None and segment_ids is None:
            segment_ids = torch.ones((batch, seq), dtype=torch.int32, device=input_ids.device)
        for i, layer in enumerate(self.model.layers):
            cache = {}
            if decode_state is not None:
                cache = dict(
                    layer_kv=(decode_state.k[i], decode_state.v[i]),
                    lengths=decode_state.lengths,
                    block_tables=decode_state.block_tables,
                    paged_impl=paged_impl,
                )
            hidden = layer(hidden, segment_ids, cos, sin, **cache)

        new_state = None
        if decode_state is not None:
            # rows advance by the chunk's REAL token count: padded tail
            # positions of a final prefill chunk occupy no cache slot
            new_state = PagedDecodeState(
                k=decode_state.k, v=decode_state.v,
                block_tables=decode_state.block_tables,
                lengths=decode_state.lengths
                + (segment_ids > 0).sum(dim=1).to(torch.int32),
            )
        hidden = self.model.norm(hidden)
        if self.lm_head is None:
            logits = hidden @ self.model.embed_tokens.weight.to(hidden.dtype).T
        else:
            logits = _linear(hidden, self.lm_head)
        return CausalLMOutput(logits=logits, decode_state=new_state)
