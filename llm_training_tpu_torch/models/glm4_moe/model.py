"""GLM-4.5 decoder, for training.

Counterpart of `llm_training_tpu/models/glm4_moe/model.py`: pre-norm GQA
attention with partial rotary (factor 0.5, halves paired, not interleaved
unlike dense GLM-4), an optional per-head qk-norm before rotary, q/k/v
biases and o's on its own flag (dots1), the layer's window (dots1), and
DeepSeek-V3's MoE block (`deepseek.model.DeepseekMoE`) as it is, after a
dense prefix. No aux loss; the router statistics go to the health layer.
"""

from __future__ import annotations

from torch import nn

from llm_training_tpu_torch.models.deepseek.model import DeepseekMoE
from llm_training_tpu_torch.models.moe_decoder import Attention, DecoderLayer, MoEFamilyLM, SwiGLU


class Glm4Moe(MoEFamilyLM):
    """GLM-4.5 causal LM."""

    def layer(self, i: int, device) -> nn.Module:
        cfg = self.config
        attention = Attention(
            cfg, heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, qkv_bias=cfg.attention_bias, out_bias=cfg.attention_out_bias,
            rotary_dim=cfg.rotary_dim, qk_norm="pre" if cfg.use_qk_norm else None,
            window=cfg.layer_sliding_window(i), device=device)
        is_moe = cfg.layer_is_moe(i)
        mlp = (DeepseekMoE(cfg, device) if is_moe
               else SwiGLU(cfg, cfg.intermediate_size, device=device))
        return DecoderLayer(cfg, attention, mlp, is_moe, device)

    def rope_setup(self):
        return self.config.rope_config, False

    @property
    def num_routed_experts(self) -> int:
        return self.config.n_routed_experts
