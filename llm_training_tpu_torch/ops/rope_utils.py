"""RoPE frequency tables: the `default` and `llama3` variants.

Counterpart of `llm_training_tpu/ops/rope_utils.py`. Frequencies are fp32
numpy host tables computed from static config; the device work is
`positions * inv_freq` in fp32 (`compute_rope_cos_sin`). The other scaling
variants of the JAX package (linear, dynamic, yarn, longrope) raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

_LLAMA3_KEYS = {
    "factor", "low_freq_factor", "high_freq_factor",
    "original_max_position_embeddings",
}


@dataclass
class RoPEConfig:
    """Static description of a rotary embedding (`scaling` holds the HF
    `rope_scaling` knobs without the type key)."""

    dim: int
    max_position_embeddings: int
    type: str = "default"
    base: float = 10000.0
    scaling: dict[str, Any] | None = None

    def __post_init__(self):
        if self.type not in ROPE_INIT_FUNCTIONS:
            raise NotImplementedError(
                f"rope type {self.type!r} is not ported; expected one of "
                f"{sorted(ROPE_INIT_FUNCTIONS)}"
            )
        if self.type == "llama3":
            missing = _LLAMA3_KEYS - set(self.scaling or {})
            if missing:
                raise ValueError(
                    f"rope type 'llama3' requires scaling keys {sorted(missing)}"
                )
            if self.scaling["low_freq_factor"] >= self.scaling["high_freq_factor"]:
                raise ValueError(
                    "llama3 rope needs low_freq_factor < high_freq_factor"
                )


def rope_config_from_hf(
    rope_scaling: dict | None, base: float, dim: int, max_position_embeddings: int
) -> RoPEConfig:
    """RoPEConfig from HF fields: the variant rides under 'rope_type' (or
    legacy 'type') inside `rope_scaling`."""
    scaling = dict(rope_scaling) if rope_scaling else None
    rope_type = "default"
    if scaling:
        for key in ("rope_type", "type"):
            if key in scaling:
                rope_type = scaling.pop(key)
    return RoPEConfig(
        dim=dim, max_position_embeddings=max_position_embeddings,
        type=rope_type, base=base, scaling=scaling or None,
    )


def _base_inv_freq(base: float, dim: int) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def _default_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    return _base_inv_freq(config.base, config.dim), 1.0


def _llama3_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    inv_freq, attention_factor = _default_rope(config, seq_len)
    scaling = config.scaling
    factor = scaling["factor"]
    low_freq_factor = scaling["low_freq_factor"]
    high_freq_factor = scaling["high_freq_factor"]
    old_context_len = scaling["original_max_position_embeddings"]

    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * math.pi / inv_freq

    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return np.where(is_medium, smoothed, scaled).astype(np.float32), attention_factor


ROPE_INIT_FUNCTIONS: dict[str, Callable[[RoPEConfig, int | None], tuple[np.ndarray, float]]] = {
    "default": _default_rope,
    "llama3": _llama3_rope,
}


def compute_rope_frequencies(
    config: RoPEConfig, seq_len: int | None = None
) -> tuple[np.ndarray, float]:
    """Return (inv_freq[dim/2] fp32 numpy, attention_factor)."""
    return ROPE_INIT_FUNCTIONS[config.type](config, seq_len)


def compute_rope_cos_sin(
    inv_freq: np.ndarray | torch.Tensor,
    positions: torch.Tensor,
    attention_factor: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables of shape `positions.shape + (dim,)`, with the
    frequency vector duplicated along the last dim (HF half rotation)."""
    inv_freq = torch.as_tensor(inv_freq, dtype=torch.float32, device=positions.device)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attention_factor, torch.sin(emb) * attention_factor
