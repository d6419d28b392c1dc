"""RoPE frequency tables: all six scaling variants.

Counterpart of `llm_training_tpu/ops/rope_utils.py`: `default`, `linear`,
`dynamic` (NTK), `yarn`, `longrope` and `llama3`, each with JAX's
validation. Frequencies are fp32 numpy host tables computed from static
config and, for `dynamic` and `longrope`, a sequence length (the model
passes the one JAX passes on each path); the device work is
`positions * inv_freq` in fp32 (`compute_rope_cos_sin`).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclass
class RoPEConfig:
    """Static description of a rotary embedding (`scaling` holds the HF
    `rope_scaling` knobs without the type key):
      linear/dynamic: factor
      yarn:     factor, [attention_factor, beta_fast, beta_slow, ...]
      longrope: short_factor, long_factor, factor, [attention_factor]
      llama3:   factor, low_freq_factor, high_freq_factor,
                original_max_position_embeddings
    """

    dim: int
    max_position_embeddings: int
    type: str = "default"
    base: float = 10000.0
    scaling: dict[str, Any] | None = None

    def __post_init__(self):
        validate = _VALIDATORS.get(self.type)
        if validate is None:
            raise ValueError(
                f"Unknown rope type {self.type!r}; expected one of {sorted(ROPE_INIT_FUNCTIONS)}"
            )
        validate(self)


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


def _require(config: RoPEConfig, keys: set[str], optional: set[str] = frozenset()) -> None:
    scaling = config.scaling or {}
    missing = keys - set(scaling)
    if missing:
        raise ValueError(f"rope type {config.type!r} requires scaling keys {sorted(missing)}")
    unknown = set(scaling) - keys - set(optional)
    if unknown:
        logger.warning("rope type %r received unused scaling keys %s", config.type, sorted(unknown))


def _validate_default(config: RoPEConfig) -> None:
    if config.scaling:
        logger.warning("rope type 'default' ignores scaling config %s", config.scaling)


def _validate_factor(config: RoPEConfig) -> None:
    _require(config, {"factor"})
    if config.scaling["factor"] < 1.0:
        raise ValueError(f"rope scaling factor must be >= 1, got {config.scaling['factor']}")


def _validate_yarn(config: RoPEConfig) -> None:
    _require(config, {"factor"}, {
        "attention_factor", "beta_fast", "beta_slow",
        # DeepSeek-style yarn extensions (HF _compute_yarn_parameters)
        "mscale", "mscale_all_dim", "original_max_position_embeddings", "truncate",
    })


def _validate_longrope(config: RoPEConfig) -> None:
    _require(config, {"short_factor", "long_factor", "factor"}, {"attention_factor"})
    for key in ("short_factor", "long_factor"):
        factors = config.scaling[key]
        if len(factors) != config.dim // 2:
            raise ValueError(
                f"longrope {key} must have length dim/2={config.dim // 2}, got {len(factors)}"
            )


def _validate_llama3(config: RoPEConfig) -> None:
    _require(
        config,
        {"factor", "low_freq_factor", "high_freq_factor", "original_max_position_embeddings"},
    )
    if config.scaling["low_freq_factor"] >= config.scaling["high_freq_factor"]:
        raise ValueError("llama3 rope needs low_freq_factor < high_freq_factor")


_VALIDATORS: dict[str, Callable[[RoPEConfig], None]] = {
    "default": _validate_default,
    "linear": _validate_factor,
    "dynamic": _validate_factor,
    "yarn": _validate_yarn,
    "longrope": _validate_longrope,
    "llama3": _validate_llama3,
}


def _base_inv_freq(base: float, dim: int) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def _default_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    return _base_inv_freq(config.base, config.dim), 1.0


def _linear_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    inv_freq, attention_factor = _default_rope(config, seq_len)
    return inv_freq / config.scaling["factor"], attention_factor


def _dynamic_ntk_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    dim = config.dim
    factor = config.scaling["factor"]
    max_pos = config.max_position_embeddings
    seq_len = seq_len if seq_len is not None and seq_len > max_pos else max_pos
    base = config.base * ((factor * seq_len / max_pos) - (factor - 1)) ** (dim / (dim - 2))
    return _base_inv_freq(base, dim), 1.0


def _yarn_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    base, dim = config.base, config.dim
    scaling = config.scaling
    factor = scaling["factor"]
    # DeepSeek-style yarn: the pre-extension context length anchors the
    # correction range only; mscale/mscale_all_dim shape the attention factor
    max_pos = scaling.get("original_max_position_embeddings") or config.max_position_embeddings

    def get_mscale(scale: float, mscale: float = 1.0) -> float:
        if scale <= 1.0:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        mscale = scaling.get("mscale")
        mscale_all_dim = scaling.get("mscale_all_dim")
        if mscale and mscale_all_dim:
            attention_factor = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
        else:
            attention_factor = get_mscale(factor)
    beta_fast = scaling.get("beta_fast") or 32
    beta_slow = scaling.get("beta_slow") or 1

    def correction_dim(num_rotations: float) -> float:
        # the dimension whose wavelength completes `num_rotations` over the context
        return dim * math.log(max_pos / (num_rotations * 2 * math.pi)) / (2 * math.log(base))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if scaling.get("truncate", True):  # HF default: integer range bounds
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001  # avoid a 0-width ramp

    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low) / (high - low), 0, 1)
    pos_freqs = config.base ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    # ramp 0: pure extrapolation (high-frequency dims); ramp 1: pure interpolation
    extrapolation_weight = 1.0 - ramp
    inv_freq = interpolation * (1 - extrapolation_weight) + extrapolation * extrapolation_weight
    return inv_freq.astype(np.float32), float(attention_factor)


def _longrope_rope(config: RoPEConfig, seq_len: int | None) -> tuple[np.ndarray, float]:
    base, dim = config.base, config.dim
    max_pos = config.max_position_embeddings
    scaling = config.scaling
    factor = scaling["factor"]

    seq_len = seq_len or int(max_pos * factor)
    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        if factor <= 1.0:
            attention_factor = 1.0
        else:
            attention_factor = math.sqrt(1 + math.log(factor) / math.log(max_pos))

    key = "long_factor" if seq_len > max_pos else "short_factor"
    ext_factors = np.asarray(scaling[key], dtype=np.float32)
    inv_freq = 1.0 / (ext_factors * base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return inv_freq.astype(np.float32), float(attention_factor)


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
    "linear": _linear_rope,
    "dynamic": _dynamic_ntk_rope,
    "yarn": _yarn_rope,
    "longrope": _longrope_rope,
    "llama3": _llama3_rope,
}
# the variants whose tables depend on the sequence length
LENGTH_DEPENDENT = ("dynamic", "longrope")


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
