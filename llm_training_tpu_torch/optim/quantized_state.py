"""Block-quantized storage codec for offloaded optimizer state.

Counterpart of `llm_training_tpu/optim/quantized_state.py`. The offloaded
update moves every state tensor over the host link twice a step, so the
state is stored small:

- symmetric int8 ("sym", for `mu`, `trace`, `ema`): per-block scale =
  max|x| / 127 over `block` consecutive elements of the block axis;
  code = round-half-to-even(x / max(scale, 1e-30)), clipped to +-127;
  dequant = code * scale;
- sqrt uint8 ("sqrt", for `nu` and Adafactor's `v`, `v_row`, `v_col`):
  r = sqrt(x), scale = max r / 254, code = ceil(r / max(scale, 1e-30) -
  5e-4), floored at code 1 for any x > 0 and clipped to 0..255;
  dequant = (code * scale)^2. The ceil never lets a positive second moment
  decode to 0 (Adam's step would grow by sqrt(nu) / eps); its slack of
  5e-4 grid steps makes decode -> encode a fixed point, so re-encoding an
  unchanged state reproduces its codes and scales exactly.

The field whitelist (`_SYM_FIELDS`, `_NONNEG_FIELDS`) decides what is
encoded; anything else -- `MultiSteps`' accumulator `acc` above all, whose
repeated small adds a codec would erase -- stays float32. Eligible: a
floating tensor of a whitelisted field, ndim >= 1, whose block axis is a
multiple of `block`. The bfloat16 storage cast (`cast_state`) applies to
the same fields.

The block axis is the JAX array's LAST axis. The port keeps a Dense
weight as torch's `[out, in]`, the transpose of Flax's `kernel [in, out]`,
so the state of such a weight is blocked along the port's dim 0
(`models/llama/from_jax.py` `jax_layout`); the codes and scales are the
transposes of JAX's, value for value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

DEFAULT_BLOCK = 256
_SYM_FIELDS = {"mu", "trace", "ema"}
_NONNEG_FIELDS = {"nu", "v", "v_row", "v_col"}


@dataclass
class QuantArray:
    """Block-quantized stand-in for one float32 state tensor: `q` keeps the
    tensor's shape (int8 for "sym", uint8 for "sqrt"); `scale` (float32)
    has the block axis divided by `block`."""

    q: torch.Tensor
    scale: torch.Tensor
    kind: str
    block: int
    axis: int = -1


def codec_kind(field: str) -> str | None:
    """The codec of an optimizer-state field ("sym", "sqrt"), None to keep
    it exact."""
    if field in _NONNEG_FIELDS:
        return "sqrt"
    if field in _SYM_FIELDS:
        return "sym"
    return None


def _blocked(x: torch.Tensor, block: int, axis: int) -> tuple[torch.Tensor, int]:
    """x with its block axis split into (blocks, block), and the index of
    the in-block axis."""
    axis = axis % x.ndim
    return x.unflatten(axis, (x.shape[axis] // block, block)), axis + 1


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor rounded once, as IEEE division (and XLA) rounds it: a
    Python scalar divisor makes PyTorch's CUDA kernel multiply by its
    reciprocal, which rounds twice and moves a scale by an ulp."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def quantize_array(x: torch.Tensor, kind: str, block: int, axis: int = -1) -> QuantArray:
    xb, inner = _blocked(x.to(torch.float32), block, axis)
    if kind == "sym":
        scale = _true_div(xb.abs().amax(dim=inner), 127.0)
        q = torch.round(xb / scale.clamp_min(1e-30).unsqueeze(inner))
        q = q.clamp_(-127, 127).to(torch.int8)
    elif kind == "sqrt":
        # the float32 sqrt rounded once, from float64 (exact enough for it):
        # PyTorch's CUDA float32 sqrt moved a scale by an ulp from the CPU's
        # and XLA's correctly rounded one on an H100
        r = xb.double().sqrt().float()
        scale = _true_div(r.amax(dim=inner), 254.0)
        q = torch.ceil(r / scale.clamp_min(1e-30).unsqueeze(inner) - 5e-4)
        q = torch.maximum(q, (xb > 0).to(q.dtype))
        q = q.clamp_(0, 255).to(torch.uint8)
    else:
        raise ValueError(f"unknown quantization kind {kind!r}")
    return QuantArray(q=q.reshape(x.shape), scale=scale, kind=kind, block=block, axis=axis)


def dequantize_array(qa: QuantArray) -> torch.Tensor:
    xb, inner = _blocked(qa.q.to(torch.float32), qa.block, qa.axis)
    xb = xb * qa.scale.unsqueeze(inner)
    if qa.kind == "sqrt":
        xb = xb * xb
    return xb.reshape(qa.q.shape)


def eligible(field: str, x: torch.Tensor, block: int, axis: int = -1) -> bool:
    """Whether `encode_state` quantizes this field's tensor."""
    return (
        codec_kind(field) is not None
        and x.ndim >= 1
        and x.is_floating_point()
        and x.shape[axis] % block == 0
    )


def _field(key: str) -> str:
    """`mu.model.embed_tokens.weight` -> `mu` (the optimizer's state keys)."""
    return key.split(".", 1)[0]


def encode_state(state: Mapping[str, torch.Tensor], block: int = DEFAULT_BLOCK,
                 axes: Mapping[str, int] | None = None) -> dict:
    """Quantize every eligible tensor of a state keyed `<field>.<name>`
    (the optimizer's `state_dict` keys); `axes` gives a key's block axis
    (default -1). Ineligible entries pass through unchanged."""
    out = {}
    for key, x in state.items():
        axis = (axes or {}).get(key, -1)
        kind = codec_kind(_field(key))
        out[key] = (quantize_array(x, kind, block, axis)
                    if isinstance(x, torch.Tensor) and eligible(_field(key), x, block, axis)
                    else x)
    return out


def decode_state(state: Mapping[str, object]) -> dict:
    """Inverse of `encode_state`: QuantArray entries back to float32."""
    return {k: dequantize_array(v) if isinstance(v, QuantArray) else v for k, v in state.items()}


def cast_state(state: Mapping[str, torch.Tensor], dtype: torch.dtype) -> dict:
    """The bfloat16 storage cast: floating tensors (ndim >= 1) of
    whitelisted fields become `dtype`; everything else stays."""
    return {
        k: x.to(dtype)
        if codec_kind(_field(k)) is not None and x.ndim >= 1 and x.is_floating_point() else x
        for k, x in state.items()
    }


def uncast_state(state: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.float32) -> dict:
    return cast_state(state, dtype)
