"""Adafactor, as `optax.adafactor` computes it, over the JAX layout of a
parameter.

The chain, in optax's order: `scale_by_factored_rms` (decay 1 - (t+1)^-0.8,
so the first update keeps no history; a leaf whose two largest dims are
both >= `min_dim_size_to_factor` keeps the means of g^2 + eps over its
largest axis (`v_row`) and its second largest (`v_col`), any other leaf
the full `v`), `clip_by_block_rms(clipping_threshold)`, the learning rate,
`scale_by_param_block_rms` (max(rms(p), 1e-3)) when
`multiply_by_parameter_scale`, `ema(momentum, debias=False)` when
`momentum` is set, `add_decayed_weights` when `weight_decay_rate` is set,
and the sign flip.

Both the factoring and the two block RMS terms depend on the JAX leaf, not
on the port's tensor. A Flax `Dense.kernel` is `[in, out]`, the transpose
of the port's weight; and the JAX Llama scans its layers by default, so a
decoder layer's parameter is one `[L, ...]` leaf with its namesakes in the
other layers: `_factored_dims` sees `[L, in, out]` and each RMS spans all
L layers. So a `Group` here is the port's view of one JAX leaf: the
JAX-oriented views (`weight.T`, free) of its members, one per layer when
stacked. The state tensors (`v_row`, `v_col`, `v`, `ema`) have optax's
shapes for that leaf, placeholders of shape (1,) for the unused side
included, so `from_jax` copies them straight across.

The group is updated in two passes over its layers: the first updates
the second moments and sums the square of the scaled gradient (for the
block RMS clip); the second recomputes the same scaled gradient from the
new moments and applies it. Where L is itself one of the two factored
axes (only at widths under `min_dim_size_to_factor`), the moments couple
the layers, and the group is computed as one stacked tensor instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

KWARGS = {
    "min_dim_size_to_factor": 128, "decay_rate": 0.8, "decay_offset": 0,
    "multiply_by_parameter_scale": True, "clipping_threshold": 1.0, "momentum": None,
    "weight_decay_rate": None, "eps": 1e-30, "factored": True,
}


def factored_dims(shape: tuple[int, ...], factored: bool,
                  min_dim_size_to_factor: int) -> tuple[int, int] | None:
    """optax's `_factored_dims`: (second largest, largest) axis, or None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclass
class Group:
    """One JAX leaf: `members` index the optimizer's parameters, in layer
    order when `stacked`; `transposed` when the JAX array is the transpose
    of the port's tensor."""

    name: str
    members: list[int]
    stacked: bool
    transposed: bool

    def shape(self, params: list[torch.Tensor]) -> tuple[int, ...]:
        one = tuple(params[self.members[0]].shape)
        one = one[::-1] if self.transposed else one
        return ((len(self.members),) if self.stacked else ()) + one

    def view(self, t: torch.Tensor) -> torch.Tensor:
        return t.T if self.transposed else t


def init_state(shape: tuple[int, ...], h: dict, device) -> dict[str, torch.Tensor]:
    """The group's zero state, in optax's shapes."""
    zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    dims = factored_dims(shape, h["factored"], h["min_dim_size_to_factor"])
    if dims is not None:
        d1, d0 = dims
        state = {"v_row": zeros(tuple(np.delete(shape, d0))),
                 "v_col": zeros(tuple(np.delete(shape, d1))), "v": zeros((1,))}
    else:
        state = {"v_row": zeros((1,)), "v_col": zeros((1,)), "v": zeros(shape)}
    if h["momentum"] is not None:
        state["ema"] = zeros(shape)
    return state


def _f32(x: float) -> float:
    return float(np.float32(x))


def update(group: Group, params: list[torch.Tensor], grads: list[torch.Tensor],
           state: dict[str, torch.Tensor], count: int, lr: float, h: dict,
           record=None) -> None:
    """One optax update of the group: the state in place, then each
    member parameter in place. `grads` are float32, index-aligned with
    `params`; `count` is the number of updates before this one.
    `record(i, u)`, when given, sees each member's update (the tensor
    subtracted from parameter i) before it is applied."""
    views = [group.view(params[i]) for i in group.members]
    gviews = [group.view(grads[i]) for i in group.members]
    shape = group.shape(params)
    dims = factored_dims(shape, h["factored"], h["min_dim_size_to_factor"])
    n_layers = len(views)
    if not group.stacked:
        chunks = [None]
    elif dims is not None and 0 in dims:
        chunks = [list(range(n_layers))]  # the moments couple the layers
    else:
        chunks = [[i] for i in range(n_layers)]

    def take(tensors, idx):
        if idx is None:
            return tensors[0]
        if len(idx) == 1:
            return tensors[idx[0]].unsqueeze(0)
        return torch.stack([tensors[i] for i in idx])

    def rows(t, idx):
        """A stacked state tensor's rows of this chunk (placeholders and
        whole-leaf chunks as they are)."""
        if idx is None or t.shape == (1,) or len(idx) == n_layers:
            return t
        return t[idx[0]:idx[0] + 1]

    # optax's _decay_rate_pow, in float32
    t = np.float32(count - h["decay_offset"] + 1)
    decay = _f32(np.float32(1.0) - t ** np.float32(-h["decay_rate"]))
    keep = _f32(np.float32(1.0) - np.float32(decay))
    eps = h["eps"]

    def scaled(g, idx, write: bool) -> torch.Tensor:
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = rows(state["v_row"], idx), rows(state["v_col"], idx)
            if write:
                sq = g * g + eps
                v_row.copy_(decay * v_row + keep * sq.mean(dim=d0))
                v_col.copy_(decay * v_col + keep * sq.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        v = rows(state["v"], idx)
        if write:
            v.copy_(decay * v + keep * (g * g + eps))
        return g * v ** -0.5

    numel = float(np.prod(shape))
    sumsq = torch.zeros((), dtype=torch.float32, device=views[0].device)
    psq = torch.zeros_like(sumsq)
    for idx in chunks:
        u = scaled(take(gviews, idx), idx, write=True)
        sumsq += (u * u).sum()
        if h["multiply_by_parameter_scale"]:
            p = take(views, idx)
            psq += (p * p).sum()
    clip = h["clipping_threshold"]
    denom = (torch.clamp_min(torch.sqrt(sumsq / numel) / clip, 1.0)
             if clip is not None else None)
    pscale = torch.clamp_min(torch.sqrt(psq / numel), 1e-3)
    for idx in chunks:
        u = scaled(take(gviews, idx), idx, write=False)
        if denom is not None:
            u = u / denom
        u = u * lr
        if h["multiply_by_parameter_scale"]:
            u = u * pscale
        if h["momentum"] is not None:
            m = h["momentum"]
            ema = rows(state["ema"], idx)
            u = (1 - m) * u + m * ema
            ema.copy_(u)
        if h["weight_decay_rate"] is not None:
            u = u + h["weight_decay_rate"] * take(views, idx)
        if idx is None:
            if record is not None:
                record(group.members[0], u)
            views[0].sub_(u)
        else:
            for k, i in enumerate(idx):
                if record is not None:
                    record(group.members[i], u[k])
                views[i].sub_(u[k])
