"""The JAX trees' layouts of the non-uniform MoE stacks, for the port.

Counterpart of `llm_training_tpu/models/moe_scan_io.py`. The port keeps one
module a decoder layer (`model.layers.{i}...`) whatever the JAX tree's
layout; the layout decides where a layer's parameters live in a JAX tree
(`from_jax.py`, `frozen_modules` patterns, Adafactor's per-leaf state) and
the order in which JAX exports HF keys. `JaxLayout` names the four:

- `looped`: `layers_{i}/...` for every layer;
- `scanned`: one `layers/layer/...` stack `[L, ...]` (HunYuan-MoE);
- `suffix` (`size` = the looped dense prefix's depth): `layers_{i}/...`
  for i < size and a scanned MoE suffix `moe_layers/layer/...` of depth
  L - size, index i - size (DeepSeek, GLM-4.5, ERNIE-4.5-MoE);
- `period` (`size` = p): a p-layer body `layers/slot{j}/...` scanned over
  L / p cycles, layer i at slot i % p, index i // p (gpt-oss).

`detect_period` is JAX's. The JAX tree's names below a layer are the port's
with `.` for `/`, and a Dense projection's `weight` its `kernel` (the
transpose); `jax_keys` maps one onto the other by the name alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import torch

LOOPED, SCANNED, SUFFIX, PERIOD = "looped", "scanned", "suffix", "period"


def detect_period(kinds) -> int:
    """Smallest proper period p < len(kinds) such that kind(i) ==
    kind(i % p) and p divides the depth, or 0 when the sequence does not
    repeat (JAX's)."""
    n = len(kinds)
    for p in range(1, n // 2 + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return 0


@dataclass(frozen=True)
class JaxLayout:
    """Where the JAX tree keeps each decoder layer (see the module header)."""

    kind: str
    size: int = 0

    def __str__(self) -> str:
        return self.kind if self.kind in (LOOPED, SCANNED) else f"{self.kind}{self.size}"

    def location(self, layer: int) -> tuple[tuple[str, ...], int | None]:
        """(the keys of layer `layer`'s subtree, its index in that stack;
        None for a looped layer)."""
        if self.kind == SCANNED:
            return ("layers", "layer"), layer
        if self.kind == PERIOD:
            return ("layers", f"slot{layer % self.size}"), layer // self.size
        if self.kind == SUFFIX and layer >= self.size:
            return ("moe_layers", "layer"), layer - self.size
        return (f"layers_{layer}",), None


def layout_of_tree(tree: dict) -> JaxLayout:
    """The layout a JAX parameter (or optimizer-state) tree was saved in,
    read from its keys."""
    if "moe_layers" in tree:
        return JaxLayout(SUFFIX, sum(k.startswith("layers_") for k in tree))
    if "layers" in tree:
        slots = [k for k in tree["layers"] if k.startswith("slot")]
        return JaxLayout(PERIOD, len(slots)) if slots else JaxLayout(SCANNED)
    return JaxLayout(LOOPED)


def _is_dense(owner: str) -> bool:
    """Whether a `weight` below module `owner` is a Dense kernel (not a
    norm's scale or the embedding table)."""
    return not owner.endswith("norm") and owner != "embed_tokens"


def jax_keys(name: str) -> tuple[int | None, tuple[str, ...], bool]:
    """(decoder layer or None, the JAX keys below that layer or below
    `params`, whether the JAX array is the transpose of the port's) of the
    port's parameter `name` in one of these families."""
    parts = name.split(".")
    layer = None
    if parts[:2] == ["model", "layers"] and len(parts) > 3 and parts[2].isdigit():
        layer, parts = int(parts[2]), parts[3:]
    elif parts[0] == "model":
        parts = parts[1:]
    if parts[-1] == "weight" and len(parts) > 1:
        if parts[-2] == "embed_tokens":
            return layer, tuple(parts[:-1]) + ("embedding",), False
        if _is_dense(parts[-2]):
            return layer, tuple(parts[:-1]) + ("kernel",), True
    return layer, tuple(parts), False


def jax_path(name: str, layout: JaxLayout) -> str:
    """The '/'-joined path of parameter `name` in a JAX tree of `layout`."""
    layer, keys, _ = jax_keys(name)
    if layer is None:
        return "params/" + "/".join(keys)
    prefix, _ = layout.location(layer)
    return "params/" + "/".join(prefix + keys)


def jax_leaf_name(name: str, layout: JaxLayout) -> tuple[str, int | None, bool]:
    """(the JAX leaf's name in the port's spelling, the layer's index in a
    stacked leaf, transposed): a looped layer's parameter is a leaf of its
    own, named as the port names it; a stacked one shares
    `model.<stack>.<rest>` with its namesakes (`model.moe_layers.layer.
    mlp.gate_kernel`, `model.layers.slot1.self_attn.sinks`)."""
    layer, _, transposed = jax_keys(name)
    if layer is None:
        return name, None, transposed
    prefix, index = layout.location(layer)
    if index is None:
        return name, None, transposed
    rest = name.split(".", 3)[3]
    return ".".join(("model",) + prefix + (rest,)), index, transposed


def export_order(layout: JaxLayout, num_layers: int,
                 layer_params: Callable[[int], list[str]],
                 layer_extras: Callable[[int], list[str]] = lambda i: []) -> Iterator[tuple[int, str]]:
    """(layer, HF name below it) in JAX's export order for `layout`
    (`layers_to_hf`, `periodic_layers_to_hf`): a looped layer's table then
    its extras (the per-expert keys) layer by layer; a scanned stack's
    table name by name over its layers, then each layer's extras."""
    stacks: dict[tuple, list[int]] = {}
    for i in range(num_layers):
        prefix, index = layout.location(i)
        if index is None:
            yield from ((i, hf) for hf in layer_params(i) + layer_extras(i))
        else:
            stacks.setdefault(prefix, []).append(i)
    if layout.kind == PERIOD:  # stacks in slot order
        stacks = dict(sorted(stacks.items(), key=lambda kv: int(kv[0][1][4:])))
    for layers in stacks.values():
        for hf in layer_params(layers[0]):
            yield from ((i, hf) for i in layers)
        for i in layers:
            yield from ((i, hf) for hf in layer_extras(i))


# ---------------------------------------------------------------- HF tensors
# A family's per-layer HF table: (the port's in-layer name, HF's, how the
# tensor crosses): None as it is, "T" transposed (a raw JAX-layout matrix,
# such as a router's `gate_kernel [H, E]`), "row" HF's `[1, E]` as the
# port's `[E]` (ERNIE's correction bias), "conv" HF's depthwise conv weight
# `[C, 1, K]` as the port's (JAX's) `[K, C]`. A second, per-layer table
# (the experts', the hybrids' extras) is exported layer by layer after the
# stacked names; its HF names with `{e}` are one tensor an expert, stacked
# into the port's `[E, ...]` (each transposed with "T").
Table = list[tuple[str, str, str | None]]


def _into_port(value, how: str | None):
    if how == "T":
        return value.T
    if how == "row":
        return value.reshape(-1)
    if how == "conv":
        return value[:, 0, :].T
    return value


def _into_hf(value, how: str | None):
    if how == "T":
        return value.T
    if how == "row":
        return value.reshape(1, -1)
    if how == "conv":
        return value.T[:, None, :]
    return value


def _per_expert(hf: str, num_experts: int) -> list[int | None]:
    """The experts an entry of the per-layer table spans (None: one tensor)."""
    return list(range(num_experts)) if "{e}" in hf else [None]


def layers_from_hf(config, put: Callable, read: Callable,
                   layer_table: Callable[[int], Table],
                   expert_table: Callable[[int], Table], num_experts: int) -> None:
    """Put every layer's tensors (`put(port name, tensor)`), each read from
    the HF state dict through `read(canonical HF name)`; an expert stack is
    read one expert at a time and stacked."""
    for i in range(config.num_hidden_layers):
        for ours, hf, how in layer_table(i):
            put(f"model.layers.{i}.{ours}", _into_port(read(f"layers.{i}.{hf}"), how))
        for ours, hf, how in expert_table(i):
            if "{e}" not in hf:
                put(f"model.layers.{i}.{ours}", _into_port(read(f"layers.{i}.{hf}"), how))
                continue
            put(f"model.layers.{i}.{ours}", torch.stack([
                _into_port(read(f"layers.{i}.{hf.format(e=e)}"), how)
                for e in range(num_experts)]))


def layers_to_hf(params, out: dict, layout: JaxLayout, num_layers: int,
                 layer_table: Callable[[int], Table],
                 expert_table: Callable[[int], Table], num_experts: int) -> None:
    """Write every layer's HF keys into `out` in JAX's order for `layout`:
    `layer_table`'s names stacked as JAX stacks them, then each layer's
    `expert_table` entries in table order (an entry with `{e}` expert by
    expert)."""
    tables = {i: {hf: (ours, how) for ours, hf, how in layer_table(i)}
              for i in range(num_layers)}
    experts = {i: expert_table(i) for i in range(num_layers)}

    expert_of = {i: {hf.format(e=e): (ours, how, e) for ours, hf, how in experts[i]
                     for e in _per_expert(hf, num_experts)} for i in range(num_layers)}
    for i, hf in export_order(layout, num_layers, lambda i: list(tables[i]),
                              lambda i: list(expert_of[i])):
        if hf in tables[i]:
            ours, how = tables[i][hf]
            value = params[f"model.layers.{i}.{ours}"]
        else:
            ours, how, e = expert_of[i][hf]
            value = params[f"model.layers.{i}.{ours}"]
            value = value if e is None else value[e]
        out[f"model.layers.{i}.{hf}"] = _into_hf(value, how)
