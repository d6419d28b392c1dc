"""Carry a JAX `Llama` parameter tree across into the port's state dict.

The tree is nested dicts of numpy arrays (the caller unboxes and fetches it
from the device first). Both JAX layouts are read: scanned
(`layers/layer/...` with a leading `[L, ...]` axis) and looped
(`layers_{i}/...`). Flax `Dense.kernel [in, out]` becomes torch
`weight [out, in]`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from llm_training_tpu_torch.models.llama.config import LlamaConfig

_DENSE = {
    "self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
}
_NORMS = ("input_layernorm", "post_attention_layernorm")


def tree_from_flat(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """`{"a/b/c": x}` -> `{"a": {"b": {"c": x}}}` (the `.npz` layout)."""
    tree: dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def _layer_params(params: Mapping[str, Any], i: int) -> Mapping[str, Any]:
    if "layers" in params:
        stacked = params["layers"]["layer"]

        def take(node):
            if isinstance(node, Mapping):
                return {k: take(v) for k, v in node.items()}
            return node[i]

        return take(stacked)
    return params[f"layers_{i}"]


def state_dict_from_jax(params: Mapping[str, Any], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """The port's `Llama` state dict (HF names) from a JAX parameter tree,
    in the config's param dtype on the CPU."""
    if set(params) == {"params"}:
        params = params["params"]
    dtype = config.param_torch_dtype

    def tensor(array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, np.float32), dtype=dtype)

    out = {
        "model.embed_tokens.weight": tensor(params["embed_tokens"]["embedding"]),
        "model.norm.weight": tensor(params["norm"]["weight"]),
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = tensor(np.asarray(params["lm_head"]["kernel"]).T)
    for i in range(config.num_hidden_layers):
        layer = _layer_params(params, i)
        prefix = f"model.layers.{i}."
        for block, names in _DENSE.items():
            for name in names:
                kernel = np.asarray(layer[block][name]["kernel"])
                out[f"{prefix}{block}.{name}.weight"] = tensor(kernel.T)
        for norm in _NORMS:
            out[f"{prefix}{norm}.weight"] = tensor(layer[norm]["weight"])
    return out
