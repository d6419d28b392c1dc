"""Carry a JAX `Llama` parameter tree -- or a whole JAX `TrainState` --
across into the port.

The trees are nested dicts of numpy arrays (the caller unboxes and fetches
them from the device first). Both JAX layouts are read: scanned
(`layers/layer/...` with a leading `[L, ...]` axis) and looped
(`layers_{i}/...`). Flax `Dense.kernel [in, out]` becomes torch
`weight [out, in]`. `train_state_dict_from_jax` maps a training state
(params, optax's moments and count, `MultiSteps`' accumulator, the key
and the step) onto the port's `TrainState.state_dict()`, so a run started
in the JAX package resumes in the port.

A preference objective's tree `{"policy": ..., "ref": ...}` (DPO) maps onto
the names of the port's `PolicyAndReference` module, `policy.<name>` and
`ref.<name>`. Optimizer-state trees hold `optax.masked`'s placeholder (an
empty named tuple, `MaskedNode`) where a frozen parameter has no state:
such leaves are left out, as the port's optimizer holds nothing there.
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


def parameter_names(config: LlamaConfig) -> list[str]:
    """The port's `Llama` parameter names (HF names)."""
    names = ["model.embed_tokens.weight", "model.norm.weight"]
    if not config.tie_word_embeddings:
        names.append("lm_head.weight")
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}."
        names += [f"{prefix}{block}.{name}.weight" for block, dense in _DENSE.items()
                  for name in dense]
        names += [f"{prefix}{norm}.weight" for norm in _NORMS]
    return names


def jax_leaf(name: str) -> tuple[int | None, tuple[str, ...]]:
    """Where the port's parameter `name` lives in a JAX `Llama` tree: its
    decoder layer (None outside the layers) and the keys below that layer
    (below `params` outside the layers). A Dense `kernel` is stored
    `[in, out]`, the transpose of torch's `weight`. Raises KeyError for a
    name that is not a `Llama` parameter."""
    parts = name.split(".")
    if parts[:2] == ["model", "layers"] and len(parts) in (5, 6) and parts[-1] == "weight":
        keys = parts[3:-1]
        if (len(keys) == 2 and keys[1] in _DENSE.get(keys[0], ())) or keys[0] in _NORMS:
            return int(parts[2]), (*keys, "kernel" if len(keys) == 2 else "weight")
    top = {
        "model.embed_tokens.weight": ("embed_tokens", "embedding"),
        "model.norm.weight": ("norm", "weight"),
        "lm_head.weight": ("lm_head", "kernel"),
    }
    return None, top[name]


PAIR = ("policy", "ref")


def jax_paths(name: str) -> list[str]:
    """The '/'-joined paths of the port's parameter `name` in a JAX `Llama`
    tree: `params/...` outside the layers; for a layer's parameter both the
    scanned form (`params/layers/layer/...`, one leaf for all layers) and
    the looped form (`params/layers_{i}/...`). A name of a policy and
    reference pair (`policy.<name>`, `ref.<name>`) is prefixed as the JAX
    DPO tree nests it (`policy/params/...`). Empty for any other name."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        return [f"{part}/{path}" for path in jax_paths(rest)]
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        return []
    tail = "/".join(keys)
    if layer is None:
        return [f"params/{tail}"]
    return [f"params/layers/layer/{tail}", f"params/layers_{layer}/{tail}"]


def _masked(node: Any) -> bool:
    """`optax.MaskedNode`, the state of a frozen leaf: an empty tuple."""
    return isinstance(node, tuple) and not node


def _leaf(params: Mapping[str, Any], layer: int | None, keys: tuple[str, ...]) -> np.ndarray | None:
    scanned = layer is not None and "layers" in params
    if layer is None:
        node = params
    else:
        node = params["layers"]["layer"] if scanned else params[f"layers_{layer}"]
    for key in keys:
        node = node[key]
    if _masked(node):
        return None
    return np.asarray(node[layer] if scanned else node)


def state_dict_from_jax(params: Mapping[str, Any], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """The port's `Llama` state dict (HF names) from a JAX parameter tree
    (or a tree of optimizer state in its layout), in the config's param
    dtype on the CPU; masked leaves are left out. A DPO tree `{"policy",
    "ref"}` gives `policy.<name>` and `ref.<name>`, both in `config`."""
    if set(params) == set(PAIR):
        out = {}
        for part in PAIR:
            out.update({f"{part}.{k}": v
                        for k, v in state_dict_from_jax(params[part], config).items()})
        return out
    if set(params) == {"params"}:
        params = params["params"]
    dtype = config.param_torch_dtype
    out = {}
    for name in parameter_names(config):
        layer, keys = jax_leaf(name)
        array = _leaf(params, layer, keys)
        if array is None:
            continue
        if keys[-1] == "kernel":
            array = array.T
        out[name] = torch.tensor(np.asarray(array, np.float32), dtype=dtype)
    return out


def train_state_dict_from_jax(
    config: LlamaConfig,
    *,
    params: Mapping[str, Any],
    step: int,
    rng: Any,
    count: int,
    mu: Mapping[str, Any] | None = None,
    nu: Mapping[str, Any] | None = None,
    trace: Mapping[str, Any] | None = None,
    acc_grads: Mapping[str, Any] | None = None,
    mini_step: int = 0,
) -> dict[str, torch.Tensor]:
    """The port's `TrainState.state_dict()` entries from a JAX `TrainState`'s
    arrays: `step` (micro-steps), `rng` (`jax.random.key_data`, two 32-bit
    words), the parameter tree, the optimizer's `count` (its inner updates:
    `ScaleByAdamState.count`), its per-parameter trees (`mu`/`nu` of adam,
    `trace` of sgd with momentum) and, with accumulation, `MultiSteps`'
    `acc_grads` and `mini_step`. Each tree has the parameter tree's layout
    (a DPO pair's too; `mu`, `nu` and `trace` masked where a parameter
    is frozen). Load it with `TrainState.load_state_dict` into a state built for the
    same run (`Trainer.init_state`), then `Checkpointer.save` it."""
    words = [int(w) for w in np.asarray(rng).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"rng: expected the two words of a threefry key's data, got {words}")
    out = {
        "step": torch.tensor(int(step), dtype=torch.int64),
        "rng": torch.tensor(words, dtype=torch.int64),
        "optimizer.count": torch.tensor(int(count), dtype=torch.int64),
        "optimizer.mini_step": torch.tensor(int(mini_step), dtype=torch.int64),
    }
    out.update({f"model.{k}": v
                for k, v in state_dict_from_jax(params, config).items()})
    for kind, tree in (("mu", mu), ("nu", nu), ("trace", trace), ("acc", acc_grads)):
        if tree is not None:
            out.update({f"optimizer.{kind}.{k}": v
                        for k, v in state_dict_from_jax(tree, config).items()})
    return out
