"""Carry a JAX `Llama` parameter tree -- or a whole JAX `TrainState` --
across into the port.

The trees are nested dicts of numpy arrays (the caller unboxes and fetches
them from the device first). Both JAX layouts are read: scanned
(`layers/layer/...` with a leading `[L, ...]` axis) and looped
(`layers_{i}/...`). Flax `Dense.kernel [in, out]` becomes torch
`weight [out, in]`. `train_state_dict_from_jax` maps a training state
(params, optax's moments and count -- adam's, lion's and adafactor's, as
stored by an offloaded run too -- `MultiSteps`' accumulator, the key and
the step) onto the port's `TrainState.state_dict()`, so a run started in
the JAX package resumes in the port.

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
# Adafactor's state fields, kept per JAX leaf
ADAFACTOR_FIELDS = ("v_row", "v_col", "v", "ema")


def jax_path(name: str, scan_layers: bool = True) -> str | None:
    """The '/'-joined path of the port's parameter `name` in the JAX
    `Llama` tree of one layout: `params/...` outside the layers; a layer's
    parameter in the scanned tree (`params/layers/layer/...`, one leaf for
    all layers) or the looped one (`params/layers_{i}/...`). A name of a
    policy and reference pair (`policy.<name>`, `ref.<name>`) is prefixed
    as the JAX DPO and GRPO trees nest it (`policy/params/...`). None for
    any other name."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        path = jax_path(rest, scan_layers)
        return None if path is None else f"{part}/{path}"
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        return None
    tail = "/".join(keys)
    if layer is None:
        return f"params/{tail}"
    return f"params/layers/layer/{tail}" if scan_layers else f"params/layers_{layer}/{tail}"


def jax_layout(name: str) -> tuple[str, int | None, bool]:
    """How the port's parameter `name` sits in the JAX package's default
    (scanned) tree: the name of its JAX leaf -- a decoder layer's parameter
    shares one `[L, ...]` leaf with its namesakes in the other layers,
    named here with `*` for the layer (`model.layers.*.mlp.up_proj.weight`)
    -- its layer in that leaf (None outside the layers), and whether the
    JAX array is the transpose of the port's (a Dense `kernel`). A name
    that is not a `Llama` parameter is a leaf of its own, as the port keeps
    it."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        leaf, layer, transposed = jax_layout(rest)
        return f"{part}.{leaf}", layer, transposed
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        return name, None, False
    if layer is None:
        return name, None, keys[-1] == "kernel"
    parts = name.split(".")
    return ".".join(parts[:2] + ["*"] + parts[3:]), layer, keys[-1] == "kernel"


def _masked(node: Any) -> bool:
    """`optax.MaskedNode`, the state of a frozen leaf: an empty tuple."""
    return isinstance(node, tuple) and not node


def _leaf(params: Mapping[str, Any], layer: int | None, keys: tuple[str, ...]) -> np.ndarray | None:
    node, scanned = _node(params, layer, keys)
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


def _is_quant(node: Any) -> bool:
    """A JAX `QuantArray` leaf of the int8 codec (codes `q`, scales `scale`)."""
    return hasattr(node, "q") and hasattr(node, "scale")


def _stored(array: Any) -> torch.Tensor:
    """A stored state array as a tensor of its own dtype (bfloat16 through
    float32, exactly)."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _node(tree: Mapping[str, Any], layer: int | None, keys: tuple[str, ...]) -> tuple[Any, bool]:
    """The leaf below `keys` and whether it is the scanned `[L, ...]` one."""
    scanned = layer is not None and "layers" in tree
    if layer is None:
        node = tree
    else:
        node = tree["layers"]["layer"] if scanned else tree[f"layers_{layer}"]
    for key in keys:
        node = node[key]
    return node, scanned


def optimizer_state_from_jax(tree: Mapping[str, Any], config: LlamaConfig, field: str,
                             per_leaf: bool = False) -> dict[str, torch.Tensor]:
    """The port's optimizer-state entries (`<field>.<name>`, and
    `<field>.<name>.q` / `.scale` for a `QuantArray` of the int8 codec)
    from one JAX state tree in the parameter tree's layout, each in its
    stored dtype (bfloat16-cast leaves stay bfloat16). Per parameter
    (`mu`, `nu`, `trace`, `acc`): a scanned leaf is split by layer and a
    Dense kernel's arrays are transposed, codes and scales alike.
    `per_leaf` (Adafactor's `v_row`, `v_col`, `v`, `ema`): one entry per
    JAX leaf (`jax_layout`), copied as it is, optax's (1,) placeholders
    included; the looped JAX layout raises, as the port keeps Adafactor's
    state per scanned leaf. Masked (frozen) leaves are left out."""
    if set(tree) == set(PAIR):
        out = {}
        for part in PAIR:
            out.update({f"{field}.{part}.{k.split('.', 1)[1]}": v for k, v in
                        optimizer_state_from_jax(tree[part], config, field, per_leaf).items()})
        return out
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for name in parameter_names(config):
        layer, keys = jax_leaf(name)
        node, scanned = _node(tree, layer, keys)
        if _masked(node):
            continue
        parts = {"q": node.q, "scale": node.scale} if _is_quant(node) else {"": node}
        if per_leaf:
            if layer is not None and not scanned:
                raise ValueError(
                    "Adafactor state of the looped JAX layout (scan_layers=False) has no "
                    "counterpart in the port, which keeps it per scanned leaf"
                )
            key = f"{field}.{jax_layout(name)[0]}"
        else:
            key = f"{field}.{name}"
            parts = {s: np.asarray(a)[layer] if scanned else a for s, a in parts.items()}
            if keys[-1] == "kernel":
                parts = {s: np.asarray(a).T for s, a in parts.items()}
        for suffix, array in parts.items():
            out[f"{key}.{suffix}" if suffix else key] = _stored(array)
    return out


def train_state_dict_from_jax(
    config: LlamaConfig,
    *,
    params: Mapping[str, Any],
    step: int,
    rng: Any,
    count: int,
    mini_step: int = 0,
    acc_grads: Mapping[str, Any] | None = None,
    **state: Mapping[str, Any] | None,
) -> dict[str, torch.Tensor]:
    """The port's `TrainState.state_dict()` entries from a JAX `TrainState`'s
    arrays: `step` (micro-steps), `rng` (`jax.random.key_data`, two 32-bit
    words), the parameter tree, the optimizer's `count` (its inner updates:
    `ScaleByAdamState.count`, `ScaleByLionState.count`, `FactoredState.count`),
    with accumulation `MultiSteps`' `acc_grads` and `mini_step`, and the
    optimizer's state trees by optax's field names: `mu`/`nu` (adam, adamw),
    `mu` (lion), `trace` (sgd with momentum), `v_row`/`v_col`/`v` and `ema`
    (adafactor). Each tree has the parameter tree's layout (a DPO pair's
    too; masked where a parameter is frozen); its leaves may be the int8
    codec's `QuantArray`s or bfloat16-cast arrays of an offloaded run.
    Load it with `TrainState.load_state_dict` into a state built for the
    same run (`Trainer.init_state`), then `Checkpointer.save` it."""
    unknown = set(state) - {"mu", "nu", "trace", *ADAFACTOR_FIELDS}
    if unknown:
        raise TypeError(f"unknown optimizer state fields {sorted(unknown)}")
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
    for field, tree in {**state, "acc": acc_grads}.items():
        if tree is not None:
            entries = optimizer_state_from_jax(tree, config, field,
                                               per_leaf=field in ADAFACTOR_FIELDS)
            out.update({f"optimizer.{k}": v for k, v in entries.items()})
    return out
