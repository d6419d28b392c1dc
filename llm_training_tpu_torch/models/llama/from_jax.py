"""Carry a JAX `Llama` or `Gemma` parameter tree -- or a whole JAX
`TrainState` -- across into the port.

The trees are nested dicts of numpy arrays (the caller unboxes and fetches
them from the device first). Every JAX layout is read: scanned
(`layers/layer/...` with a leading `[L, ...]` axis), looped
(`layers_{i}/...`) and Gemma-2's scanned (sliding, full) pairs
(`layers/sliding/...` holding the even layers, `layers/full/...` the odd
ones, each `[L/2, ...]`). The port's names are the same for both families
(HF's); `parameter_names` builds the config's own model to list them. Flax `Dense.kernel [in, out]` becomes torch
`weight [out, in]` (an MoE block's router `mlp/gate` too); the expert
stacks and the shared expert keep JAX's layout. `train_state_dict_from_jax` maps a training state
(params, optax's moments and count -- adam's, lion's and adafactor's, as
stored by an offloaded run too -- `MultiSteps`' accumulator, the key and
the step) onto the port's `TrainState.state_dict()`, so a run started in
the JAX package resumes in the port.

The non-Llama MoE families (DeepSeek, GLM-4.5, gpt-oss, ERNIE-4.5-MoE,
HunYuan-MoE) name their parameters as JAX's tree does below a layer
(`moe_scan_io.jax_keys`); their trees' layouts (looped, a looped prefix with
a scanned `moe_layers/layer` suffix, a `layers/slot{j}` period, a scanned
`layers/layer`) are read from the tree's own keys, and a config's
`jax_layout` (a `moe_scan_io.JaxLayout`) stands where the Llama graph's
`scan_layers` does in `jax_path` and `jax_layout`.

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

from llm_training_tpu_torch.models import moe_scan_io
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.moe_scan_io import JaxLayout

# the Dense projections of a decoder layer, and the norms (a layer's own,
# and the attention's qk-norms), by their parent module
_DENSE = {
    "self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    # `gate` is an MoE block's router
    "mlp": ("gate_proj", "up_proj", "down_proj", "c_fc", "c_proj", "gate"),
}
_NORMS = ("input_layernorm", "post_attention_layernorm", "post_feedforward_layernorm",
          "post_self_attn_layernorm", "post_mlp_layernorm", "pre_feedforward_layernorm")
_QK_NORMS = ("q_norm", "k_norm")
_XIELU = ("xielu_alpha_p", "xielu_alpha_n")
# an MoE block's raw parameters, in JAX's layout (not transposed): the
# expert stacks and the shared expert
_MOE_PARAMS = ("experts_gate_proj", "experts_up_proj", "experts_down_proj", "shared_gate_proj",
              "shared_up_proj", "shared_down_proj", "shared_expert_gate")
# outside the layers: the port's name -> the keys below `params`
_TOP = {
    "model.embed_tokens.weight": ("embed_tokens", "embedding"),
    "model.wpe.weight": ("wpe", "embedding"),
    "model.norm.weight": ("norm", "weight"),
    "model.norm.bias": ("norm", "bias"),
    "lm_head.weight": ("lm_head", "kernel"),
    "lm_head.bias": ("lm_head", "bias"),
}


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


def _parameters(config) -> dict[str, torch.dtype]:
    """{the port's parameter name: its dtype} for `config` (the config of
    any ported family), in the model's order."""
    from llm_training_tpu_torch.models.hf_causal_lm import model_class_for_config

    model = model_class_for_config(config)(config, device="meta")
    return {name: p.dtype for name, p in model.named_parameters()}


def parameter_names(config: LlamaConfig) -> list[str]:
    """The port's parameter names (HF's spelling of JAX's tree) for
    `config`, in the model's order."""
    return list(_parameters(config))


def _family(config) -> bool:
    """A config of the non-Llama MoE families (`moe_scan_io` layouts)."""
    return hasattr(config, "jax_layout")


def _family_node(tree: Mapping[str, Any], layout: JaxLayout,
                 name: str) -> tuple[Any, int | None, bool]:
    """(the JAX leaf of the port's parameter `name` in a family tree of
    `layout`, the layer's index in it or None, transposed)."""
    layer, keys, transposed = moe_scan_io.jax_keys(name)
    node, index = tree, None
    if layer is not None:
        prefix, index = layout.location(layer)
        for key in prefix:
            node = node[key]
    for key in keys:
        node = node[key]
    return node, index, transposed


def _layer_keys(keys: list[str]) -> tuple[str, ...] | None:
    """The JAX keys below a decoder layer of the port's in-layer name
    parts (`["self_attn", "q_proj", "weight"]`), or None."""
    if len(keys) == 3 and keys[1] in _DENSE.get(keys[0], ()) and keys[2] in ("weight", "bias"):
        return (keys[0], keys[1], "kernel" if keys[2] == "weight" else "bias")
    if len(keys) == 3 and keys[0] == "self_attn" and keys[1] in _QK_NORMS and keys[2] == "weight":
        return tuple(keys)
    if len(keys) == 2 and (keys[0] in _NORMS and keys[1] in ("weight", "bias")
                           or keys[0] == "mlp" and keys[1] in _XIELU + _MOE_PARAMS):
        return tuple(keys)
    return None


def jax_leaf(name: str) -> tuple[int | None, tuple[str, ...]]:
    """Where the port's parameter `name` lives in a JAX `Llama` tree: its
    decoder layer (None outside the layers) and the keys below that layer
    (below `params` outside the layers). A Dense `kernel` is stored
    `[in, out]`, the transpose of torch's `weight`. Raises KeyError for a
    name that is not a `Llama` parameter."""
    parts = name.split(".")
    if parts[:2] == ["model", "layers"] and len(parts) >= 5 and parts[2].isdigit():
        keys = _layer_keys(parts[3:])
        if keys is not None:
            return int(parts[2]), keys
    return None, _TOP[name]


PAIR = ("policy", "ref")
# Adafactor's state fields, kept per JAX leaf
ADAFACTOR_FIELDS = ("v_row", "v_col", "v", "ema")


PAIRS = "pairs"  # the `scan_layers` value of Gemma-2's scanned (sliding, full) pairs


def jax_path(name: str, scan_layers: bool | str = True) -> str | None:
    """The '/'-joined path of the port's parameter `name` in the JAX
    tree of one layout: `params/...` outside the layers; a layer's
    parameter in the scanned tree (`params/layers/layer/...`, one leaf for
    all layers), the looped one (`params/layers_{i}/...`) or, with
    `scan_layers=PAIRS`, Gemma-2's pairs (`params/layers/sliding/...` for
    an even layer, `params/layers/full/...` for an odd one). A name of a
    policy and reference pair (`policy.<name>`, `ref.<name>`) is prefixed
    as the JAX DPO and GRPO trees nest it (`policy/params/...`). None for
    any other name."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        path = jax_path(rest, scan_layers)
        return None if path is None else f"{part}/{path}"
    if isinstance(scan_layers, JaxLayout):
        return moe_scan_io.jax_path(name, scan_layers)
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        return None
    tail = "/".join(keys)
    if layer is None:
        return f"params/{tail}"
    if scan_layers == PAIRS:
        return f"params/layers/{'full' if layer % 2 else 'sliding'}/{tail}"
    return f"params/layers/layer/{tail}" if scan_layers else f"params/layers_{layer}/{tail}"


def jax_layout(name: str, scan_layers: bool | str = True) -> tuple[str, int | None, bool]:
    """How the port's parameter `name` sits in the JAX tree of one layout:
    the name of its JAX leaf, its index in that leaf (None for a leaf of
    its own), and whether the JAX array is the transpose of the port's (a
    Dense `kernel`). In the scanned tree (the JAX package's default) a
    decoder layer's parameter shares one `[L, ...]` leaf with its
    namesakes in the other layers, named here with `*` for the layer
    (`model.layers.*.mlp.up_proj.weight`), its index the layer; in the
    looped tree (`scan_layers=False`) each layer's parameter is a leaf of
    its own, named as the port names it; in Gemma-2's pairs
    (`scan_layers=PAIRS`) the even layers share `model.layers.sliding.<rest>`
    and the odd ones `model.layers.full.<rest>`, the index layer // 2. A
    name that is not a `Llama` parameter is a leaf of its own, as the port
    keeps it."""
    part, _, rest = name.partition(".")
    if part in PAIR:
        leaf, index, transposed = jax_layout(rest, scan_layers)
        return f"{part}.{leaf}", index, transposed
    if isinstance(scan_layers, JaxLayout):
        return moe_scan_io.jax_leaf_name(name, scan_layers)
    try:
        layer, keys = jax_leaf(name)
    except KeyError:
        return name, None, False
    transposed = keys[-1] == "kernel"
    if layer is None or not scan_layers:
        return name, None, transposed
    parts = name.split(".")
    if scan_layers == PAIRS:
        half = "full" if layer % 2 else "sliding"
        return ".".join(parts[:2] + [half] + parts[3:]), layer // 2, transposed
    return ".".join(parts[:2] + ["*"] + parts[3:]), layer, transposed


def _masked(node: Any) -> bool:
    """`optax.MaskedNode`, the state of a frozen leaf: an empty tuple."""
    return isinstance(node, tuple) and not node


def _leaf(params: Mapping[str, Any], layer: int | None, keys: tuple[str, ...]) -> np.ndarray | None:
    node, index = _node(params, layer, keys)
    if _masked(node):
        return None
    return np.asarray(node if index is None else node[index])


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
    if _family(config):
        layout = moe_scan_io.layout_of_tree(params)
        out = {}
        for name, dtype in _parameters(config).items():
            node, index, transposed = _family_node(params, layout, name)
            if _masked(node):
                continue
            array = np.asarray(node if index is None else np.asarray(node)[index], np.float32)
            out[name] = torch.tensor(array.T if transposed else array, dtype=dtype)
        return out
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


def _node(tree: Mapping[str, Any], layer: int | None,
          keys: tuple[str, ...]) -> tuple[Any, int | None]:
    """The leaf below `keys` and, for a stacked leaf, the layer's index in
    it: `layer` in the scanned `[L, ...]` one, `layer // 2` in a Gemma-2
    pair's `[L/2, ...]` branch; None for a looped or top-level leaf."""
    index = None
    if layer is None:
        node = tree
    elif "layers" not in tree:
        node = tree[f"layers_{layer}"]
    elif "sliding" in tree["layers"]:
        node = tree["layers"]["full" if layer % 2 else "sliding"]
        index = layer // 2
    else:
        node = tree["layers"]["layer"]
        index = layer
    for key in keys:
        node = node[key]
    return node, index


def optimizer_state_from_jax(tree: Mapping[str, Any], config: LlamaConfig, field: str,
                             per_leaf: bool = False) -> dict[str, torch.Tensor]:
    """The port's optimizer-state entries (`<field>.<name>`, and
    `<field>.<name>.q` / `.scale` for a `QuantArray` of the int8 codec)
    from one JAX state tree in the parameter tree's layout, each in its
    stored dtype (bfloat16-cast leaves stay bfloat16). Per parameter
    (`mu`, `nu`, `trace`, `acc`): a scanned leaf is split by layer and a
    Dense kernel's arrays are transposed, codes and scales alike.
    `per_leaf` (Adafactor's `v_row`, `v_col`, `v`, `ema`): one entry per
    JAX leaf of the tree's own layout (`jax_layout`: scanned, looped or
    Gemma-2's pairs), copied as it is, optax's (1,) placeholders included,
    as the port keeps Adafactor's state per JAX leaf of the model's layout.
    Masked (frozen) leaves are left out."""
    if set(tree) == set(PAIR):
        out = {}
        for part in PAIR:
            out.update({f"{field}.{part}.{k.split('.', 1)[1]}": v for k, v in
                        optimizer_state_from_jax(tree[part], config, field, per_leaf).items()})
        return out
    if set(tree) == {"params"}:
        tree = tree["params"]
    if _family(config):
        layout = moe_scan_io.layout_of_tree(tree)
    else:
        layout = (False if "layers" not in tree
                  else PAIRS if "sliding" in tree["layers"] else True)
    out = {}
    for name in parameter_names(config):
        if _family(config):
            node, index, transposed = _family_node(tree, layout, name)
        else:
            layer, keys = jax_leaf(name)
            node, index = _node(tree, layer, keys)
            transposed = keys[-1] == "kernel"
        if _masked(node):
            continue
        parts = {"q": node.q, "scale": node.scale} if _is_quant(node) else {"": node}
        if per_leaf:
            key = f"{field}.{jax_layout(name, layout)[0]}"
        else:
            key = f"{field}.{name}"
            parts = {s: a if index is None else np.asarray(a)[index] for s, a in parts.items()}
            if transposed:
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
