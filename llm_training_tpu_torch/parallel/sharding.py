"""Logical-axis sharding rules, and the FSDP2 and DTensor plans they give.

Counterpart of `llm_training_tpu/parallel/sharding.py`: the registry of
logical axis names, JAX's rule table, `resolve_spec` / `logical_to_spec`
(pure functions: a spec is a tuple of mesh-axis names per dimension, None
for replicated) with their `AxisDrop` warnings and strict
`UnknownLogicalAxisError`, and `logical_to_sharding` / `shard_pytree`,
which place tensors with `distribute_tensor`.

`PARAM_LOGICAL_AXES` is the one table of the Llama, Phi-3 and Gemma parameters'
logical names, in the JAX array's orientation (a Dense kernel is the
transpose of the port's `nn.Linear` weight). `parallelize` derives
everything from it and the rules:

- the DTensor tensor-parallel plan over `tensor`: a projection whose
  output dimension maps to `tensor` (`heads`, `kv_heads`, `mlp`, the head's
  `vocab`) is colwise (its bias sharded with it), one whose input
  dimension does (`o_proj`, `down_proj`, `c_proj`) rowwise (its bias
  replicated and added once, to the reduced sum), the embedding is sharded
  on `vocab`, and a per-head qk-norm runs over the rank's heads with its
  replicated weight's gradient summed over `tensor`. Every style keeps
  `use_local_output=True`, so the kernels only ever see plain local
  tensors;
- FSDP2's `fully_shard` per decoder layer, then at the model's root, over
  the batch axes: `fsdp` and `sequence` shard (the sequence ranks hold
  other tokens of the same rows, so their gradients sum like FSDP's),
  `data` and `expert` replicate (HSDP when either is above 1). FSDP2
  shards dim 0 of each parameter where JAX shards its `embed` dimension
  (an MoE expert stack's dim 0 is its `expert` dimension): the bytes per
  rank are the same, and DCP reshards on load. An MoE model raises naming
  ROADMAP A.9b where `tensor` or `expert` is above 1 (JAX shards the
  experts' `mlp` and `expert` dims there).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Sequence

import torch

from llm_training_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
)

# the one place a logical axis name is born, as in JAX
KNOWN_LOGICAL_AXES: tuple[str, ...] = (
    # activations
    "batch",
    "act_seq",
    "act_embed",
    "act_heads",
    "act_vocab",
    # parameters
    "embed",
    "heads",
    "kv_heads",
    "mlp",
    "vocab",
    "norm",
    "expert",
    # structural stacking axes: pipeline stage stacks and scanned layer stacks
    "stages",
    "layers",
)


class UnknownLogicalAxisError(ValueError):
    """A logical-axis name that no rule knows: without strict mode it would
    silently replicate the tensor across the whole mesh."""

    def __init__(self, axis: str, known: Sequence[str], path: str | None = None):
        self.axis = axis
        self.path = path
        at = f" on leaf {path!r}" if path else ""
        super().__init__(
            f"unknown logical axis {axis!r}{at}; known axes: "
            f"{sorted(known)}. An unknown name silently replicates the "
            "tensor across the whole mesh — fix the typo, or register the "
            "new axis in KNOWN_LOGICAL_AXES + the rule table "
            "(llm_training_tpu_torch/parallel/sharding.py)."
        )


@dataclass(frozen=True)
class AxisDrop:
    """A mesh axis dropped during spec resolution because an earlier
    dimension of the same tensor already took it."""

    axis: str
    mesh_axes: tuple[str, ...]
    position: int
    path: str | None = None


LogicalAxisRules = Sequence[tuple[str, str | Sequence[str] | None]]

DEFAULT_LOGICAL_AXIS_RULES: LogicalAxisRules = (
    # activations; the expert axis is extra data parallelism for the dense
    # parts of the model
    ("batch", (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS)),
    ("act_seq", SEQUENCE_AXIS),
    ("act_embed", None),
    ("act_heads", TENSOR_AXIS),
    ("act_vocab", TENSOR_AXIS),
    # parameters
    ("embed", FSDP_AXIS),
    ("heads", TENSOR_AXIS),
    ("kv_heads", TENSOR_AXIS),
    ("mlp", TENSOR_AXIS),
    ("vocab", TENSOR_AXIS),
    ("norm", None),
    ("expert", EXPERT_AXIS),
    ("stages", PIPELINE_AXIS),
)

assert set(KNOWN_LOGICAL_AXES) == (
    {name for name, _ in DEFAULT_LOGICAL_AXIS_RULES} | {"layers"}
), "KNOWN_LOGICAL_AXES out of sync with DEFAULT_LOGICAL_AXIS_RULES"


def _rules_dict(rules: LogicalAxisRules) -> dict[str, Any]:
    seen: dict[str, Any] = {}
    for name, axes in rules:
        if name not in seen:  # first match wins
            seen[name] = axes
    return seen


def resolve_spec(
    logical_axes: Sequence[str | None],
    rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES,
    *,
    strict: bool = False,
    path: str | None = None,
) -> tuple[tuple, tuple[AxisDrop, ...]]:
    """Logical axis names to a spec (per dimension: None, one mesh axis, or
    a tuple of them), with the mesh axes dropped because an earlier
    dimension took them. `strict` raises `UnknownLogicalAxisError` for a
    name the rules do not know."""
    table = _rules_dict(rules)
    spec: list[Any] = []
    drops: list[AxisDrop] = []
    used: set[str] = set()
    for position, axis in enumerate(logical_axes):
        if axis is not None and axis not in table and strict:
            raise UnknownLogicalAxisError(axis, known=tuple(table), path=path)
        mesh_axes = table.get(axis) if axis is not None else None
        if mesh_axes is None:
            spec.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        free = tuple(a for a in mesh_axes if a not in used)
        dropped = tuple(a for a in mesh_axes if a in used)
        if dropped:
            drops.append(AxisDrop(axis=axis, mesh_axes=dropped, position=position, path=path))
        used.update(free)
        if not free:
            spec.append(None)
        elif len(free) == 1:
            spec.append(free[0])
        else:
            spec.append(free)
    return tuple(spec), tuple(drops)


def logical_to_spec(
    logical_axes: Sequence[str | None],
    rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES,
    *,
    strict: bool = False,
    path: str | None = None,
) -> tuple:
    """('embed', 'mlp') -> ('fsdp', 'tensor')."""
    spec, _ = resolve_spec(logical_axes, rules, strict=strict, path=path)
    return spec


def logical_to_sharding(logical_axes: Sequence[str | None], mesh,
                        rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES) -> list:
    """The DTensor placements on `mesh` (one per mesh dimension) of a
    tensor with these logical axes. A mesh axis that shards several tensor
    dimensions is not expressible as placements; the spec never does that."""
    from torch.distributed.tensor import Replicate, Shard

    spec = logical_to_spec(logical_axes, rules)
    placements: list = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            placements[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return placements


def shard_pytree(tree: dict[str, torch.Tensor], mesh, logical_axes: dict[str, Sequence],
                 rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES) -> dict:
    """Place a mapping of full tensors onto `mesh` by their logical axes
    (every rank passes the same full tensors)."""
    from torch.distributed.tensor import distribute_tensor

    return {name: distribute_tensor(t, mesh, logical_to_sharding(logical_axes[name], mesh, rules))
            for name, t in tree.items()}


# ------------------------------------------------------------ the parameters

# each parameter's logical names in the JAX array's orientation; `*` is a
# decoder layer's index (the JAX scanned stack adds a leading 'layers'). A
# Dense bias takes its kernel's last axis (JAX's `_dense`); every norm's
# weight and bias are ('norm',) over their last dim (`param_logical_axes`
# prepends None for Cohere's [heads, head_dim] qk-norm weights)
PARAM_LOGICAL_AXES: dict[str, tuple[str, ...]] = {
    "model.embed_tokens.weight": ("vocab", "embed"),
    "model.wpe.weight": (None, "embed"),
    "model.layers.*.self_attn.q_proj.weight": ("embed", "heads"),
    "model.layers.*.self_attn.k_proj.weight": ("embed", "kv_heads"),
    "model.layers.*.self_attn.v_proj.weight": ("embed", "kv_heads"),
    "model.layers.*.self_attn.o_proj.weight": ("heads", "embed"),
    "model.layers.*.self_attn.q_proj.bias": ("heads",),
    "model.layers.*.self_attn.k_proj.bias": ("kv_heads",),
    "model.layers.*.self_attn.v_proj.bias": ("kv_heads",),
    "model.layers.*.self_attn.o_proj.bias": ("embed",),
    "model.layers.*.self_attn.q_norm.weight": ("norm",),
    "model.layers.*.self_attn.k_norm.weight": ("norm",),
    "model.layers.*.mlp.gate_proj.weight": ("embed", "mlp"),
    "model.layers.*.mlp.up_proj.weight": ("embed", "mlp"),
    "model.layers.*.mlp.down_proj.weight": ("mlp", "embed"),
    "model.layers.*.mlp.c_fc.weight": ("embed", "mlp"),
    "model.layers.*.mlp.c_proj.weight": ("mlp", "embed"),
    "model.layers.*.mlp.gate_proj.bias": ("mlp",),
    "model.layers.*.mlp.up_proj.bias": ("mlp",),
    "model.layers.*.mlp.down_proj.bias": ("embed",),
    "model.layers.*.mlp.c_fc.bias": ("mlp",),
    "model.layers.*.mlp.c_proj.bias": ("embed",),
    # an MoE block: the router, the expert stacks (FSDP2 shards their
    # leading `expert` dim) and the shared expert
    "model.layers.*.mlp.gate.weight": ("embed", "expert"),
    "model.layers.*.mlp.experts_gate_proj": ("expert", "embed", "mlp"),
    "model.layers.*.mlp.experts_up_proj": ("expert", "embed", "mlp"),
    "model.layers.*.mlp.experts_down_proj": ("expert", "mlp", "embed"),
    "model.layers.*.mlp.shared_gate_proj": ("embed", "mlp"),
    "model.layers.*.mlp.shared_up_proj": ("embed", "mlp"),
    "model.layers.*.mlp.shared_down_proj": ("mlp", "embed"),
    "model.layers.*.mlp.shared_expert_gate": ("embed", None),
    "model.layers.*.mlp.xielu_alpha_p": (None,),
    "model.layers.*.mlp.xielu_alpha_n": (None,),
    **{f"model.layers.*.{norm}.{leaf}": ("norm",)
       for norm in ("input_layernorm", "post_attention_layernorm", "post_feedforward_layernorm",
                    "post_self_attn_layernorm", "post_mlp_layernorm", "pre_feedforward_layernorm")
       for leaf in ("weight", "bias")},
    "model.norm.weight": ("norm",),
    "model.norm.bias": ("norm",),
    "lm_head.weight": ("embed", "vocab"),
    "lm_head.bias": ("vocab",),
}
_LAYER = re.compile(r"^model\.layers\.\d+\.")


def param_logical_axes(name: str, rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES,
                       ndim: int | None = None) -> tuple[str, ...]:
    """The JAX-orientation logical names of the model parameter `name`
    (of `ndim` dims: a norm weight of more dims than its entry, Cohere's
    per-head qk-norm, takes None before it, as JAX's `LayerNorm` names it),
    resolved strictly: a parameter outside the table, or a name the rules
    do not know, raises `UnknownLogicalAxisError` naming it (as JAX's
    trainer does for its state)."""
    key = _LAYER.sub("model.layers.*.", name)
    axes = PARAM_LOGICAL_AXES.get(key)
    if axes is None:
        raise UnknownLogicalAxisError("<none>", known=tuple(_rules_dict(rules)), path=name)
    if ndim is not None and ndim > len(axes) and axes[-1] == "norm":
        axes = (None,) * (ndim - len(axes)) + axes
    resolve_spec(axes, rules, strict=True, path=name)
    return axes


def _maps_to(axis: str, mesh_axis: str, rules: LogicalAxisRules) -> bool:
    target = _rules_dict(rules).get(axis)
    return target == mesh_axis or (not isinstance(target, str) and mesh_axis in (target or ()))


def tensor_parallel_plan(model: torch.nn.Module,
                         rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES) -> dict:
    """`parallelize_module`'s plan over `tensor` for `model`, from the
    parameters' logical names: {module path: ParallelStyle}."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        SequenceParallel,
    )

    plan = {}
    for name, param in model.named_parameters():
        axes = param_logical_axes(name, rules, param.dim())
        module = name.removesuffix(".weight")
        if module.endswith(("self_attn.q_norm", "self_attn.k_norm")) and param.dim() == 1:
            # a head's qk-norm over a rank's local heads: its weight is
            # replicated and its gradient, partial on each rank, is summed
            # over `tensor` (the heads are dim 2 of [B, S, H, D])
            plan[module] = SequenceParallel(sequence_dim=2, use_local_output=True)
            continue
        if len(axes) != 2:
            continue
        if module.endswith("embed_tokens"):
            if _maps_to(axes[0], TENSOR_AXIS, rules):
                plan[module] = RowwiseParallel(input_layouts=Replicate())
        elif _maps_to(axes[1], TENSOR_AXIS, rules):
            plan[module] = ColwiseParallel()
        elif _maps_to(axes[0], TENSOR_AXIS, rules):
            plan[module] = RowwiseParallel()
    return plan


def _check_divisible(config, tp: int) -> None:
    sizes = {"num_attention_heads": config.num_attention_heads,
             "num_key_value_heads": config.num_key_value_heads,
             "intermediate_size": config.intermediate_size, "vocab_size": config.vocab_size}
    uneven = {k: v for k, v in sizes.items() if v % tp}
    if uneven:
        raise ValueError(f"tensor_parallel_size {tp} does not divide {uneven}")


def batch_mesh(mesh):
    """The mesh FSDP2 runs over: the batch's ranks, `(data, expert)`
    replicating (dropped when both are 1) and `(fsdp, sequence)` sharding,
    each pair flattened into one dimension."""
    shard = mesh[(FSDP_AXIS, SEQUENCE_AXIS)]._flatten("fsdp_sequence")
    if mesh[DATA_AXIS].size() * mesh[EXPERT_AXIS].size() == 1:
        return shard
    mesh[(DATA_AXIS, EXPERT_AXIS)]._flatten("data_expert")
    return mesh[("data_expert", "fsdp_sequence")]


def parallelize(model: torch.nn.Module, mesh, dp_mesh=None,
                rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES) -> torch.nn.Module:
    """Shard one causal LM over `mesh` in place: the tensor-parallel plan
    (when `tensor` is above 1), then `fully_shard` on each decoder layer,
    then on the model. Parameters held in another dtype than the compute
    dtype are gathered in the compute dtype (FSDP2's mixed precision), as
    the single-device path casts them at use; gradients reduce in fp32."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    if not getattr(model, "mesh_ported", True):
        # the non-Llama MoE families and the hybrids: their parameters have
        # no logical names in the table above, so neither plan is derived
        raise NotImplementedError(
            f"{type(model).__name__} on a mesh is not ported (ROADMAP A.9b): the FSDP2 and "
            "tensor-parallel plans cover the Llama, Phi-3 and Gemma parameters")
    for name, param in model.named_parameters():
        param_logical_axes(name, rules, param.dim())  # strict: every parameter has its names
    config = model.config
    tp_mesh = mesh[TENSOR_AXIS]
    if getattr(config, "num_experts", None) and (tp_mesh.size() > 1
                                                 or mesh[EXPERT_AXIS].size() > 1):
        # JAX shards the experts' `mlp` dim over `tensor` and their stacks
        # over `expert` (expert parallelism): neither is ported
        raise NotImplementedError(
            "an MoE model on a mesh whose `tensor` or `expert` axis is above 1 is not "
            "ported (ROADMAP A.9b)")
    if tp_mesh.size() > 1:
        _check_divisible(config, tp_mesh.size())
        parallelize_module(model, tp_mesh, tensor_parallel_plan(model, rules))
    dp_mesh = dp_mesh if dp_mesh is not None else batch_mesh(mesh)
    mp = MixedPrecisionPolicy()
    if config.param_torch_dtype != config.compute_torch_dtype:
        mp = MixedPrecisionPolicy(param_dtype=config.compute_torch_dtype,
                                  reduce_dtype=torch.float32)
    for layer in model.model.layers:
        fully_shard(layer, mesh=dp_mesh, mp_policy=mp)
    fully_shard(model, mesh=dp_mesh, mp_policy=mp)
    return model
