"""The parallelism layer: the device mesh, the sharding rules and the plans
they give (FSDP2 and DTensor tensor parallelism), and ring attention over
the `sequence` axis.

Counterpart of `llm_training_tpu/parallel/`. Axes, in JAX's order:
  data     -- data parallelism (replicated parameters)
  pipe     -- pipeline stages (refused: ROADMAP A.9b)
  fsdp     -- data parallelism with sharded parameters (FSDP2)
  expert   -- extra data parallelism on a dense model (expert parallelism
              of an MoE model: ROADMAP A.9b)
  tensor   -- tensor parallelism (the DTensor plan)
  sequence -- context parallelism over the sequence (ring attention)
"""

from llm_training_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MESH_AXIS_NAMES,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
    MeshConfig,
    build_mesh,
    initialize_distributed,
    resolve_axis_sizes,
)
from llm_training_tpu_torch.parallel.sharding import (
    DEFAULT_LOGICAL_AXIS_RULES,
    KNOWN_LOGICAL_AXES,
    AxisDrop,
    UnknownLogicalAxisError,
    logical_to_sharding,
    logical_to_spec,
    resolve_spec,
    shard_pytree,
)

__all__ = [
    "DATA_AXIS", "EXPERT_AXIS", "FSDP_AXIS", "MESH_AXIS_NAMES", "PIPELINE_AXIS",
    "SEQUENCE_AXIS", "TENSOR_AXIS", "MeshConfig", "build_mesh", "initialize_distributed",
    "resolve_axis_sizes", "DEFAULT_LOGICAL_AXIS_RULES", "KNOWN_LOGICAL_AXES", "AxisDrop",
    "UnknownLogicalAxisError", "logical_to_sharding", "logical_to_spec", "resolve_spec",
    "shard_pytree",
]
