"""Device mesh construction and multi-process initialization.

Counterpart of `llm_training_tpu/parallel/mesh.py`: `MeshConfig` with
JAX's six axes, defaults and errors, the pure `resolve_axis_sizes`, and
`build_mesh`, which returns a `torch.distributed.device_mesh.DeviceMesh`
over (data, pipe, fsdp, expert, tensor, sequence) -- NCCL on `cuda`, gloo
on `cpu`. `initialize_distributed` is the rendezvous: where JAX reads
`JAX_COORDINATOR_ADDRESS` and SLURM's task variables, the port reads
torchrun's (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` /
`MASTER_PORT`) and SLURM's (`SLURM_NTASKS`, `SLURM_PROCID`,
`SLURM_LOCALID`). As in JAX, a failure is fatal when a multi-process run
is clearly intended and logged otherwise; a one-process run makes no
process group at all.

`use_mesh` installs the mesh the model code reads (`active_mesh`), as
JAX's `with mesh:` block does: the ring attention dispatch looks for a
`sequence` axis there.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
PIPELINE_AXIS = "pipe"
FSDP_AXIS = "fsdp"
EXPERT_AXIS = "expert"
TENSOR_AXIS = "tensor"
SEQUENCE_AXIS = "sequence"

# JAX's order: data outermost, then pipe, the per-layer fsdp gathers, and
# the latency-critical tensor/sequence collectives innermost (a rank's
# neighbours on those axes are the adjacent ranks, the same node's cards)
MESH_AXIS_NAMES = (
    DATA_AXIS, PIPELINE_AXIS, FSDP_AXIS, EXPERT_AXIS, TENSOR_AXIS, SEQUENCE_AXIS
)

_FIELDS = {
    DATA_AXIS: "data_parallel_size",
    PIPELINE_AXIS: "pipeline_parallel_size",
    FSDP_AXIS: "fsdp_size",
    EXPERT_AXIS: "expert_parallel_size",
    TENSOR_AXIS: "tensor_parallel_size",
    SEQUENCE_AXIS: "sequence_parallel_size",
}


@dataclass
class MeshConfig:
    """Mesh axis sizing. -1 on exactly one axis fills it with the remaining
    devices. The defaults are pure FSDP over every device."""

    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    fsdp_size: int = -1
    expert_parallel_size: int = 1
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1

    def __post_init__(self):
        for name in _FIELDS.values():
            value = getattr(self, name)
            if isinstance(value, bool) or not isinstance(value, int):
                raise ValueError(f"MeshConfig.{name} must be an int, got {value!r}")

    def axis_sizes(self) -> dict[str, int]:
        return {axis: getattr(self, name) for axis, name in _FIELDS.items()}

    @classmethod
    def from_axis_sizes(cls, sizes: dict[str, int]) -> "MeshConfig":
        """Inverse of `axis_sizes()` (the elastic planner's degrees become a
        mesh config). Missing axes default to 1."""
        return cls(**{name: int(sizes.get(axis, 1)) for axis, name in _FIELDS.items()})


def resolve_axis_sizes(config: MeshConfig, num_devices: int) -> dict[str, int]:
    sizes = config.axis_sizes()
    auto_axes = [name for name, size in sizes.items() if size == -1]
    if len(auto_axes) > 1:
        raise ValueError(f"at most one mesh axis may be -1 (auto); got {auto_axes}")
    for name, size in sizes.items():
        if size < 1 and size != -1:
            raise ValueError(f"mesh axis {name!r} must be >= 1 or -1, got {size}")

    fixed = math.prod(s for s in sizes.values() if s != -1)
    if auto_axes:
        if num_devices % fixed != 0:
            raise ValueError(
                f"cannot factor {num_devices} devices: fixed axes use {fixed}"
            )
        sizes[auto_axes[0]] = num_devices // fixed
    elif fixed != num_devices:
        raise ValueError(
            f"mesh {sizes} uses {fixed} devices but {num_devices} are available"
        )
    return sizes


def build_mesh(config: MeshConfig | None = None, device: str = "cuda",
               world_size: int | None = None):
    """The 6-axis `DeviceMesh` over the process group's ranks (rank r is
    the r-th device in row-major order, as JAX lays `jax.devices()` out).
    `device` is `cuda` (the group's backend must be NCCL) or `cpu`
    (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("build_mesh needs a process group (initialize_distributed)")
    if world_size is None:
        world_size = dist.get_world_size()
    sizes = resolve_axis_sizes(config, world_size)
    if device == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(f"a cuda mesh runs on NCCL; the process group uses {dist.get_backend()}")
    shape = tuple(sizes[name] for name in MESH_AXIS_NAMES)
    mesh = init_device_mesh(device, shape, mesh_dim_names=MESH_AXIS_NAMES)
    logger.info("mesh: %s over %d ranks (%s)", dict(zip(MESH_AXIS_NAMES, shape)),
                world_size, device)
    return mesh


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a mesh built by `build_mesh`."""
    return {name: int(size) for name, size in zip(mesh.mesh_dim_names, mesh.shape)}


_active = None


def active_mesh():
    """The mesh `use_mesh` installed, or None."""
    return _active


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` as the active one for the block (model code reads it
    through `active_mesh`)."""
    global _active
    previous, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = previous


# ------------------------------------------------------------ rendezvous


@dataclass(frozen=True)
class DistInfo:
    rank: int
    world_size: int
    local_rank: int


def _env_int(*names: str) -> int | None:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def _multi_host_intended(coordinator_address: str | None) -> bool:
    return bool(
        coordinator_address
        or (_env_int("WORLD_SIZE") or 1) > 1
        or (_env_int("SLURM_NTASKS") or 1) > 1
    )


def is_primary() -> bool:
    """Rank 0 of the process group, or the only process: the one that writes
    a run's files, as JAX's process 0 does."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def local_rank() -> int:
    """This process's card on its node: torchrun's `LOCAL_RANK`, SLURM's
    `SLURM_LOCALID`, else 0."""
    return _env_int("LOCAL_RANK", "SLURM_LOCALID") or 0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
) -> DistInfo:
    """The process group of a multi-process run (the counterpart of
    `jax.distributed.initialize`). Coordinates come from the arguments,
    else torchrun's environment, else SLURM's; the rendezvous address is
    `coordinator_address` (`host:port`) or `MASTER_ADDR` / `MASTER_PORT`.
    A run of one process makes no group. `LOCAL_RANK` picks the card
    (NCCL). An existing group is kept (idempotent).

    Failures are fatal when a multi-process run is clearly intended (a
    coordinator, `WORLD_SIZE` or `SLURM_NTASKS` above 1); a single-process
    run logs and continues."""
    if dist.is_available() and dist.is_initialized():
        return DistInfo(dist.get_rank(), dist.get_world_size(), local_rank())
    world_size = num_processes or _env_int("WORLD_SIZE", "SLURM_NTASKS") or 1
    rank = process_id if process_id is not None else (_env_int("RANK", "SLURM_PROCID") or 0)
    info = DistInfo(rank, world_size, local_rank())
    if world_size == 1 and not coordinator_address:
        return info
    try:
        if backend == "nccl":
            torch.cuda.set_device(info.local_rank)
        if coordinator_address:
            init_method = f"tcp://{coordinator_address}"
        else:
            for name in ("MASTER_ADDR", "MASTER_PORT"):
                if not os.environ.get(name):
                    raise ValueError(f"{name} is not set (launch with torchrun, or export it)")
            init_method = "env://"
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    except (ValueError, RuntimeError) as e:
        if _multi_host_intended(coordinator_address):
            raise RuntimeError(
                "multi-process run detected but torch.distributed.init_process_group failed"
            ) from e
        logger.info("single-process run; init_process_group skipped: %s", e)
    return info
