"""The global batch on a mesh: each rank's rows and sequence chunk, and the
sums that make a loss global.

Every rank makes the same global batch (the data stream is a pure function
of the seed and the step) and keeps its own rows by its `(data, fsdp,
expert)` coordinates -- the `batch` rule -- and its own chunk of the
sequence by its `sequence` coordinate. Positions and segment ids stay
global; a CLM's labels are shifted and masked on the global batch before
the chunk is cut (JAX shifts the global array).

`batch_sum` is the psum over the batch's ranks (forward all-reduce,
backward identity): an objective that sums its per-row or per-token terms
through it computes the global loss on every rank, and each rank's
backward gives its own rows' share of the global gradient, which FSDP2 then
sums over the batch mesh. Off a mesh it is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from llm_training_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    SEQUENCE_AXIS,
    active_mesh,
)

BATCH_AXES = (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS)


@dataclass(frozen=True)
class BatchShard:
    """This rank's part of the global batch: rows and sequence positions."""

    rows: slice
    seq: slice
    global_rows: int
    global_seq: int


def _coordinate(mesh, axes) -> tuple[int, int]:
    """(this rank's flattened index over `axes`, their product)."""
    index, ways = 0, 1
    for axis in axes:
        sub = mesh[axis]
        index = index * sub.size() + sub.get_local_rank()
        ways *= sub.size()
    return index, ways


def batch_ways(mesh) -> int:
    return _coordinate(mesh, BATCH_AXES)[1]


def batch_index(mesh) -> int:
    """This rank's index over the batch's rows (`plan_shard` gives it rows
    index * per_rank ..)."""
    return _coordinate(mesh, BATCH_AXES)[0]


def plan_shard(mesh, rows: int, seq: int) -> BatchShard:
    """This rank's rows and chunk of a [rows, seq] global batch. The batch
    must divide over (data, fsdp, expert), as JAX requires it to divide
    over data x fsdp, and the sequence over `sequence`."""
    index, ways = _coordinate(mesh, BATCH_AXES)
    dp_ways = mesh[DATA_AXIS].size() * mesh[FSDP_AXIS].size()
    if rows % dp_ways != 0:
        raise ValueError(
            f"global batch size {rows} must be divisible by data*fsdp mesh ways ({dp_ways})"
        )
    if rows % ways != 0:
        raise ValueError(
            f"global batch size {rows} must be divisible by data*fsdp*expert mesh ways ({ways})"
        )
    sp_index, sp = _coordinate(mesh, (SEQUENCE_AXIS,))
    if seq % sp != 0:
        raise ValueError(f"sequence length {seq} must be divisible by sequence_parallel_size {sp}")
    per_rank, chunk = rows // ways, seq // sp
    return BatchShard(slice(index * per_rank, (index + 1) * per_rank),
                      slice(sp_index * chunk, (sp_index + 1) * chunk), rows, seq)


def shard_batch(batch: dict, shard: BatchShard) -> dict:
    """Each entry's rows, and its sequence chunk where its second dimension
    is the sequence."""
    out = {}
    for key, value in batch.items():
        value = value[shard.rows]
        if value.ndim >= 2 and value.shape[1] == shard.global_seq:
            value = value[:, shard.seq]
        out[key] = value
    return out


def with_global_positions(batch: dict, key: str = "input_ids") -> dict:
    """The batch with `position_ids` made explicit (0..S-1 per row when
    absent), so a sequence chunk keeps its global positions."""
    if key in batch and "position_ids" not in batch:
        rows, seq = batch[key].shape[:2]
        batch = {**batch, "position_ids": np.broadcast_to(np.arange(seq, dtype=np.int32),
                                                          (rows, seq)).copy()}
    return batch


class ShardedBatch(dict):
    """A rank's batch on a mesh (device tensors), with the shard of the
    global batch it is: the objective reads the global widths from it."""

    def __init__(self, batch: dict, shard: BatchShard):
        super().__init__(batch)
        self.shard = shard


_groups: dict = {}


def batch_group(mesh=None):
    """The process group of the ranks that hold other rows or tokens of the
    batch (data, fsdp, expert, sequence) at this rank's tensor coordinate;
    None off a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return None
    key = id(mesh)
    if key not in _groups:
        sub = mesh[(DATA_AXIS, FSDP_AXIS, EXPERT_AXIS, SEQUENCE_AXIS)]
        _groups[key] = (mesh, sub._flatten("batch").get_group())
    return _groups[key][1]


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the batch's ranks (gradient: the identity);
    `x` itself off a mesh."""
    group = batch_group()
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _BatchSum.apply(x, group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x`'s elements over the whole batch (`x.mean()` off a
    mesh)."""
    group = batch_group()
    if group is None or dist.get_world_size(group) == 1:
        return x.mean()
    count = torch.tensor(float(x.numel()), device=x.device)
    return batch_sum(x.sum()) / batch_sum(count)
