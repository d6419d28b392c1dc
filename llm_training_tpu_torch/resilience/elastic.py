"""Elastic training: the topology planner, data continuity, and each fit
segment's record of the world it ran in.

Counterpart of `llm_training_tpu/resilience/elastic.py` (dataclasses where
JAX's config is a pydantic model):

- **Topology planner** (`plan_topology`): given the live device count, the
  checkpoint's recorded mesh degrees and the config's, pick the mesh: the
  model axes (pipe/fsdp/expert/tensor/sequence) stay at the degrees the
  checkpoint was written with and `data` absorbs the capacity change. A
  pure function, equal to JAX's. `plan_live_world` runs it over the live
  world (the process group's ranks), and a resume onto other degrees
  reshards through DCP.
- **Data continuity** (`check_data_continuity`): the (seed, step) sample
  stream is keyed to the GLOBAL batch; a resume that changes it is refused
  under elastic and warned about otherwise.
- **Segment topology logging** (`log_segment_topology`): every supervised
  fit segment appends its world (device count, mesh degrees, planner
  decision, chip price) to the supervisor's `supervisor.jsonl`, keyed by
  the supervisor attempt.
- **Chaos device shrink** (`chaos_device_limit` / `visible_device_count`):
  `LLMT_CHAOS_DEVICES=<n>` clamps the visible device set; a comma schedule
  (`"8,4"`) is indexed by the supervisor attempt.
- **Goodput-per-dollar**: each segment's ledger is tagged with its chip
  count and $/chip-hour (`LLMT_CHIP_PRICE_PER_HOUR` > the config's
  `price_per_chip_hour`).

Importable without touching CUDA (the supervisor reads it); only
`visible_device_count` asks torch for the device count, and the supervisor
calls it in a probe subprocess.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

logger = logging.getLogger(__name__)

# exported to every supervised child: 1-based launch attempt and the
# supervisor.jsonl path segments append their topology events to
ATTEMPT_ENV = "LLMT_SUPERVISOR_ATTEMPT"
SUPERVISOR_LOG_ENV = "LLMT_SUPERVISOR_LOG"
# chaos: clamp the visible device set (int, or a comma schedule indexed by
# the supervisor attempt)
CHAOS_DEVICES_ENV = "LLMT_CHAOS_DEVICES"
# $/chip-hour for goodput-per-dollar accounting (overrides the config)
CHIP_PRICE_ENV = "LLMT_CHIP_PRICE_PER_HOUR"

# the axes elastic resume holds FIXED: they shard the model, while `data`
# only changes replication
MODEL_AXES = ("pipe", "fsdp", "expert", "tensor", "sequence")
DATA_AXIS = "data"
# JAX's mesh axis order (`llm_training_tpu/parallel/mesh.py`)
MESH_AXES = (DATA_AXIS,) + MODEL_AXES


class ElasticTopologyError(RuntimeError):
    """The live device pool cannot host the checkpoint's model axes (or the
    config conflicts with them): a human or a config change is needed."""


@dataclass
class ElasticConfig:
    """`trainer.resilience.elastic.*`: presence of the block enables
    topology planning at fit start. The supervisor-side capacity knobs
    (`--min-devices`, `--probe-backoff-s`, `--probe-max-wait-s`) live on the
    `supervise` command."""

    # $/chip-hour for the goodput-per-dollar accounting;
    # LLMT_CHIP_PRICE_PER_HOUR overrides at fit start
    price_per_chip_hour: float | None = None

    def __post_init__(self):
        if self.price_per_chip_hour is not None and not self.price_per_chip_hour > 0:
            raise ValueError(
                f"elastic.price_per_chip_hour must be > 0, got {self.price_per_chip_hour}")


@dataclass
class TopologyPlan:
    """What one fit segment runs on (returned by `plan_topology`)."""

    device_count: int                 # devices the mesh will actually use
    spare_devices: int                # visible but unused (non-divisible pool)
    axis_sizes: dict[str, int] = field(default_factory=dict)  # fully resolved
    decision: str = ""                # human-readable planner decision
    source: str = "config"            # "checkpoint" | "config"

    @property
    def data_parallel_size(self) -> int:
        return self.axis_sizes.get(DATA_AXIS, 1)


def _prod(values) -> int:
    return math.prod(int(v) for v in values)


def plan_topology(
    available_devices: int,
    config_sizes: dict[str, int],
    checkpoint_mesh: dict[str, int] | None = None,
    global_batch_size: int | None = None,
) -> TopologyPlan:
    """Pick the mesh for a segment: model axes fixed, `data` elastic.

    `config_sizes` holds the config's axis degrees (-1 = auto on at most one
    axis); `checkpoint_mesh` is the `topology.mesh` rider of the checkpoint
    being resumed (None on fresh starts); `global_batch_size` (the
    `data_state` rider) keeps `data` to degrees the batch can shard over.

    - with a checkpoint: model axes come from it; an explicit config value
      (not -1) that differs is an error;
    - `data` = available // model_ways (>= 1 or error), clamped down to the
      largest degree the global batch divides (batch % (data*fsdp) == 0);
    - without a checkpoint: an auto model axis is filled with data at its
      config value; otherwise data scales to fit and a non-divisible
      remainder becomes `spare_devices`.
    """
    if available_devices < 1:
        raise ElasticTopologyError("no visible devices to build a mesh on")
    checkpoint_mesh = checkpoint_mesh or {}
    if int(config_sizes.get(DATA_AXIS, 1)) == -1 and any(
        int(config_sizes.get(axis, 1)) == -1 for axis in MODEL_AXES
    ):
        raise ElasticTopologyError(
            "at most one mesh axis may be -1 (auto); got data plus "
            + str([a for a in MODEL_AXES if int(config_sizes.get(a, 1)) == -1])
        )

    model: dict[str, int] = {}
    auto_axis: str | None = None
    for axis in MODEL_AXES:
        conf = int(config_sizes.get(axis, 1))
        ckpt = checkpoint_mesh.get(axis)
        if ckpt is not None:
            ckpt = int(ckpt)
            if conf not in (-1, ckpt):
                raise ElasticTopologyError(
                    f"config mesh {axis}={conf} conflicts with the "
                    f"checkpoint's {axis}={ckpt}: elastic resume keeps the "
                    "model axes fixed (only `data` scales). Set the config "
                    "to match the checkpoint, or disable "
                    "trainer.resilience.elastic to reshard explicitly."
                )
            model[axis] = ckpt
        elif conf == -1:
            auto_axis = axis
            model[axis] = 0  # filled below (fresh start only)
        else:
            model[axis] = conf

    config_data = int(config_sizes.get(DATA_AXIS, 1))
    source = "checkpoint" if checkpoint_mesh else "config"

    if auto_axis is not None:
        fixed = _prod(v for a, v in model.items() if a != auto_axis)
        data = max(config_data, 1)
        denom = fixed * data
        filled = available_devices // denom
        if filled < 1:
            raise ElasticTopologyError(
                f"cannot fill auto axis {auto_axis!r}: fixed axes use "
                f"{denom} of {available_devices} visible devices"
            )
        model[auto_axis] = filled
        used = denom * filled
        return TopologyPlan(
            device_count=used,
            spare_devices=available_devices - used,
            axis_sizes={DATA_AXIS: data, **model},
            decision=f"fresh start: filled {auto_axis}={filled}, data={data}",
            source=source,
        )

    model_ways = _prod(model.values())
    if model_ways > available_devices:
        raise ElasticTopologyError(
            f"model axes {model} need {model_ways} devices but only "
            f"{available_devices} are visible: elastic resume scales only "
            "the data axis — this pool cannot host the model sharding. "
            "Wait for capacity (supervise --min-devices) or retrain with "
            "smaller model axes."
        )
    data = available_devices // model_ways
    batch_note = ""
    if global_batch_size:
        fsdp = model.get("fsdp", 1)
        fitted = data
        while fitted > 1 and int(global_batch_size) % (fitted * fsdp) != 0:
            fitted -= 1
        if fitted != data and int(global_batch_size) % (fitted * fsdp) == 0:
            batch_note = (
                f", data clamped {data}->{fitted} to divide the global "
                f"batch ({global_batch_size})"
            )
            data = fitted
    used = data * model_ways
    spare = available_devices - used

    old_data = checkpoint_mesh.get(DATA_AXIS)
    if old_data is not None and int(old_data) != data:
        decision = f"scaled data {int(old_data)}->{data}"
    elif checkpoint_mesh:
        decision = f"unchanged (data={data})"
    elif config_data == -1 or config_data == data:
        decision = f"fresh start: data={data}"
    else:
        decision = f"fresh start: scaled data {config_data}->{data} to fit"
    decision += batch_note
    if spare:
        decision += f", {spare} spare device(s) unused"
    return TopologyPlan(
        device_count=used,
        spare_devices=spare,
        axis_sizes={DATA_AXIS: data, **model},
        decision=decision,
        source=source,
    )


def single_device_mesh() -> dict[str, int]:
    """The port's one-card world as JAX's mesh degrees: every axis 1."""
    return {axis: 1 for axis in MESH_AXES}


def plan_live_world(
    world_size: int,
    config_sizes: dict[str, int],
    checkpoint_mesh: dict[str, int] | None = None,
    global_batch_size: int | None = None,
) -> TopologyPlan:
    """JAX's planner over the live world: the process group's ranks (1
    without one). A torchrun world cannot leave ranks idle, so a plan that
    uses fewer than all of them raises `ElasticTopologyError`; pipeline
    stages raise `NotImplementedError` (ROADMAP A.9b)."""
    plan = plan_topology(world_size, config_sizes, checkpoint_mesh=checkpoint_mesh,
                         global_batch_size=global_batch_size)
    if plan.axis_sizes.get("pipe", 1) > 1:
        raise NotImplementedError(
            f"elastic plan {plan.axis_sizes} shards the pipe axis: pipeline stages are not "
            "ported yet (ROADMAP A.9b)"
        )
    if plan.device_count != world_size:
        raise ElasticTopologyError(
            f"elastic plan {plan.axis_sizes} ({plan.decision}) uses {plan.device_count} of "
            f"{world_size} ranks: relaunch with {plan.device_count} processes"
        )
    return plan


# ------------------------------------------------------------ environment


def segment_attempt() -> int:
    """The supervisor launch attempt this process is (1 outside a
    supervisor)."""
    try:
        return max(1, int(os.environ.get(ATTEMPT_ENV, "1") or 1))
    except ValueError:
        return 1


def chaos_device_limit(attempt: int | None = None) -> int | None:
    """The LLMT_CHAOS_DEVICES clamp for this launch, or None.

    A single int clamps every launch; a comma schedule ("8,4") is indexed
    by the (1-based) supervisor attempt, clamping to the last entry past
    the end. Malformed values are ignored with a warning."""
    raw = os.environ.get(CHAOS_DEVICES_ENV)
    if not raw:
        return None
    try:
        schedule = [int(part) for part in raw.split(",") if part.strip()]
    except ValueError:
        logger.warning("ignoring malformed %s=%r", CHAOS_DEVICES_ENV, raw)
        return None
    if not schedule:
        return None
    if attempt is None:
        attempt = segment_attempt()
    limit = schedule[min(max(attempt, 1), len(schedule)) - 1]
    return limit if limit > 0 else None


def visible_device_count() -> int:
    """Visible CUDA device count after the chaos clamp. Reading the count
    leaves torch's CUDA state uninitialized; the supervisor still calls it
    in a probe subprocess, never in its own process."""
    import torch

    count = torch.cuda.device_count()
    limit = chaos_device_limit()
    return min(count, limit) if limit is not None else count


def resolve_chip_price(config: ElasticConfig | None) -> float | None:
    """$/chip-hour: LLMT_CHIP_PRICE_PER_HOUR env > config. None = unknown."""
    raw = os.environ.get(CHIP_PRICE_ENV)
    if raw:
        try:
            price = float(raw)
            if price > 0:
                return price
            logger.warning("ignoring non-positive %s=%r", CHIP_PRICE_ENV, raw)
        except ValueError:
            logger.warning("ignoring malformed %s=%r", CHIP_PRICE_ENV, raw)
    return config.price_per_chip_hour if config is not None else None


# ------------------------------------------------------------ audit trail


def log_segment_topology(
    mesh_sizes: dict[str, int],
    device_count: int,
    decision: str | None = None,
    price_per_chip_hour: float | None = None,
    path: str | Path | None = None,
    attempt: int | None = None,
) -> dict | None:
    """Append this segment's world to the supervisor's event log.

    `path` defaults to $LLMT_SUPERVISOR_LOG (set by the Supervisor for its
    children); with neither, this is a no-op. Returns the record written,
    or None. Never raises: a full disk must not kill the segment it is
    auditing."""
    path = path or os.environ.get(SUPERVISOR_LOG_ENV)
    if not path:
        return None
    record = {
        "ts": time.time(),
        "event": "segment_topology",
        "attempt": attempt if attempt is not None else segment_attempt(),
        "device_count": int(device_count),
        "mesh": {str(k): int(v) for k, v in mesh_sizes.items()},
    }
    if decision:
        record["decision"] = decision
    if price_per_chip_hour is not None:
        record["price_per_chip_hour"] = float(price_per_chip_hour)
    try:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        logger.warning("could not append segment_topology to %s", path)
    return record


def verify_restored_topology(plan: TopologyPlan, topology: dict | None) -> None:
    """Cross-check the restored checkpoint's recorded model-axis degrees
    against the planned mesh: a restore that fell back to a step of another
    topology must not continue as if its model axes were the plan's."""
    mesh = (topology or {}).get("mesh") or {}
    mismatched = {
        axis: (int(mesh[axis]), plan.axis_sizes.get(axis, 1))
        for axis in MODEL_AXES
        if axis in mesh and int(mesh[axis]) != int(plan.axis_sizes.get(axis, 1))
    }
    if mismatched:
        raise ElasticTopologyError(
            f"the restored checkpoint's model axes differ from the planned "
            f"mesh: {{axis: (checkpoint, planned)}} = {mismatched} — the "
            "checkpoint metadata was unreadable at planning time (or an "
            "older step with a different topology was restored), and "
            "continuing would reshard model axes silently. Retry the "
            "relaunch, or set the config's model axes to the checkpoint's "
            "degrees."
        )


# ------------------------------------------------------------ data stream


def check_data_continuity(data_state: dict | None, global_batch_size: int,
                          elastic: bool) -> None:
    """Refuse (elastic) or warn (otherwise) when a resume changes the
    GLOBAL batch size: the (seed, step) sample stream is keyed to it, so
    the restored cursor would address other samples."""
    if not data_state:
        return
    saved = int(data_state.get("global_batch_size", 0) or 0)
    if not saved or saved == int(global_batch_size):
        return
    message = (
        f"resume changes the GLOBAL batch size {saved} -> "
        f"{int(global_batch_size)}: the (seed, step) sample stream is keyed "
        "to the global batch, so the checkpoint's sample cursor "
        f"({data_state.get('sample_cursor', '?')} samples) no longer "
        "addresses the same data. Scale data_parallel_size (the per-replica "
        "share), never the global batch, across an elastic resume."
    )
    if elastic:
        raise ValueError(message)
    logger.warning(message)
