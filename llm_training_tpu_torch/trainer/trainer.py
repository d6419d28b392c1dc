"""The training loop.

Counterpart of the core of `llm_training_tpu/trainer/trainer.py`: the
train step of `_make_step` (forward, backward, global grad norm, the
optimizer chain) and the micro-step loop of `_fit_inner`, with gradient
accumulation as `optax.MultiSteps` does it, metrics on log steps and the
validation loss. `max_steps` counts optimizer steps: the loop runs
`max_steps * accumulate_grad_batches` micro-steps, and the schedule
advances once per optimizer step.

The run lifecycle: with a `Checkpointer`, `fit` restores the newest (or a
given) step before its loop -- state, consumed counters, callback state,
recovery riders -- and restarts the data stream at the restored
micro-step, saves every `checkpoint_every_n_steps` optimizer steps (never
a state whose loss is not finite, nor one a guard flagged) and once at the
end, then waits for the write. `restore_for_inference` is the read-only
restore of the inference and validation commands.

`prefetch_batches` (default 2, as JAX's) places batches on the device a
few steps ahead on a worker thread (`data/prefetch.py`); 0 places each
batch when the step takes it. `offload_optimizer_state` keeps the
optimizer's state in pinned host memory between updates, stored through
`offload_state_dtype` (float32, bfloat16, or int8 blocks of
`offload_quant_block` elements; `optim/offload.py`), with JAX's defaults
and validation errors.

Telemetry, health and resilience around the loop, as JAX's `fit` wires
them: a fresh `TelemetryRegistry` installed as the process's current one
and a `GoodputLedger` bracketing compile (the first micro-step: the
kernels' build and warm-up), data_wait, step_compute, validation and
checkpoint_save; the log steps' metrics gain the ledger's summary, the
`hbm/*` gauges and the registry's snapshot, and the epilogue hands one
last record to `on_telemetry`. `health.every_n_steps` adds the per-layer
norms of `telemetry/health.py` (no change to the step's math).

The live tier, as JAX's `fit` wires it (rank 0's on a mesh, as JAX's are
process 0's): the tracer's `segment_start` instant, a `compile` span over
the first micro-step, per-step `data_load` / `train_step` spans (in the
sink only with `LLMT_TRACE_TRAIN=1`; the ring always records them),
`validation` and `checkpoint_save` spans, and a `rollback` instant with a
flight dump of the ring beside each rollback; the sink, a logger's
`<run_dir>/trace.jsonl`, attached for the fit; an SLO monitor
(`LLMT_SLO_STEP_TIME_P99_S`, `LLMT_SLO_GOODPUT_PCT_MIN`) fed every
optimizer-step interval and every log step's goodput; the `/metrics`,
`/healthz`, `/statusz` and `/profilez` exporter (`LLMT_METRICS_PORT`); and
the profile trigger, which also takes over a `ProfilerCallback`'s window.
The epilogue publishes the tracer's counts as `trace/*` gauges.
`resilience` installs the fault-injection harness, SIGTERM/SIGINT
handling (an emergency save at the next step boundary, then
`PreemptionInterrupt`), the hang watchdog fed by the loop and the
prefetcher, data retries, and with `resilience.recovery` the in-process
rollback-and-skip driver around NanGuard's errors; chaos SIGKILL at a
step boundary of a fresh start (the `supervise` path). Every one of these
is restored when `fit` returns or raises, and every callback's
`teardown()` runs then.

The elastic front door of JAX's `fit`: each fit tags its ledger with its
chip count and price (`set_cost_basis`), sets the `elastic/*` gauges and,
under a supervisor, appends a `segment_topology` event to
`supervisor.jsonl`; with `resilience.elastic` set it runs JAX's topology
planner over the live world (the process group's ranks, 1 without one) and
refuses a resume that changes the global batch (warned about otherwise).
Checkpoints carry the `topology` rider: the live mesh's degrees.

The callback hooks are JAX's: `on_fit_start(trainer, objective,
datamodule, start_step)`, `on_train_step(trainer, step)` (every optimizer
step), `on_step_end(trainer, step, metrics)` (log steps, host metrics),
`on_validation_end(trainer, step, metrics)`, `on_rollback(trainer,
step)`, `on_telemetry(trainer, step, record)`, `on_fit_end(trainer,
state)` and `teardown()`, plus `state_dict` / `load_state_dict` for state
that a checkpoint carries. A callback stops the loop by setting
`trainer.should_stop`, and vetoes the final save with
`trainer.abort_final_save`.

The mesh (`trainer.mesh`, JAX's `MeshConfig`): inside a process group
(torchrun, `parallel/mesh.py`) `fit` builds the 6-axis `DeviceMesh` and
shards the model (`parallel/sharding.py`: the tensor-parallel plan, then
FSDP2 per decoder layer, then the root). Every rank makes the same global
batch and keeps its rows and sequence chunk (`parallel/batch.py`); the
objectives' sums run over the batch's ranks, so the loss is the global
batch's on every rank, and the gradients (scaled by the batch mesh's size,
which FSDP2 averages over) are the global ones. The global norm combines
the meshes of the parameters; checkpoints go through DCP, sharded; rank 0
alone writes the run's files. Without a process group the fit runs on one
device as before. Pipeline stages, offloaded state and Adafactor on more
than one rank, health metrics and sequence-sharded preference objectives
on a mesh raise (ROADMAP A.9b).
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import logging
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from llm_training_tpu_torch import prng, resolve_device
from llm_training_tpu_torch.callbacks.nan_guard import LossSpikeError, NonFiniteLossError
from llm_training_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from llm_training_tpu_torch.models.llama.from_jax import PAIRS
from llm_training_tpu_torch.models.moe_scan_io import JaxLayout
from llm_training_tpu_torch.optim.builder import build_optimizer, global_norm, local_tensor
from llm_training_tpu_torch.optim.offload import check_offload_keys
from llm_training_tpu_torch.parallel import batch as batching
from llm_training_tpu_torch.parallel.mesh import (
    SEQUENCE_AXIS,
    MeshConfig,
    build_mesh,
    is_primary,
    local_rank,
    mesh_axis_sizes,
    resolve_axis_sizes,
    use_mesh,
)
from llm_training_tpu_torch.parallel.sharding import batch_mesh, parallelize
from llm_training_tpu_torch.resilience import (
    GracefulShutdown,
    HangWatchdog,
    PreemptionInterrupt,
    RecoveryExhaustedError,
    RecoveryManager,
    ResilienceConfig,
    config_from_env,
    get_chaos,
    install_chaos,
    uninstall_chaos,
)
from llm_training_tpu_torch.resilience.elastic import (
    TopologyPlan,
    chaos_device_limit,
    check_data_continuity,
    log_segment_topology,
    plan_live_world,
    resolve_chip_price,
    segment_attempt,
    single_device_mesh,
    verify_restored_topology,
)
from llm_training_tpu_torch.telemetry import (
    GoodputLedger,
    HBMTimeline,
    HealthConfig,
    TelemetryRegistry,
    build_param_groups,
    build_profile_trigger,
    build_slo_monitor,
    get_tracer,
    hbm_gauges,
    layer_health_metrics,
    layer_health_tensor,
    resolve_run_dir,
    set_profile_trigger,
    set_registry,
    start_exporter,
)
from llm_training_tpu_torch.telemetry.health import sq_norm
from llm_training_tpu_torch.trainer.checkpoint import Checkpointer
from llm_training_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)

# the objective attributes that hold its modules: captured at fit start so a
# rollback with no committed checkpoint can rebuild them from the seed
_MODEL_ATTRS = ("model", "ref_model", "pair")


@dataclass
class TrainerConfig:
    max_steps: int = 1000
    seed: int = 42
    accumulate_grad_batches: int = 1
    log_every_n_steps: int = 10
    val_check_interval: int | None = None
    limit_val_batches: int | None = None
    checkpoint_every_n_steps: int | None = None
    # batches placed on the device ahead of the step by a worker thread; 0
    # places each batch when the step takes it
    prefetch_batches: int = 2
    # keep the optimizer state in pinned host memory between updates,
    # copied through the device around each update
    offload_optimizer_state: bool = False
    # its storage: float32 (exact), bfloat16 (cast), or int8 (block codec:
    # optim/quantized_state.py)
    offload_state_dtype: str = "float32"
    # the int8 codec's block (elements of the JAX array's last axis that
    # share one scale)
    offload_quant_block: int = 256
    # per-layer grad/param/update norms every `health.every_n_steps`
    # optimizer steps (telemetry/health.py); unset computes none
    health: HealthConfig = field(default_factory=HealthConfig)
    # preemption handling (on by default: free until a signal arrives),
    # the hang watchdog (off by default), data retries, recovery and fault
    # injection (resilience/)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    # the device mesh of a multi-process fit (parallel/mesh.py); a fit
    # without a process group runs on one device
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self):
        check_offload_keys(self.offload_optimizer_state, self.offload_state_dtype,
                           self.offload_quant_block)


def _batch_counts(batch: dict[str, np.ndarray]) -> tuple[int, int]:
    """(samples, tokens) of a host batch, CLM (`input_ids`) or preference
    (`chosen_input_ids`, `rejected_input_ids`): tokens are the non-padding
    ones of every `*input_ids` key, by its `*segment_ids`."""
    id_keys = [k for k in batch if k == "input_ids" or k.endswith("_input_ids")]
    tokens = 0
    for key in id_keys:
        seg = batch.get(key[: -len("input_ids")] + "segment_ids")
        tokens += int((seg > 0).sum()) if seg is not None else int(batch[key].size)
    return int(batch[id_keys[0]].shape[0]), tokens


def _objective_supports_health(objective) -> bool:
    """Whether the objective reports health extras (an MoE model's router
    statistics) through a `with_health` flag, as JAX's CLM does."""
    try:
        return "with_health" in inspect.signature(objective.loss_and_metrics).parameters
    except (TypeError, ValueError):
        return False


def _host_metrics(metrics: dict) -> dict[str, float]:
    """The step's metrics on the host in one transfer: the device scalars
    stacked (in float64, which holds every float32 and every count
    exactly) and copied once."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    host = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        values = torch.stack([metrics[k].detach().reshape(()).to(torch.float64) for k in keys])
        host.update(zip(keys, values.tolist()))
    return {k: host[k] for k in metrics}


class _HostBatch(dict):
    """A rank's part of a global host batch, carrying the global batch's
    (samples, tokens)."""

    counts: tuple[int, int]


def _host_counts(batch) -> tuple[int, int]:
    return getattr(batch, "counts", None) or _batch_counts(batch)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _scan_layers(module: torch.nn.Module) -> bool | str | JaxLayout:
    """The JAX layout of the objective's model config (`scan_layers`, JAX's
    default True; `from_jax.PAIRS` for Gemma-2's scanned (sliding, full)
    pairs; a non-Llama MoE family's `jax_layout`): the tree
    `frozen_modules` patterns are matched against. A policy and reference
    pair takes the policy's."""
    config = getattr(getattr(module, "policy", module), "config", None)
    if hasattr(config, "jax_layout"):
        return config.jax_layout
    scan = bool(getattr(config, "scan_layers", True))
    return PAIRS if scan and getattr(config, "paired", False) else scan


class Trainer:
    """Drives an objective over a datamodule: `Trainer(config).fit(objective,
    datamodule)`. `trainer.state` is the live `TrainState` from the fit's
    start (after any restore); `trainer.telemetry` and `trainer.ledger`
    the fit's registry and goodput ledger; `trainer.last_health` the newest
    health step's host metrics; `trainer.rollbacks` one record per
    in-process rollback (failed step, restored micro-step, skipped window,
    seconds)."""

    def __init__(
        self,
        config: TrainerConfig,
        callbacks: list[Any] | None = None,
        device: torch.device | str | None = None,
        run_config: dict | None = None,
        checkpointer: Checkpointer | None = None,
    ):
        self.config = config
        self.callbacks = callbacks or []
        self.device = resolve_device(device)
        self.run_config = run_config
        self.checkpointer = checkpointer
        self.counters = {"consumed_samples": 0, "consumed_tokens": 0}
        self.state: TrainState | None = None
        self.should_stop = False
        # callbacks set this when the state must NOT be persisted (the NaN
        # guard stopping on divergence: saving would poison a resume)
        self.abort_final_save = False
        # the last optimizer step of a fit, its metrics, and its interval save
        self.last_step: int | None = None
        self.last_metrics: dict | None = None
        self.last_seq_len: int | None = None
        self.last_health: dict[str, float] | None = None
        # the fit epilogue's telemetry record (what on_telemetry received)
        self.last_telemetry: dict | None = None
        self._last_interval_save: int | None = None
        self._global_batch_size: int | None = None
        self._param_groups = None
        # per fit: the registry (the prefetcher records into it from its
        # thread) and the goodput ledger
        self.telemetry = TelemetryRegistry()
        self.ledger = GoodputLedger()
        self._shutdown: GracefulShutdown | None = None
        self._watchdog: HangWatchdog | None = None
        self._hbm_timeline: HBMTimeline | None = None
        # the live tier, per fit: the SLO monitor, the profile trigger and
        # the /metrics exporter
        self._slo = None
        self._profile_trigger = None
        self._exporter = None
        self._preempted = False
        self._recovery: RecoveryManager | None = None
        self.rollbacks: list[dict] = []
        # a recovering fit's handed-in weights at its start (`_rollback_state`)
        self._handed_start = None
        # the elastic plan this fit ran on (None with resilience.elastic unset)
        self.topology_plan: TopologyPlan | None = None
        # the fit's DeviceMesh (None off a process group) and the mesh
        # FSDP2 shards over
        self.mesh = None
        self._dp_mesh = None
        self._objective = None

    def _callbacks(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            if hasattr(cb, hook):
                getattr(cb, hook)(self, *args)

    def init_state(self, objective, with_optimizer: bool = True, pretrained: bool = True):
        """The model on the device (the objective's pre-trained weights,
        random from the seed, or the objective's own) and, for training, its
        optimizer chain: the state a fresh fit starts from and a restore
        loads into (and what a state carried from the JAX package loads
        into: `models/llama/from_jax.py`). `pretrained=False` reads no
        pre-trained source (a restore is about to overwrite the weights).
        Returns (state, schedule); both optimizer and schedule are None
        without the optimizer."""
        cfg = self.config
        init = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = objective.configure_model(self.device, init, load_pretrained=pretrained)
        if self.mesh is not None:
            # every rank built the same full weights; each keeps its shards
            for member in getattr(model, "policy", None), getattr(model, "ref", None):
                if member is not None:
                    parallelize(member, self.mesh, self._dp_mesh)
            if not hasattr(model, "policy"):
                parallelize(model, self.mesh, self._dp_mesh)
        optimizer = schedule = None
        if with_optimizer and _world_size() > 1:
            if cfg.offload_optimizer_state or objective.config.optim.optimizer == "adafactor":
                raise NotImplementedError(
                    "offloaded optimizer state and Adafactor on a mesh of more than one rank "
                    "are not ported yet (ROADMAP A.9b)")
        if with_optimizer:
            optimizer, schedule = build_optimizer(
                objective.config.optim, cfg.max_steps, list(model.named_parameters()),
                frozen_modules=objective.config.frozen_modules,
                accumulate=cfg.accumulate_grad_batches,
                offload=cfg.offload_optimizer_state, state_dtype=cfg.offload_state_dtype,
                quant_block=cfg.offload_quant_block, scan_layers=_scan_layers(model),
            )
        state = TrainState(step=0, model=model, optimizer=optimizer, rng=prng.key(cfg.seed + 1))
        return state, schedule

    def restored_state(self, objective, resume_step: int | None, with_optimizer: bool = True):
        """The state a fit (or an RL loop) starts from, and the restored
        step's meta (None when nothing restored). When the checkpointer
        holds a step (or `resume_step` names one) the state is built without
        reading the objective's pre-trained source and restored; only when
        no step restores is it built afresh from that source, as JAX loads
        HF weights only when no checkpoint restored
        (`llm_training_tpu/trainer/trainer.py:934-950`). Returns (state,
        schedule, meta)."""
        built = {a: getattr(objective, a) for a in _MODEL_ATTRS if hasattr(objective, a)}
        restorable = self.checkpointer is not None and (
            resume_step is not None or bool(self.checkpointer.all_steps()))
        state, schedule = self.init_state(objective, with_optimizer, pretrained=not restorable)
        meta = self._restore(state, resume_step) if self.checkpointer is not None else None
        if meta is None and restorable:
            state, schedule = self._fresh_state(objective, state, built, with_optimizer)
        return state, schedule, meta

    def _restore(self, state: TrainState, resume_step: int | None) -> dict | None:
        try:
            meta = self.checkpointer.maybe_restore(state, resume_step)
        except Exception as e:
            # the optimizer state's layout depends on run settings, so
            # changing them across a resume cannot restore
            raise RuntimeError(
                "checkpoint restore failed — note the optimizer-state layout depends on "
                "the optimizer, offload_optimizer_state, offload_state_dtype, "
                "offload_quant_block, accumulate_grad_batches and frozen_modules; resume "
                "with the same settings the checkpoint was written with"
            ) from e
        return meta

    # ------------------------------------------------------------ topology

    def _resolve_topology(self, resume_step: int | None) -> TopologyPlan | None:
        """The elastic front door of fit: with `resilience.elastic` set, the
        planner over the visible device count (CUDA's, after the chaos
        clamp; 1 on the CPU) against the checkpoint's recorded topology and
        global batch. None when unset."""
        elastic = self.config.resilience.elastic
        if elastic is None:
            return None
        available = _world_size()
        limit = chaos_device_limit()
        if limit is not None and limit < available:
            logger.warning("chaos: shrinking visible devices %d -> %d (LLMT_CHAOS_DEVICES)",
                           available, limit)
            available = limit
        checkpoint_mesh = checkpoint_batch = None
        if self.checkpointer is not None:
            meta = self.checkpointer.read_meta(resume_step) or {}
            checkpoint_mesh = (meta.get("topology") or {}).get("mesh")
            checkpoint_batch = (meta.get("data_state") or {}).get("global_batch_size")
        plan = plan_live_world(available, self.config.mesh.axis_sizes(), checkpoint_mesh,
                               checkpoint_batch)
        logger.info("elastic topology: %s over %d device(s) [%s, from %s]",
                    plan.axis_sizes, plan.device_count, plan.decision, plan.source)
        return plan

    def _publish_topology(self, plan: TopologyPlan | None) -> None:
        """Tag this segment with its world: the goodput cost basis (chip
        count and $/chip-hour), the `elastic/*` gauges and, under a
        supervisor, a `segment_topology` event keyed by the attempt."""
        price = resolve_chip_price(self.config.resilience.elastic)
        chips, sizes = self._topology()
        self.ledger.set_cost_basis(chips, price)
        self.telemetry.gauge("elastic/segment").set(segment_attempt())
        self.telemetry.gauge("elastic/device_count").set(chips)
        self.telemetry.gauge("elastic/data_parallel_size").set(sizes["data"])
        if is_primary():
            log_segment_topology(sizes, chips,
                                 decision=plan.decision if plan is not None else "static mesh",
                                 price_per_chip_hour=price)

    def _topology(self) -> tuple[int, dict[str, int]]:
        """(devices, mesh degrees) of the live world: the one device's all
        ones off a mesh."""
        if self.mesh is None:
            return 1, single_device_mesh()
        return _world_size(), mesh_axis_sizes(self.mesh)

    def _build_mesh(self, plan: TopologyPlan | None):
        """The fit's mesh over the process group's ranks (the plan's degrees
        under elastic), or None without a group. Pipeline stages raise
        (ROADMAP A.9b). On CUDA each rank takes the card of its
        `LOCAL_RANK`."""
        config = self.config.mesh
        if plan is not None:
            config = MeshConfig.from_axis_sizes(plan.axis_sizes)
        if config.pipeline_parallel_size != 1:
            raise NotImplementedError(
                f"pipeline_parallel_size={config.pipeline_parallel_size}: pipeline stages are not "
                "ported yet (ROADMAP A.9b)")
        resolve_axis_sizes(config, _world_size())  # JAX's errors, with or without a group
        if not dist.is_initialized():
            return None
        if self.device.type == "cuda":
            self.device = torch.device("cuda", local_rank())
            torch.cuda.set_device(self.device)
        mesh = build_mesh(config, device=self.device.type)
        self._dp_mesh = batch_mesh(mesh)
        return mesh

    # ------------------------------------------------------------ fit

    def fit(self, objective, datamodule, resume_step: int | None = None) -> TrainState:
        """Train to `max_steps` optimizer steps: from the newest checkpoint
        (or `resume_step`) when the checkpointer has one, else from the
        seed. Raises `PreemptionInterrupt` after the emergency save of a
        signalled fit, and NanGuard's errors (or `RecoveryExhaustedError`
        under recovery) on divergence."""
        resil = self.config.resilience
        self.topology_plan = self._resolve_topology(resume_step)
        self.mesh = self._build_mesh(self.topology_plan)
        self._objective = objective
        # fresh telemetry per fit, installed as the process-current registry
        # so components built elsewhere (the prefetcher, the checkpointer)
        # find it
        self.telemetry = TelemetryRegistry()
        self.ledger.start()
        self._publish_topology(self.topology_plan)
        previous_registry = set_registry(self.telemetry)
        self._preempted = False
        trace_attached = False
        try:
            # fault injection first (the environment overlays the config),
            # so every other layer sees the harness
            install_chaos(config_from_env(resil.chaos), registry=self.telemetry)
            self._shutdown = GracefulShutdown().install() if resil.handle_signals else None
            self._watchdog = None
            # the run's files are rank 0's (hang dumps, hbm.jsonl), as JAX's process 0's
            run_dir = resolve_run_dir(self) if is_primary() else None
            if resil.watchdog_timeout_s:
                self._watchdog = HangWatchdog(
                    resil.watchdog_timeout_s, run_dir=run_dir, ledger=self.ledger,
                    registry=self.telemetry, action=resil.watchdog_action,
                ).start()
            # per-card memory timeline: sampled on log steps into the
            # hbm/* gauges and <run_dir>/hbm.jsonl: a logger's run directory,
            # else the checkpoint directory (JAX's `resolve_run_dir`)
            self._hbm_timeline = HBMTimeline(run_dir=run_dir, registry=self.telemetry,
                                             device=self.device)
            # SLO monitor: armed only by LLMT_SLO_* targets; breaches bump
            # slo/* counters and flight-dump the trace ring into the run dir
            self._slo = build_slo_monitor(registry=self.telemetry, run_dir=run_dir)
            # the profile trigger: SLO breaches, anomaly and rollback dumps,
            # /profilez and the `profile` command arm captures through it;
            # only this loop's poll() starts and stops torch.profiler
            self._profile_trigger = build_profile_trigger(
                registry=self.telemetry, run_dir=run_dir, cuda=self.device.type == "cuda")
            # a ProfilerCallback's window becomes a scheduled capture of the
            # trigger, and the callback goes passive: one owner of the
            # profiler, so an SLO-fired capture never nests inside it
            for cb in self.callbacks:
                window = getattr(cb, "profile_window", None)
                if callable(window):
                    start_step, num_steps, trace_dir = window()
                    self._profile_trigger.schedule(start_step, num_steps, trace_dir=trace_dir,
                                                   max_steps=self.config.max_steps)
                    cb._absorbed = True
            # /metrics (registry + ledger), /statusz, /healthz (red on a
            # stale watchdog beat), /profilez: LLMT_METRICS_PORT unset
            # disables it, a port collision degrades to a warning
            if is_primary():
                self._exporter = start_exporter(
                    registry=self.telemetry, ledger=self.ledger, watchdog=self._watchdog,
                    slo=self._slo, profile=self._profile_trigger, role="train",
                    status_fn=lambda: {"step": self.last_step, "segment": segment_attempt()},
                )
            # the trace sink: lifecycle events land in <run_dir>/trace.jsonl
            # (a logger's run directory, else the checkpoint directory, as
            # JAX's), per-step spans only with LLMT_TRACE_TRAIN=1; False when
            # another owner holds the sink
            if run_dir is not None:
                trace_attached = get_tracer().attach_sink(run_dir / "trace.jsonl")
            with use_mesh(self.mesh):
                return self._fit_inner(objective, datamodule, resume_step)
        finally:
            if self._exporter is not None:
                self._exporter.stop()
                self._exporter = None
            self._slo = None
            if self._profile_trigger is not None:
                # closes a capture left open (the fit raised mid-window) and
                # unpublishes the trigger, so the next fit starts clean
                self._profile_trigger.teardown()
                set_profile_trigger(None)
                self._profile_trigger = None
            self._hbm_timeline = None
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            if self._shutdown is not None:
                self._shutdown.uninstall()
                self._shutdown = None
            if trace_attached:
                get_tracer().detach_sink()
            uninstall_chaos()
            set_registry(previous_registry)
            # callbacks that alter process state (output tees, profiler
            # traces) restore it even when fit raises
            for cb in self.callbacks:
                if hasattr(cb, "teardown"):
                    cb.teardown()

    def _fit_inner(self, objective, datamodule, resume_step) -> TrainState:
        cfg = self.config
        acc = cfg.accumulate_grad_batches
        # lifecycle spans (compile, validation, checkpoint_save, segment
        # boundaries) always reach the sink; the per-micro-step spans only
        # with LLMT_TRACE_TRAIN=1, while the ring records them regardless
        tracer = get_tracer()
        trace_train = tracer.train_steps
        datamodule.setup()
        built = {a: getattr(objective, a) for a in _MODEL_ATTRS if hasattr(objective, a)}
        state, base_schedule, meta = self.restored_state(objective, resume_step)
        state.model.train()
        if meta is not None:
            self.counters.update(meta.get("counters", {}))
            self._load_callback_state(meta)
            if self.topology_plan is not None:
                # a restore that fell back to a step of another topology
                # must not go on as if it were the plan's
                verify_restored_topology(self.topology_plan, meta.get("topology"))
        saved_data_state = (meta or {}).get("data_state")
        self.state = state

        # rollback-and-skip recovery: the persisted skip list and cooldowns
        # come back with the checkpoint, so a resume replays the same skips
        recovery = None
        self._recovery = None
        self.rollbacks = []
        if cfg.resilience.recovery is not None:
            recovery = RecoveryManager(cfg.resilience.recovery, registry=self.telemetry,
                                       metadata=(meta or {}).get("recovery"))
            self._recovery = recovery
        # the weights of models handed in, as the fit starts: a rollback with
        # nothing committed starts over from them, as JAX re-initializes
        self._handed_start = None
        if recovery is not None and meta is None and _world_size() == 1:
            self._handed_start = {
                attr: {k: v.detach().to("cpu", copy=True)
                       for k, v in module.state_dict().items()}
                for attr, module in built.items() if module is not None}
        schedule = self._wrap_schedule(state, base_schedule)

        health_every = cfg.health.every_n_steps
        self._param_groups = None
        if health_every and _world_size() > 1:
            raise NotImplementedError(
                "health metrics on a mesh of more than one rank are not ported yet (ROADMAP A.9b)")
        if health_every:
            self._param_groups = build_param_groups(
                zip(state.optimizer.names, state.optimizer.params))

        start_micro = state.step
        micro_steps = cfg.max_steps * acc
        # chaos divergence and SIGKILL fire only in runs that started from
        # scratch, so a relaunch resuming past a checkpoint survives them
        fresh_start = start_micro == 0
        self._callbacks("on_fit_start", objective, datamodule, start_micro // acc)

        self.should_stop = False
        self.abort_final_save = False
        self.last_step = self.last_metrics = self.last_health = self.last_telemetry = None
        self.last_seq_len = None
        self._last_interval_save = None
        self._global_batch_size = None
        warmed = False

        def run_segment(state: TrainState, seg_start: int) -> TrainState:
            """One recoverable stretch of the micro-step loop, from
            `seg_start` to the end (or a guard's raise, or a stop). With
            recovery unset there is exactly one segment."""
            nonlocal warmed
            tracer.instant("train", "segment_start", micro=seg_start, step=seg_start // acc)
            skip_list = recovery.skip_list if recovery is not None else None
            batches = self.train_stream(datamodule, seg_start, skip_list)
            first_step = seg_start // acc + 1
            window_time, window_step = time.perf_counter(), seg_start // acc
            # the SLO's step-cadence anchor, reset per segment so a
            # rollback's restore never bills as one slow step
            slo_step_t: float | None = None
            try:
                for micro in range(seg_start, micro_steps):
                    if self._watchdog is not None:
                        self._watchdog.beat("train_loop", step=micro)
                    with self.ledger.measure("data_wait"), tracer.measure(
                            "train", "data_load", write=trace_train, step=micro):
                        batch, (samples, tokens) = next(batches)
                    if self._global_batch_size is None:
                        self._global_batch_size = samples
                        ids = batch.get("input_ids")
                        self.last_seq_len = int(ids.shape[1]) if ids is not None else None
                        # the (seed, step) stream is keyed to the global batch:
                        # refused under elastic, warned about otherwise
                        check_data_continuity(saved_data_state, samples,
                                              elastic=cfg.resilience.elastic is not None)
                    boundary = (micro + 1) % acc == 0
                    use_health = bool(health_every and boundary
                                      and ((micro + 1) // acc) % health_every == 0)
                    # the fit's first micro-step builds and loads the kernels
                    # and warms the allocator: the port's stand-in for compile
                    phase = "step_compute" if warmed else "compile"
                    compile_span = (contextlib.nullcontext() if warmed
                                    else tracer.measure("train", "compile"))
                    t_step = time.perf_counter()
                    with self.ledger.measure(phase), compile_span:
                        metrics = self.train_micro_step(objective, state, batch, health=use_health)
                    tracer.span("train", "train_step", t_step, time.perf_counter(),
                                write=trace_train, step=micro)
                    if not warmed:
                        self.telemetry.gauge("compile_time_s").set(time.perf_counter() - t_step)
                        warmed = True
                    self.counters["consumed_samples"] += samples
                    self.counters["consumed_tokens"] += tokens

                    if not boundary:
                        continue
                    step = (micro + 1) // acc
                    self.last_step = step
                    if self._slo is not None:
                        now_step = time.perf_counter()
                        if slo_step_t is not None:
                            self._slo.observe_step(now_step - slo_step_t, step=step)
                        slo_step_t = now_step
                    if self._profile_trigger is not None:
                        # after the SLO observe: a breach fired there arms a
                        # request, and this poll starts its capture at once
                        self._profile_trigger.poll(step)
                    health = metrics.pop("health", None)
                    # the objective's own health metrics (an MoE model's router)
                    router = {k: metrics.pop(k) for k in list(metrics) if k.startswith("health/")}
                    self.last_metrics = metrics
                    if health is not None:
                        # one host copy of the [4, groups] tensor and one of
                        # the router's; the sync drains the launch queue, so
                        # it bills to step_compute
                        with self.ledger.measure("step_compute"):
                            host_health = health.cpu().tolist()
                            self.last_health = _host_metrics(router)
                        self.last_health.update(
                            layer_health_metrics(self._param_groups, host_health))
                        for key, value in self.last_health.items():
                            self.telemetry.gauge(key).set(value)
                    self._callbacks("on_train_step", step)

                    if step % cfg.log_every_n_steps == 0 or step == cfg.max_steps:
                        # one transfer; it waits for the device's queued work,
                        # which goodput bills to step_compute
                        with self.ledger.measure("step_compute"):
                            host = _host_metrics(metrics)
                        # divergence injection poisons the host metrics the
                        # guards read; the device state stays healthy
                        chaos = get_chaos()
                        if chaos is not None:
                            chaos.maybe_poison_metrics(step, host, fresh_start=fresh_start)
                        now = time.perf_counter()
                        host["lr"] = float(schedule(step))
                        host["steps_per_sec"] = (step - window_step) / max(now - window_time, 1e-9)
                        host.update(self.counters)
                        window_time, window_step = now, step
                        host.update(self.ledger.summary())
                        if self._slo is not None:
                            # before the snapshot, so this record carries the
                            # fresh slo/* burn gauges
                            self._slo.observe_goodput(float(host["goodput/goodput_pct"]), step=step)
                        host.update(self._hbm_timeline.sample(step))
                        host.update(self.telemetry.snapshot())
                        logger.info("step %d | loss %.4f | grad_norm %.3f | %.2f steps/s | "
                                    "goodput %.1f%%", step, host["loss"], host["grad_norm"],
                                    host["steps_per_sec"], host["goodput/goodput_pct"])
                        self._callbacks("on_step_end", step, host)
                        metrics = host
                    if step == first_step:
                        # the first step's warm-up stays out of the throughput window
                        window_time, window_step = time.perf_counter(), step
                    if cfg.val_check_interval and step % cfg.val_check_interval == 0:
                        with self.ledger.measure("validation"), tracer.measure(
                                "train", "validation", step=step):
                            self._run_validation(objective, datamodule, step)
                    if (
                        self.checkpointer is not None
                        and cfg.checkpoint_every_n_steps
                        and step % cfg.checkpoint_every_n_steps == 0
                        # a guard may have flagged this step's state as diverged
                        and not self.abort_final_save
                        and self._loss_finite(metrics, step)
                    ):
                        with self.ledger.measure("checkpoint_save"), tracer.measure(
                                "train", "checkpoint_save", step=step):
                            self.checkpointer.save(step, state, counters=dict(self.counters),
                                                   extra=self._save_extra(step))
                        self._last_interval_save = step

                    # simulated failures: a real SIGTERM to this process, so
                    # the handler -> boundary check -> emergency save path
                    # below is the one exercised, or a SIGKILL, the hard
                    # death only `supervise` survives; slow steps first
                    chaos = get_chaos()
                    if chaos is not None:
                        chaos.maybe_slow_step(step)
                        chaos.maybe_sigterm(step)
                        chaos.maybe_sigkill(step, fresh_start)
                    if self._shutdown is not None and self._shutdown.should_stop(
                        step, cfg.resilience.preemption_sync_every_n_steps
                    ):
                        logger.warning("preemption (%s) at step %d: committing an emergency "
                                       "checkpoint, then exiting resumable",
                                       self._shutdown.reason, step)
                        self.telemetry.counter("resilience/preemptions").inc()
                        self._preempted = True
                        self.should_stop = True
                    if self.should_stop:
                        logger.info("stopping at step %d (callback request)", step)
                        break
                return state
            finally:
                if isinstance(batches, DevicePrefetcher):
                    batches.close()

        try:
            # the recovery driver: a NanGuard raise rolls the state back to
            # the last committed checkpoint, registers the poisoned data
            # window, optionally cools the LR, and re-enters in-process;
            # budget exhaustion raises RecoveryExhaustedError (CLI exit 76)
            while True:
                try:
                    state = run_segment(state, start_micro)
                    break
                except (NonFiniteLossError, LossSpikeError) as failure:
                    if recovery is None:
                        raise
                    plan = recovery.on_failure(failure, self.last_step or 0)
                    t0 = time.perf_counter()
                    # the traceback's frames pin the diverged step's tensors
                    traceback.clear_frames(failure.__traceback__)
                    state, start_micro, base_schedule = self._rollback_state(
                        objective, state, built, base_schedule)
                    win_start, win_len = recovery.register_skip(plan.failed_step * acc, start_micro)
                    logger.warning(
                        "recovery rollback %d/%d after %s at step %d: restored micro-step %d, "
                        "skipping data window [%d, %d), resuming in-process",
                        plan.rollback_index, recovery.config.max_rollbacks,
                        type(failure).__name__, plan.failed_step, start_micro,
                        win_start, win_start + win_len,
                    )
                    # flight recorder: the ring holds the steps that led into
                    # the divergence; dump them beside the guard's anomaly file
                    tracer.instant("resilience", "rollback", failed_step=plan.failed_step,
                                   restored_micro=start_micro,
                                   rollback_index=plan.rollback_index,
                                   failure=type(failure).__name__)
                    rollback_run_dir = resolve_run_dir(self) if is_primary() else None
                    if rollback_run_dir is not None:
                        tracer.flight_dump(rollback_run_dir, f"rollback-{plan.failed_step}")
                    if self._profile_trigger is not None:
                        # a profile of the re-entered steps under the same tag
                        self._profile_trigger.request(f"rollback-{plan.failed_step}",
                                                      source="rollback")
                    self._callbacks("on_rollback", start_micro // acc)
                    recovery.register_cooldown(start_micro // acc)
                    # the cooldown re-wraps the schedule only: the restored
                    # optimizer state drops straight in
                    schedule = self._wrap_schedule(state, base_schedule)
                    self.rollbacks.append({
                        "failed_step": plan.failed_step, "failure": type(failure).__name__,
                        "restored_micro": start_micro, "window": [win_start, win_len],
                        "seconds": time.perf_counter() - t0,
                    })
        finally:
            # the watchdog patrols the loop; the epilogue legitimately blocks
            # on the final save for as long as it takes
            if self._watchdog is not None:
                self._watchdog.stop()

        final_save_committed = False
        if (
            self.checkpointer is not None
            and self.last_step is not None
            and not self.abort_final_save
            and self._loss_finite(self.last_metrics, self.last_step)
        ):
            with self.ledger.measure("checkpoint_save"), tracer.measure(
                    "train", "checkpoint_save", step=self.last_step):
                # force: the step may collide with a stale entry of a previous
                # run of the directory (the emergency-save case); but a step
                # this fit's interval save wrote is not written twice
                if self.last_step != self._last_interval_save:
                    if self._preempted:
                        self.telemetry.counter("resilience/emergency_saves").inc()
                    self.checkpointer.save(self.last_step, state, counters=dict(self.counters),
                                           force=True, extra=self._save_extra(self.last_step))
                # the barrier: after this the newest save is durable
                self.checkpointer.wait()
                final_save_committed = True
        elif self.checkpointer is not None:
            # the final save was vetoed: an in-flight interval save still
            # becomes durable before the fit returns (or exits resumable)
            with self.ledger.measure("checkpoint_save"):
                self.checkpointer.wait()
        # one last telemetry record: the final save landed after the last
        # log step
        if self.last_step is not None:
            counts = tracer.counts()
            self.telemetry.gauge("trace/events_recorded").set(counts["recorded"])
            self.telemetry.gauge("trace/events_written").set(counts["written"])
            self.telemetry.gauge("trace/flight_dumps").set(counts["flight_dumps"])
            tracer.flush()
            self.last_telemetry = {**self.ledger.summary(), **hbm_gauges(self.device),
                                   **self.telemetry.snapshot()}
            self._callbacks("on_telemetry", self.last_step, self.last_telemetry)
        self._callbacks("on_fit_end", state)
        if self._preempted:
            reason = self._shutdown.reason if self._shutdown else "signal"
            raise PreemptionInterrupt(
                self.last_step,
                f"preempted ({reason}) at step {self.last_step}; "
                + ("emergency checkpoint committed — relaunch fit with the same config to resume"
                   if final_save_committed else
                   "NO resumable checkpoint written by this fit — a relaunch resumes from the "
                   "newest previous one, if any"),
            )
        return state

    def _wrap_schedule(self, state: TrainState, base_schedule):
        """The schedule of this fit: the base one, re-wrapped by the
        recovery's LR cooldowns when it has any (the optimizer reads it at
        its count; the log steps' `lr` too)."""
        transform = self._recovery.schedule_transform() if self._recovery is not None else None
        schedule = transform(base_schedule) if transform is not None else base_schedule
        state.optimizer.schedule = schedule
        return schedule

    def _rollback_state(self, objective, state: TrainState, built: dict, base_schedule):
        """Rewind to the last committed checkpoint (counters and callback
        state included: replayed steps must not count twice), loaded in
        place into the diverged state's own tensors, so no second copy is
        ever allocated. With nothing committed, the diverged state is freed
        first and a fresh one built from the seed, as JAX re-initializes, a
        model handed in reloaded with the weights it had when the fit
        started (kept on the host for a recovering fit on one rank; on a
        mesh it escalates). Returns (state, micro-step to resume from, base
        schedule)."""
        if self.checkpointer is not None:
            with self.ledger.measure("checkpoint_save"):
                self.checkpointer.wait()
            meta = self.checkpointer.maybe_restore(state)
            if meta is not None:
                self.counters = {"consumed_samples": 0, "consumed_tokens": 0}
                self.counters.update(meta.get("counters", {}))
                self._load_callback_state(meta)
                return state, state.step, base_schedule
        handed = sorted(a for a, module in built.items() if module is not None)
        if handed and self._handed_start is not None:
            with torch.no_grad():
                for attr in handed:
                    built[attr].load_state_dict(self._handed_start[attr])
        elif handed:
            raise RecoveryExhaustedError(
                f"recovery: no committed checkpoint to roll back to, and the objective's "
                f"{handed} were handed in, so no fresh init reproduces the fit's start; "
                "give the trainer a checkpointer"
            )
        logger.warning("recovery: no committed checkpoint to roll back to — "
                       "re-initializing from step 0")
        self.counters = {"consumed_samples": 0, "consumed_tokens": 0}
        fresh, base_schedule = self._fresh_state(objective, state, built)
        fresh.model.train()
        self.state = fresh
        return fresh, 0, base_schedule

    def _fresh_state(self, objective, state: TrainState, built: dict, with_optimizer: bool = True):
        """Free `state`, point the objective back at the models it was given
        (`built`), and build the state a fresh fit starts from, pre-trained
        weights included."""
        state.model = state.optimizer = None
        self.state = None
        for attr, module in built.items():
            setattr(objective, attr, module)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.init_state(objective, with_optimizer=with_optimizer)

    def train_stream(self, datamodule, start_micro: int, skip_list=None):
        """The fit's batches from micro-step `start_micro` as `(batch,
        (samples, tokens))` pairs: a `DevicePrefetcher` (close it) with
        `prefetch_batches` > 0, else host batches placed as they are taken.
        The stream is a pure function of (seed, micro-step), and of the
        recovery's skip list when one is given (then passed to the
        datamodule's `train_batches`): a resume continues it where the
        checkpoint stopped."""
        cfg = self.config

        def stream(from_micro: int):
            if skip_list is not None:
                batches = datamodule.train_batches(start_step=from_micro, skip_list=skip_list)
            else:
                batches = datamodule.train_batches(start_step=from_micro)
            return batches if self.mesh is None else map(self._rank_batch, batches)

        if cfg.prefetch_batches > 0:
            if self.device.type == "cpu":
                # pins MKL's thread count: with its dynamic threads on, a
                # product that overlaps the worker's production runs on fewer
                # threads and rounds otherwise, so a step's loss would depend
                # on the worker's timing
                torch.set_num_threads(torch.get_num_threads())
            watchdog = self._watchdog
            return DevicePrefetcher(
                lambda produced: stream(start_micro + produced),
                self.device, depth=cfg.prefetch_batches, host_aux_fn=_host_counts,
                registry=self.telemetry, retries=cfg.resilience.data_retries,
                retry_backoff_s=cfg.resilience.data_retry_backoff_s,
                heartbeat=(lambda: watchdog.beat("prefetcher")) if watchdog else None,
            )
        return ((to_device(b, self.device), _host_counts(b)) for b in stream(start_micro))

    def _rank_batch(self, batch: dict) -> _HostBatch:
        """This rank's part of a global host batch (`parallel/batch.py`):
        explicit global positions, a CLM's labels shifted on the global
        batch when the sequence is sharded, then the rows and the chunk."""
        counts = _batch_counts(batch)
        key = "input_ids" if "input_ids" in batch else "chosen_input_ids"
        rows, seq = batch[key].shape[:2]
        shard = batching.plan_shard(self.mesh, rows, seq)
        if self.mesh[SEQUENCE_AXIS].size() > 1:
            labels = getattr(self._objective, "global_labels", None)
            if key != "input_ids" or labels is None:
                raise NotImplementedError(
                    f"{type(self._objective).__name__} over a sequence-sharded mesh is not "
                    "ported yet (ROADMAP A.9b)")
            batch = batching.with_global_positions(batch)
            batch = {**batch, "shifted_labels": labels(batch).numpy()}
        out = _HostBatch(batching.shard_batch(batch, shard))
        out.counts = counts
        return out

    def _with_shard(self, batch: dict) -> dict:
        """A rank's device batch with the global shard it is
        (`ShardedBatch`), or the batch itself off a mesh."""
        if self.mesh is None:
            return batch
        key = "input_ids" if "input_ids" in batch else "chosen_input_ids"
        rows, width = batch[key].shape[:2]
        sp = self.mesh[SEQUENCE_AXIS].size() if key == "input_ids" else 1
        shard = batching.plan_shard(self.mesh, rows * batching.batch_ways(self.mesh), width * sp)
        return batching.ShardedBatch(batch, shard)

    def _global_metrics(self, metrics: dict) -> dict:
        """The step's metrics of the global batch on every rank: each tensor
        averaged over the batch's ranks. An objective's metric is a mean
        over its rows or already the global batch's (its loss, its token
        counts summed through `batch_sum`), which the average keeps."""
        if self.mesh is None:
            return metrics
        group = batching.batch_group(self.mesh)
        size = dist.get_world_size(group)
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        if size == 1 or not keys:
            return metrics
        values = torch.stack([metrics[k].detach().reshape(()).to(torch.float64) for k in keys])
        dist.all_reduce(values, group=group)
        return {**metrics, **dict(zip(keys, values / size))}

    def train_micro_step(self, objective, state: TrainState, batch, health: bool = False) -> dict:
        """One train-step call (`_make_step` in JAX): forward and backward on
        one micro-batch (host arrays, or tensors already on the device), the
        gradients' global norm, and the optimizer chain (which updates the
        parameters on every k-th call). Returns the micro-batch's metrics,
        on the device. With `health` (a boundary micro-step) the metrics
        also hold `health`, the [4, groups] tensor of
        `telemetry.health.layer_health_tensor`: the parameters' norms before
        the update, the gradients' before the clip, and the update's,
        collected inside the optimizer; nothing the step computes changes."""
        optimizer = state.optimizer
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        batch = self._with_shard(to_device(batch, self.device))
        # micro-step n's key, as JAX's fold_in(state.rng, state.step)
        step_rng = prng.fold_in(state.rng, state.step)
        extra = {"with_health": True} if health and _objective_supports_health(objective) else {}
        loss, metrics = objective.loss_and_metrics(batch, rng=step_rng, train=True, **extra)
        # on a mesh the loss is the global batch's and this rank's backward
        # its rows' share; FSDP2 averages over its mesh, so the share is
        # scaled by that mesh's size to sum instead
        scale = 1 if self._dp_mesh is None else self._dp_mesh.size()
        (loss * scale if scale != 1 else loss).backward()
        # over the gradients there are: a parameter that requires none (DPO's
        # reference) adds the zero that JAX's stop_gradient gives it
        metrics["grad_norm"] = global_norm([p.grad for p in params if p.grad is not None])
        metrics = self._global_metrics(metrics)
        if health:
            if self._param_groups is None:
                self._param_groups = build_param_groups(zip(optimizer.names, optimizer.params))
            p_sq = [sq_norm(p.detach(), self.device) for p in optimizer.local]
            g_sq = [sq_norm(None if p.grad is None else local_tensor(p.grad), self.device)
                    for p in optimizer.params]
            optimizer.update_sq = {}
        try:
            optimizer.update()
            if health:
                zero = torch.zeros((), dtype=torch.float32, device=self.device)
                u_sq = [sum(optimizer.update_sq.get(i, ()), zero)
                        for i in range(len(optimizer.params))]
                metrics["health"] = layer_health_tensor(self._param_groups, p_sq, g_sq, u_sq)
        finally:
            optimizer.update_sq = None
        state.step += 1
        return metrics

    @torch.no_grad()
    def _val_loss(self, objective, datamodule, limit: int | None) -> float | None:
        """The validation batches' losses averaged by their target tokens;
        None when there are none."""
        losses, weights = [], []
        for i, host_batch in enumerate(datamodule.val_batches()):
            if limit and i >= limit:
                break
            if self._watchdog is not None:
                # a validation epoch can outlast the no-progress timeout;
                # each batch is progress
                self._watchdog.beat("train_loop")
            if self.mesh is not None:
                host_batch = self._rank_batch(host_batch)
            batch = self._with_shard(to_device(host_batch, self.device))
            _, metrics = objective.loss_and_metrics(batch, train=False)
            metrics = self._global_metrics(metrics)
            losses.append(float(metrics["loss"]))
            weights.append(float(metrics["target_tokens"]))
        if not losses:
            return None
        return float(np.average(losses, weights=weights))

    def _run_validation(self, objective, datamodule, step: int) -> float | None:
        val_loss = self._val_loss(objective, datamodule, self.config.limit_val_batches)
        if val_loss is None:
            return None
        logger.info("step %d | val_loss %.4f", step, val_loss)
        self._callbacks("on_validation_end", step, {"val_loss": val_loss})
        return val_loss

    @staticmethod
    def _loss_finite(metrics, step) -> bool:
        """True when this step's loss can be persisted. Syncs with the
        device, so it runs on checkpoint steps only: a diverged state never
        becomes the newest checkpoint."""
        if metrics is None or "loss" not in metrics:
            return True
        loss = float(metrics["loss"])
        if np.isfinite(loss):
            return True
        logger.warning("skipping checkpoint at step %d: non-finite loss %s", step, loss)
        return False

    def _save_extra(self, step: int) -> dict:
        """JSON riders of a checkpoint: the recovery's skip list and
        cooldowns (a resume replays the same skips), the topology (what an
        elastic relaunch plans against: one device, every axis 1), the
        data-stream cursor (samples drawn so far and the global batch it is
        keyed to) and every callback's `state_dict` (NanGuard's trackers)."""
        extra: dict = {}
        if self._recovery is not None:
            extra["recovery"] = self._recovery.metadata()
        chips, sizes = self._topology()
        extra["topology"] = {"device_count": chips, "mesh": sizes}
        if self._global_batch_size:
            micro = step * self.config.accumulate_grad_batches
            extra["data_state"] = {
                "global_batch_size": self._global_batch_size,
                "sample_cursor": micro * self._global_batch_size,
                # one process serves the whole global batch
                "replica_stride": self._global_batch_size,
            }
        cb_state: dict = {}
        for cb in self.callbacks:
            fn = getattr(cb, "state_dict", None)
            if callable(fn):
                try:
                    cb_state[type(cb).__name__] = fn()
                except Exception:
                    logger.exception("callback %s state_dict failed (not persisted)",
                                     type(cb).__name__)
        if cb_state:
            extra["callbacks"] = cb_state
        return extra

    def _load_callback_state(self, meta: dict | None) -> None:
        """Callback state from checkpoint metadata, by class name; absent
        entries and failures leave the callback as constructed."""
        states = (meta or {}).get("callbacks") or {}
        for cb in self.callbacks:
            data = states.get(type(cb).__name__)
            if data is not None and hasattr(cb, "load_state_dict"):
                try:
                    cb.load_state_dict(data)
                except Exception:
                    logger.exception("callback %s load_state_dict failed (starting fresh)",
                                     type(cb).__name__)

    # ------------------------------------------------------------ validate

    def restore_for_inference(self, objective, resume_step: int | None = None) -> TrainState:
        """Read-only restore for `validate`, `generate`, `evaluate` and
        `serve`: builds the objective's model on the device and loads the
        newest (or given) step's parameters, step and key into it. Never
        deletes, prunes or rewrites anything in the directory; raises when
        it holds no step."""
        if self.checkpointer is None:
            raise ValueError("restore_for_inference requires a checkpointer")
        state, _ = self.init_state(objective, with_optimizer=False, pretrained=False)
        # an observation must not delete steps from the directory
        if self.checkpointer.maybe_restore(state, resume_step, repair=False) is None:
            raise ValueError(f"no checkpoint found in {self.checkpointer.directory}")
        state.model.eval()
        self.state = state
        return state

    def validate_from_checkpoint(
        self, objective, datamodule, resume_step: int | None = None
    ) -> dict[str, float]:
        """Restore the newest (or given) checkpoint and run validation over
        `limit_val_batches` batches (the `validate` command)."""
        datamodule.setup()
        self.restore_for_inference(objective, resume_step)
        val_loss = self._val_loss(objective, datamodule, self.config.limit_val_batches)
        if val_loss is None:
            raise ValueError("datamodule produced no validation batches")
        result = {"val_loss": val_loss}
        logger.info("validate: %s", result)
        return result

    def validate(self, objective, datamodule, state: TrainState) -> dict[str, float]:
        """Validation of `state`'s model over every validation batch."""
        datamodule.setup()
        objective.bind(state.model)
        val_loss = self._val_loss(objective, datamodule, None)
        if val_loss is None:
            raise ValueError(
                "datamodule produced no validation batches "
                "(set validation_split or provide a val dataset)"
            )
        return {"val_loss": val_loss}
