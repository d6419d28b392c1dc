"""Console entry: `python -m llm_training_tpu_torch {fit,validate,generate,
evaluate,serve,rl-fit,supervise,ckpt,watch,profile,trace,report,fleet,route}`.

`fit --config file.json [--ckpt-path STEP] [key.path=value ...]` trains:
the counterpart of the JAX `fit` command on a JSON config with the YAML
examples' node layout (`trainer` / `model` / `data`, components as
`class_path` + `init_args`). The `trainer` node's `loggers` and
`callbacks` lists are components too, and its `checkpoint` node builds the
`Checkpointer`: `fit` then resumes from the newest step (or `--ckpt-path`),
saves every `checkpoint_every_n_steps` and at the end. Its `health` and
`resilience` nodes are JAX's, and so is its `mesh` node (`MeshConfig`):
`python -m torch.distributed.run --nproc-per-node N -m
llm_training_tpu_torch fit --config ...` runs the fit over N ranks (NCCL,
one card each by `LOCAL_RANK`; gloo with `--device cpu`), sharded as the
mesh says; rank 0 writes the run's files. `validate`, `generate`,
`evaluate` and `serve --config` restore a mesh fit's checkpoint onto one
process (DCP reshards it).
`fit` exits as JAX's does: 75 after a preemption's emergency save (relaunch
the same command to resume), 76 when in-process recovery gave up, 77 on a
loss spike and 78 on a non-finite loss that NanGuard raised.

`validate`, `generate` and `evaluate` restore the run's checkpoint
read-only (`Trainer.restore_for_inference`) and print the JAX commands'
records: `validate` logs (and prints) `{"val_loss"}`; `generate` prints
one JSON object per prompt (`prompt`, `tokens`, `sequence`, `n_tokens`,
`stop_reason`, `logprobs` with `--logprobs`), then `{"stats": ...}` with
the `decode/*` keys; `evaluate` prints the `eval/*` result.

`serve` is the counterpart of `_run_serve` in `llm_training_tpu/cli/main.py`:
a continuous-batching server over a JSONL stdin/stdout protocol. One request
per input line (`{"id", "prompt": [ids], "max_new_tokens"?, "priority"?,
"deadline_ms"?}`; a request past its deadline ends with `stop_reason`
`deadline`);
the engine streams `{"type": "token"}` chunks and one `{"type": "done"}`
per request as they land, admitting new requests between decode steps. A
malformed line answers a `{"type": "error"}` chunk and the server keeps
running. With `--config`, a `{"type": "reload", "ckpt_path"?}` control
line restores the newest (or the named) checkpoint and hot-swaps it into
the engine between steps, answering `{"type": "weights", "generation",
"ckpt_path"}`; a failed reload answers an error chunk and the current
weights keep serving. A `{"type": "profile", "tag"?}` line arms a
`torch.profiler` capture over the next engine steps and is answered with
`{"type": "profile", "accepted", "reason", "tag"}`. stdin EOF drains the
queue, then a final `{"type": "stats"}` record is printed (and, with a run
dir, merged into its `telemetry.jsonl`).

`serve`'s resilience is JAX's: `--max-queue` and `--shed-ttft-ms` shed
queued requests with `stop_reason` `overloaded`; SIGTERM stops intake,
finishes what `--drain-timeout-s` allows, evicts and journals the rest into
the run dir's `serve-journal.jsonl` and exits 75, and the relaunch replays
the journal before it reads stdin; `--watchdog-timeout-s` aborts a wedged
engine step after a hang dump and a flight dump of the trace ring. Sampled
request spans go to the run dir's `trace.jsonl`; `LLMT_SLO_*` arms the SLO
monitor and `LLMT_METRICS_PORT` the `/metrics`, `/statusz`, `/healthz` and
`/profilez` exporter.

The model is the run's (`--config`, restored from its checkpoint, newest
or `--ckpt-path`, into a model whose parameters are in the run's compute
dtype), a named preset (`--preset llama-3.1-8b`) or a JSON config file
(`--model-config`); a preset's or file's weights come from a `.npz` of the
JAX parameter tree (`--weights`, keys joined by '/') or are drawn from
`--seed`.

`rl-fit --config file.json` is the counterpart of `_run_rl_fit`: on-policy
GRPO over the serving engine (`rl/loop.py`). Each round samples
`--prompts-per-round` x `group_size` rollouts through the engine, scores
them, updates the policy and syncs it into the engine; it prints one
`{"type": "rl_round"}` record a round and a final `{"type": "stats"}`
record, and logs to stdout as JAX's does. With a JSONL logger the run
directory holds the rollout journal (`rl-journal.jsonl`): SIGTERM drains
the rollouts in flight into it, checkpoints the round cursor and exits 75;
the relaunch replays and adopts them.

`supervise --config file.json` runs `fit` (or, with `--child serve`,
`serve`) as a child process and relaunches it on exit 75 and on hard deaths (SIGKILL, segfault, the
watchdog's SIGABRT) with JAX's flags, budget and backoff, logging every
lifecycle event to `supervisor.jsonl` (the config's run directory by
default); it never initializes CUDA. Flags for the child (`--device cpu`)
ride in `--child-args`. `ckpt {verify,ls,gc,mirror} DIR` checks, lists,
prunes and mirrors a checkpoint root by its integrity manifests: exit 0
clean, 1 findings, 2 unusable. `trace SOURCE` exports a run dir's
`trace.jsonl` (or a flight dump) as Chrome-trace JSON (exit 2 when absent
or empty); `watch` polls a live run's `/statusz` (`--once` exits 2 when it
is unreachable); `profile` arms a capture through `/profilez`.

`report RUN_DIR` renders a run's summary (`--format json` for one
machine-readable object); `fleet` sweeps the exporters' discovery cards
(`LLMT_FLEET_DIR`) or `--targets` into rollups and a health verdict
(`--once` exits 2 when it finds no replica); `route --config file.json
--replicas N [-- serve flags]` puts N `serve --config` children behind one
stdin/stdout endpoint with failover replay, hedging and SLO-driven
scaling. These three, `supervise`, `watch`, `profile`, `trace` and `ckpt`
are control planes: they never initialise CUDA.

Every command runs on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import random
import shlex
import sys
import threading
import time
from pathlib import Path
from typing import TextIO

import numpy as np
import torch

from llm_training_tpu_torch import resolve_device
from llm_training_tpu_torch.callbacks.nan_guard import LossSpikeError, NonFiniteLossError
from llm_training_tpu_torch.cli.config import instantiate_from_config, load_config
from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.infer.engine import GenerateConfig, InferenceEngine
from llm_training_tpu_torch.infer.evaluate import run_evaluation
from llm_training_tpu_torch.infer.sampling import SamplingConfig
from llm_training_tpu_torch.lms.clm import CLM
from llm_training_tpu_torch.lms.grpo import GRPO
from llm_training_tpu_torch.models.llama.config import PRESETS, LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax, tree_from_flat
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.parallel.mesh import initialize_distributed
from llm_training_tpu_torch.resilience import (
    LOSS_SPIKE_EXIT_CODE,
    NON_FINITE_EXIT_CODE,
    RECOVERY_EXHAUSTED_EXIT_CODE,
    RESUMABLE_EXIT_CODE,
    GracefulShutdown,
    HangWatchdog,
    PreemptionInterrupt,
    RecoveryExhaustedError,
)
from llm_training_tpu_torch.resilience.chaos import config_from_env, install_chaos, uninstall_chaos
from llm_training_tpu_torch.resilience.durability import ckpt_main
from llm_training_tpu_torch.resilience.supervisor import (
    Supervisor,
    SupervisorConfig,
    build_fit_argv,
    build_serve_argv,
)
from llm_training_tpu_torch.rl.loop import RLLoop, RLLoopOptions
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.serve.journal import RequestJournal, replay_journal
from llm_training_tpu_torch.serve.paged_cache import DEFAULT_BLOCK_SIZE
from llm_training_tpu_torch.serve.router import route_main
from llm_training_tpu_torch.telemetry.exporter import profile_main, start_exporter, watch_main
from llm_training_tpu_torch.telemetry.fleet import fleet_main
from llm_training_tpu_torch.telemetry.profiling import build_profile_trigger, set_profile_trigger
from llm_training_tpu_torch.telemetry.registry import get_registry
from llm_training_tpu_torch.telemetry.report import report_main
from llm_training_tpu_torch.telemetry.slo import build_slo_monitor
from llm_training_tpu_torch.telemetry.trace import get_tracer, trace_main
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig


def _load(args, log_stream: TextIO | None = None) -> dict:
    """The command's config (overrides applied), with logging (to stdout,
    or `log_stream`) and the global seeds set from it."""
    config = load_config(args.config, args.overrides)
    logging.basicConfig(
        level=getattr(logging, str(config.get("logging_level", "INFO")).upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=log_stream or sys.stdout,
    )
    seed = int(config.get("seed_everything", 42))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return config


def _resume_step(args) -> int | None:
    return int(args.ckpt_path) if args.ckpt_path else None


def _require_single_model_objective(objective, command: str) -> None:
    """generate/evaluate/serve drive ONE causal LM over CLM-keyed batches;
    a preference objective (DPO's policy and reference, ORPO's chosen_ and
    rejected_ batch keys) fails up front with the JAX command's message."""
    if not isinstance(objective, CLM):
        raise SystemExit(
            f"{command} supports the CLM objective only; the config's model "
            f"node builds {type(objective).__name__} — point {command} at a "
            "config whose model node is llm_training_tpu.lms.CLM wrapping "
            "the (policy) model"
        )


def _restored(config: dict, args, command: str, serving: bool = False):
    """(trainer, objective, datamodule, state) of a config's run, its
    checkpoint restored read-only; a `serving` model holds its parameters
    in its compute dtype."""
    trainer, objective, datamodule = build_fit(config, args.device)
    _require_single_model_objective(objective, command)
    if serving:
        provider = objective.config.model
        compute = provider.model_config().compute_dtype
        provider.model_kwargs = {**provider.model_kwargs, "param_dtype": compute}
    state = trainer.restore_for_inference(objective, _resume_step(args))
    return trainer, objective, datamodule, state


def build_model(args) -> Llama:
    """The serving model of `args` on its device: the run's restored
    weights (`--config`), or a preset's or file's carried or random ones."""
    return _serving_model(args)[0]


def _serving_model(args) -> tuple[Llama, Trainer | None, object | None, dict | None]:
    """`build_model`'s model, and for `--config` the run's trainer,
    objective (what a reload restores through) and loaded config."""
    if getattr(args, "config", None) is not None:
        if args.preset or args.model_config or args.weights:
            raise SystemExit("--config serves the run's checkpoint; it excludes "
                             "--preset / --model-config / --weights")
        # the JSONL protocol owns stdout: log records go to stderr
        config = _load(args, log_stream=sys.stderr)
        trainer, objective, _, state = _restored(config, args, "serve", serving=True)
        return state.model, trainer, objective, config
    if getattr(args, "ckpt_path", None) or getattr(args, "overrides", None):
        raise SystemExit("--ckpt-path and config overrides need --config")
    device = resolve_device(args.device)
    if (args.preset is None) == (args.model_config is None):
        raise SystemExit("give exactly one of --config / --preset / --model-config")
    config = (
        preset(args.preset) if args.preset is not None
        else LlamaConfig.from_json(args.model_config)
    )
    model = Llama(config, device=device)
    if args.weights is not None:
        with np.load(args.weights) as flat:
            state = state_dict_from_jax(tree_from_flat(flat), config)
        model.load_state_dict(state)
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
        model.init_weights(generator)
    return model.eval(), None, None, None


def _scalar_eos(config: LlamaConfig) -> int | None:
    eos = config.eos_token_id
    if isinstance(eos, list):
        return eos[0] if len(eos) == 1 else None
    return eos


def run_serve(args, stdin: TextIO = sys.stdin, stdout: TextIO = sys.stdout) -> int:
    """`serve`, in the order of JAX's `_run_serve`: the engine; the trace
    sink in the run dir; env chaos; the SIGTERM handler; the watchdog; the
    SLO monitor, the profile trigger and the exporter; the journal's
    rotation and its replay before any stdin line; then the loop. SIGTERM
    drains for up to `--drain-timeout-s`, evicts and journals the rest and
    exits 75. A `--preset` or `--model-config` server has no run dir: it
    traces into the ring only and keeps no journal."""
    model, trainer, objective, config = _serving_model(args)
    device = model.model.embed_tokens.weight.device
    serve_config = ServeConfig(
        max_batch=args.max_batch,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk,
        max_queue=args.max_queue,
        shed_ttft_ms=args.shed_ttft_ms,
        cache_dtype=args.cache_dtype,
        seed=args.seed,
        eos_token_id=(
            args.eos_token_id if args.eos_token_id is not None
            else _scalar_eos(model.config)
        ),
        sampling=SamplingConfig(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
        ),
    )
    engine = ServingEngine(model, serve_config, device=device)
    log = logging.getLogger(__name__)

    # sampled request spans land in the run dir's trace.jsonl for `trace`
    run_dir = _jsonl_run_dir(config) if config is not None else None
    tracer = get_tracer()
    trace_attached = run_dir is not None and tracer.attach_sink(run_dir / "trace.jsonl")
    # serve chaos is env-only (LLMT_CHAOS_SERVE_*): serve has no
    # trainer.resilience node to carry a config
    chaos = install_chaos(config_from_env())
    shutdown = GracefulShutdown().install()
    watchdog = None
    if args.watchdog_timeout_s:
        watchdog = HangWatchdog(
            args.watchdog_timeout_s, run_dir=run_dir, action="abort",
            primary_source="engine_step",
        ).start()
    registry = get_registry()
    slo = build_slo_monitor(registry=registry, run_dir=run_dir)
    profile_trigger = build_profile_trigger(
        registry=registry, run_dir=run_dir, cuda=device.type == "cuda")
    exporter = start_exporter(
        registry=registry, watchdog=watchdog, slo=slo, profile=profile_trigger,
        role="serve", extra_fn=engine.live_stats,
        status_fn=lambda: {
            "engine step": engine.step_index,
            "queue depth": len(engine.scheduler.waiting),
            "running": len(engine.scheduler.running),
            "completed": len(engine.scheduler.completed),
        },
    )

    # the request journal: the previous one is rotated into a backup that
    # lives until every entry is accepted again into the fresh journal, so
    # a death anywhere in the replay window still replays on the next start
    journal_path = run_dir / "serve-journal.jsonl" if run_dir is not None else None
    backup_path = None
    resumed = []
    if journal_path is not None:
        backup_path = journal_path.with_name("serve-journal.replaying.jsonl")
        if journal_path.exists():
            with open(backup_path, "a") as backup:
                backup.write(journal_path.read_text())
            journal_path.unlink()
        if backup_path.exists():
            resumed = replay_journal(backup_path)
        engine.attach_journal(RequestJournal(journal_path), every=args.journal_every)

    # a reader thread feeds parsed stdin lines into a queue, so intake never
    # blocks the decode loop: a request arriving mid-decode joins at the
    # next step
    lines: queue.Queue = queue.Queue()
    eof = object()

    def parse_line(line: str):
        """One raw line -> (record, error), or None for a blank line."""
        line = line.strip()
        if not line:
            return None
        try:
            record = json.loads(line)
            if not isinstance(record, dict):
                raise ValueError("request line must be a JSON object")
            return record, None
        except ValueError as e:  # JSONDecodeError is a ValueError
            return None, f"bad request line: {e}"

    def journal_delivery(record: dict) -> None:
        """Journal a well-formed request the moment it is READ: a hard death
        between read and submit must not lose it."""
        if engine.journal is None or record.get("type"):
            return
        try:
            engine.journal.delivered(
                id=record["id"], prompt=record["prompt"],
                max_new_tokens=record.get("max_new_tokens", args.max_new_tokens),
                priority=record.get("priority", 0),
                deadline_ms=record.get("deadline_ms"),
            )
        except (KeyError, TypeError, ValueError):
            pass

    def read_stdin():
        for line in stdin:
            item = parse_line(line)
            if item is None:
                continue
            if item[0] is not None:
                journal_delivery(item[0])
            lines.put(item)
        lines.put(eof)

    threading.Thread(target=read_stdin, daemon=True).start()
    # the chaos malformed flood: garbage on the intake path costs error
    # chunks, never the batch
    if chaos is not None:
        for bad in chaos.serve_malformed_lines():
            lines.put(parse_line(bad))

    def emit(events):
        for event in events:
            stdout.write(json.dumps(event) + "\n")
            if slo is not None and event.get("type") == "done":
                # every terminal feeds the SLO windows; anything but a full
                # completion burns the error-rate budget
                slo.observe_request(
                    ttft_ms=event.get("ttft_ms"), tpot_ms=event.get("tpot_ms"),
                    ok=event.get("stop_reason") in ("eos", "max_tokens"),
                )
        stdout.flush()

    def reload_from_checkpoint(request: dict) -> None:
        """{"type": "reload", "ckpt_path"?}: restore the newest (or the
        named) checkpoint into a new model and hot-swap it between steps.
        A failed reload answers an error chunk; the current weights keep
        serving."""
        step = request.get("ckpt_path")
        serving = objective.model if objective is not None else None
        try:
            if trainer is None:
                raise ValueError("reload restores the run's checkpoint: serve --config")
            # restore into a new model, so a restore that fails midway leaves
            # the served weights as they were
            objective.model = None
            new_state = trainer.restore_for_inference(
                objective, int(step) if step is not None else None)
            generation = engine.reload_weights(new_state.model.state_dict(keep_vars=True))
        except Exception as e:  # the server keeps serving
            log.exception("reload failed")
            if objective is not None:
                objective.model = serving
            emit([{"type": "error", "error": f"reload failed: {e}"}])
            return
        finally:
            if watchdog is not None:
                # the restore is legitimate host work between steps
                watchdog.beat()
        emit([{"type": "weights", "generation": generation, "ckpt_path": step}])

    def ingest(item) -> bool:
        """One parsed stdin item -> submit (or a control line), or an error
        chunk; False at EOF."""
        if item is eof:
            return False
        record, error = item
        if error is None and record.get("type") == "profile":
            # {"type": "profile", "tag"?}: arm a capture over the next engine
            # steps; the answer says whether the trigger accepted it
            tag = str(record.get("tag") or f"serve-{engine.step_index}")
            emit([{"type": "profile", **profile_trigger.request(tag, source="serve")}])
            return True
        if error is None and record.get("type") == "reload":
            reload_from_checkpoint(record)
            return True
        if error is None:
            try:
                deadline_ms = record.get("deadline_ms")
                emit(engine.submit(
                    id=record["id"], prompt=record["prompt"],
                    max_new_tokens=int(record.get("max_new_tokens", args.max_new_tokens)),
                    priority=int(record.get("priority", 0)),
                    deadline_ms=float(deadline_ms) if deadline_ms is not None else None,
                ))
                return True
            except (KeyError, TypeError, ValueError) as e:
                error = f"bad request line: {e}"
        emit([{"type": "error", "error": error}])
        return True

    open_stdin = True

    def flush_delivered() -> None:
        """Submit everything the reader already pulled off stdin: those are
        delivered requests and must reach the engine (and the journal)."""
        nonlocal open_stdin
        try:
            while open_stdin:
                open_stdin = ingest(lines.get_nowait()) and open_stdin
        except queue.Empty:
            pass

    def step() -> None:
        emit(engine.step())
        profile_trigger.poll(engine.step_index)
        if watchdog is not None:
            watchdog.beat(step=engine.step_index)

    # the journal's replay precedes any stdin line: its clients are oldest
    if resumed:
        log.warning("replaying %d journaled request(s) from the previous serve process",
                    len(resumed))
        for entry in resumed:
            emit(engine.submit_resumed(entry))
    if backup_path is not None and backup_path.exists():
        backup_path.unlink()

    rc = 0
    try:
        while open_stdin or not engine.scheduler.idle:
            if shutdown.requested:
                break
            if engine.scheduler.idle:
                if watchdog is not None:
                    # a quiet server is healthy: the beat moves under traffic
                    watchdog.beat()
                try:  # nothing in flight: wait, but stay SIGTERM-responsive
                    open_stdin = ingest(lines.get(timeout=0.2))
                except queue.Empty:
                    pass
                continue
            flush_delivered()  # in flight: take whatever arrived
            step()
        if shutdown.requested:
            # stop taking new stdin, finish what the budget allows, journal
            # the rest and exit resumable, so `supervise --child serve`
            # relaunches into a replay
            log.warning("%s: draining in-flight requests for up to %.1fs, then journaling "
                        "the remainder and exiting %d", shutdown.reason,
                        args.drain_timeout_s, RESUMABLE_EXIT_CODE)
            deadline = time.monotonic() + args.drain_timeout_s
            while True:
                flush_delivered()
                if engine.scheduler.idle or time.monotonic() >= deadline:
                    break
                step()
            time.sleep(0.05)  # let a line the reader is mid-way through land
            flush_delivered()
            engine.drain()
            rc = RESUMABLE_EXIT_CODE

        stats = engine.stats()
        profile_trigger.teardown()
        emit([{"type": "stats", "stats": stats}])
        if config is not None:
            _publish_run_telemetry(config, stats)
        if engine.journal is not None and rc == 0:
            # a clean end: every accepted request got its terminal. On the
            # drain path the journal stays open until exit, so a last line
            # the reader pulls still lands in it
            engine.journal.close()
            journal_path.unlink(missing_ok=True)
        return rc
    finally:
        set_profile_trigger(None)
        if watchdog is not None:
            watchdog.stop()
        if trace_attached:
            tracer.detach_sink()
        if exporter is not None:
            # last: a scrape may follow the final terminal
            exporter.stop()
        uninstall_chaos()
        shutdown.uninstall()


def _publish_run_telemetry(config: dict, gauges: dict) -> None:
    """Merge `gauges` into the run dir's newest `telemetry.jsonl` record
    (same step, keys overlaid), as JAX's does; a no-op without a run dir."""
    run_dir = _jsonl_run_dir(config)
    if run_dir is None or not gauges:
        return
    path = run_dir / "telemetry.jsonl"
    last: dict = {}
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                last = json.loads(line) if line.strip() else last
            except json.JSONDecodeError:
                continue  # a torn tail from a killed run
    run_dir.mkdir(parents=True, exist_ok=True)
    record = {**last, **{k: float(v) for k, v in gauges.items()}}
    record.setdefault("step", 0)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    logging.getLogger(__name__).info("telemetry merged into %s", path)


def build_fit(config: dict, device: str | None) -> tuple[Trainer, object, object]:
    """(trainer, objective, datamodule) of a loaded config; the trainer's
    `checkpoint` node gives it a `Checkpointer`."""
    trainer_node = dict(config.get("trainer", {}))
    checkpoint_node = trainer_node.pop("checkpoint", None)
    components = trainer_node.pop("callbacks", []) + trainer_node.pop("loggers", [])
    checkpointer = None
    if checkpoint_node:
        checkpointer = Checkpointer(CheckpointConfig.from_node(checkpoint_node),
                                    run_config=config)
    callbacks = [instantiate_from_config(node) for node in components]
    trainer = Trainer(
        build_dataclass(TrainerConfig, trainer_node, "trainer"), callbacks=callbacks,
        device=device, run_config=config, checkpointer=checkpointer,
    )
    objective = instantiate_from_config(config["model"], default_class="llm_training_tpu.lms.CLM")
    datamodule = instantiate_from_config(config["data"])
    return trainer, objective, datamodule


def run_fit(args) -> int:
    """`fit`, with JAX's exit codes for the failures a supervisor tells
    apart: 75 (resumable), 76 (recovery exhausted), 77 (loss spike), 78
    (non-finite loss)."""
    # a torchrun (or SLURM) world: the process group first, so the
    # checkpointer and the trainer see it
    initialize_distributed(backend="gloo" if args.device == "cpu" else "nccl")
    trainer, objective, datamodule = build_fit(_load(args), args.device)
    log = logging.getLogger(__name__)
    try:
        trainer.fit(objective, datamodule, resume_step=_resume_step(args))
    except PreemptionInterrupt as e:
        # the run was preempted after committing a resumable checkpoint:
        # relaunch this same command to continue
        log.warning("%s — exiting with resumable code %d", e, RESUMABLE_EXIT_CODE)
        return RESUMABLE_EXIT_CODE
    except RecoveryExhaustedError as e:
        # a blind relaunch would reproduce the failure
        log.error("%s — exiting %d", e, RECOVERY_EXHAUSTED_EXIT_CODE)
        return RECOVERY_EXHAUSTED_EXIT_CODE
    except LossSpikeError as e:
        log.error("%s — exiting %d", e, LOSS_SPIKE_EXIT_CODE)
        return LOSS_SPIKE_EXIT_CODE
    except NonFiniteLossError as e:
        log.error("%s — exiting %d", e, NON_FINITE_EXIT_CODE)
        return NON_FINITE_EXIT_CODE
    finally:
        if trainer.checkpointer is not None:
            trainer.checkpointer.close()
    return 0


def _jsonl_run_dir(config: dict) -> Path | None:
    """The run directory a `JsonlLogger` node of the config names (its
    defaults are `JsonlLoggerConfig`'s), or None."""
    for node in config.get("trainer", {}).get("loggers", []) or []:
        if str(node.get("class_path", "")).endswith("JsonlLogger"):
            init = node.get("init_args", {}) or {}
            if init.get("name"):
                return (Path(init.get("save_dir", "runs"))
                        / str(init.get("project", "llm-training-tpu")) / str(init["name"]))
    return None


def _refuse_multi_process(command: str) -> None:
    """`rl-fit` and `supervise` run in one process: launched as a world of
    several (torchrun, SLURM) they raise, naming the queue that brings them."""
    world = max(int(os.environ.get(n) or 1) for n in ("WORLD_SIZE", "SLURM_NTASKS"))
    if world > 1:
        raise NotImplementedError(
            f"{command} across {world} processes is not ported yet (ROADMAP A.9b); run it as "
            "one process")


def run_rl_fit(args) -> int:
    """`rl-fit`: on-policy GRPO riding the serving engine (`rl/loop.py`).
    SIGTERM drains the rollouts in flight into the request journal,
    checkpoints the weights they were sampled under with the round cursor,
    and exits 75; the relaunch restores, replays the journal and adopts the
    replayed rollouts. The run dir's `trace.jsonl` takes the `rl/*` spans;
    `LLMT_SLO_*` arms the SLO monitor (user traffic feeds it; a serve
    breach makes rollout submission yield `--yield-steps` engine steps) and
    `LLMT_METRICS_PORT` the exporter; the final gauges merge into the run
    dir's `telemetry.jsonl` for `report`'s `== RL ==`."""
    _refuse_multi_process("rl-fit")
    config = _load(args)
    log = logging.getLogger(__name__)
    trainer, objective, _ = build_fit(config, args.device)
    if not isinstance(objective, GRPO):
        raise SystemExit(
            "rl-fit drives the GRPO objective; the config's model node "
            f"builds {type(objective).__name__} — point rl-fit at a config "
            "whose model node is llm_training_tpu.lms.GRPO wrapping the "
            "policy model"
        )
    model_config = (objective.model.config if objective.model is not None
                    else objective.config.model.model_config())
    serve_config = ServeConfig(
        max_batch=args.max_batch,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk,
        max_queue=args.max_queue,
        cache_dtype=args.cache_dtype,
        seed=args.seed,
        eos_token_id=(
            args.eos_token_id if args.eos_token_id is not None else _scalar_eos(model_config)
        ),
        sampling=SamplingConfig(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
        ),
    )
    run_dir = _jsonl_run_dir(config)
    trace_attached = run_dir is not None and get_tracer().attach_sink(run_dir / "trace.jsonl")
    # serve chaos (LLMT_CHAOS_SERVE_*) fires inside engine.step, so the
    # SIGTERM-mid-rollout drill takes the drain, journal and adopt path
    install_chaos(config_from_env())
    shutdown = GracefulShutdown().install()
    slo = build_slo_monitor(registry=get_registry(), run_dir=run_dir)
    journal = None
    exporter = None
    try:
        loop = RLLoop(trainer, objective, serve_config, RLLoopOptions(
            rounds=args.rounds,
            prompts_per_round=args.prompts_per_round,
            prompt_len=args.prompt_len,
            max_new_tokens=args.max_new_tokens,
            sync_mode=args.sync_mode,
            reward=args.reward,
            prompt_style=args.prompt_style,
            rollout_priority=args.rollout_priority,
            updates_per_round=args.updates_per_round,
            user_traffic=args.user_traffic,
            yield_steps=args.yield_steps,
            resume_step=_resume_step(args),
        ), slo=slo)
        loop.setup()
        engine = loop.engine
        exporter = start_exporter(
            registry=get_registry(), slo=slo, role="rl-fit",
            extra_fn=lambda: {**engine.live_stats(), **loop.collector.stats()},
            status_fn=lambda: {
                "engine step": engine.step_index,
                "queue depth": len(engine.scheduler.waiting),
                "running": len(engine.scheduler.running),
            },
        )
        # the rollout journal, with serve's rotation contract: the backup
        # lives until every entry is accepted again into the new journal
        journal_path = run_dir / "rl-journal.jsonl" if run_dir is not None else None
        backup_path = None
        resumed = []
        if journal_path is not None:
            backup_path = journal_path.with_name("rl-journal.replaying.jsonl")
            if journal_path.exists():
                with open(backup_path, "a") as backup:
                    backup.write(journal_path.read_text())
                journal_path.unlink()
            if backup_path.exists():
                resumed = replay_journal(backup_path)
            journal = RequestJournal(journal_path)
            engine.attach_journal(journal, every=args.journal_every)
        if resumed:
            log.warning("replaying %d journaled rollout(s) from the previous rl-fit process",
                        len(resumed))
            # adopt first, so the replayed token events route to the collector
            loop.collector.adopt(resumed)
            for entry in resumed:
                loop.collector.ingest(engine.submit_resumed(entry))
        if backup_path is not None and backup_path.exists():
            backup_path.unlink()

        result = loop.run(shutdown=shutdown,
                          emit=lambda record: print(json.dumps(record), flush=True))
        rc = RESUMABLE_EXIT_CODE if result["interrupted"] else 0
        if rc:
            log.warning("%s: rollouts journaled and round cursor checkpointed — exiting %d "
                        "(resumable)", shutdown.reason, RESUMABLE_EXIT_CODE)
        stats = result["gauges"]
        if trace_attached:
            get_tracer().detach_sink()
            trace_attached = False
        print(json.dumps({"type": "stats", "stats": stats}), flush=True)
        _publish_run_telemetry(config, stats)
        if journal is not None:
            journal.close()
            journal = None
            if rc == 0:
                journal_path.unlink(missing_ok=True)
        return rc
    finally:
        if journal is not None:
            journal.close()
        if trainer.checkpointer is not None:
            trainer.checkpointer.close()
        if exporter is not None:
            # last, after the stats line and the telemetry merge: a final
            # scrape may follow the last record
            exporter.stop()
        if trace_attached:
            get_tracer().detach_sink()
        uninstall_chaos()
        shutdown.uninstall()


def run_supervise(args) -> int:
    """`supervise`: relaunch `fit` (or, with `--child serve`, `serve`) on exit
    75 and hard deaths. Subprocesses only: this process never initializes
    CUDA. A relaunched serve child replays its request journal before it
    reads stdin, which the children inherit from this process."""
    _refuse_multi_process("supervise")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        # the serve protocol owns stdout
                        stream=sys.stderr if args.child == "serve" else sys.stdout)
    child_args = list(args.overrides) + shlex.split(args.child_args or "")
    log_path = args.log
    if log_path is None:
        # no explicit --log: the churn log lands in the config's run directory
        # when it names one, else the working directory
        log_path = "supervisor.jsonl"
        try:
            overrides = [t for t in child_args if "=" in t and not t.startswith("-")]
            run_dir = _jsonl_run_dir(load_config(args.config, overrides))
            if run_dir is not None:
                log_path = str(run_dir / "supervisor.jsonl")
        except Exception:
            pass  # an unparseable config: the child reports it
    config = SupervisorConfig(
        max_restarts=args.max_restarts, backoff_base_s=args.backoff_base_s,
        backoff_max_s=args.backoff_max_s, log_path=log_path or None,
        min_devices=args.min_devices, probe_backoff_s=args.probe_backoff_s,
        probe_max_wait_s=args.probe_max_wait_s,
    )
    build = build_serve_argv if args.child == "serve" else build_fit_argv
    supervisor = Supervisor(
        build(args.config, child_args, ckpt_path=args.ckpt_path), config=config,
        # relaunches drop an explicit --ckpt-path: they restore the newest step
        relaunch_argv=build(args.config, child_args),
    )
    return supervisor.run()


def run_validate(args) -> int:
    trainer, objective, datamodule = build_fit(_load(args), args.device)
    result = trainer.validate_from_checkpoint(objective, datamodule,
                                              resume_step=_resume_step(args))
    print(json.dumps(result), flush=True)
    return 0


def _parse_prompts(args, config: dict) -> list[list[int]]:
    """--prompt-tokens '3,17,42' (repeatable) and/or --prompt 'text...'
    (repeatable; encoded by the tokenizer of the config's data node, as
    JAX's `_parse_prompts` does)."""
    prompts = [[int(t) for t in raw.replace(" ", "").split(",") if t]
               for raw in args.prompt_tokens or []]
    if args.prompt:
        tokenizer_node = config.get("data", {}).get("init_args", {}).get("tokenizer")
        if tokenizer_node is None:
            raise SystemExit(
                "--prompt needs a tokenizer in the config's data node; "
                "use --prompt-tokens with raw token ids instead"
            )
        from llm_training_tpu_torch.data.tokenizer import resolve_tokenizer

        tokenizer = resolve_tokenizer(tokenizer_node)
        prompts += [list(tokenizer(text)["input_ids"]) for text in args.prompt]
    if not prompts:
        raise SystemExit("generate needs --prompt-tokens and/or --prompt")
    return prompts


def run_generate(args) -> int:
    config = _load(args)
    prompts = _parse_prompts(args, config)
    _, _, _, state = _restored(config, args, "generate")
    engine = InferenceEngine(state.model, device=next(state.model.parameters()).device)
    config = GenerateConfig(
        max_new_tokens=args.max_new_tokens,
        max_length=args.max_length,
        cache_dtype=args.cache_dtype,
        seed=args.seed,
        eos_token_id=(
            args.eos_token_id if args.eos_token_id is not None
            else _scalar_eos(state.model.config)
        ),
        sampling=SamplingConfig(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
        ),
    )
    result = engine.generate(prompts, config)
    for row, tokens in enumerate(result["tokens"]):
        record = {
            "prompt": prompts[row],
            "tokens": tokens,
            "sequence": result["sequences"][row],
            "n_tokens": result["lengths"][row],
            "stop_reason": result["stop_reasons"][row],
        }
        if args.logprobs:
            # each chosen token's logprob under the distribution it was
            # drawn from (raw log-softmax when greedy)
            record["logprobs"] = result["logprobs"][row]
        print(json.dumps(record))
    print(json.dumps({"stats": result["stats"]}), flush=True)
    return 0


def run_evaluate(args) -> int:
    trainer, objective, datamodule, _ = _restored(_load(args), args, "evaluate")
    result = run_evaluation(objective, datamodule, trainer.device,
                            limit_batches=args.limit_batches, split=args.split)
    print(json.dumps(result), flush=True)
    return 0


def _run_args(parser: argparse.ArgumentParser, device_default: str | None = None) -> None:
    """The flags every config-driven command shares."""
    parser.add_argument("--ckpt-path", default=None, help="checkpoint step to restore")
    parser.add_argument("overrides", nargs="*", help="key.path=value (value parsed as JSON)")
    parser.add_argument("--device", default=device_default, help="cuda (default) or cpu")


def _sampling_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--cache-dtype", default=None, choices=("param", "float32", "bfloat16"),
        help="KV-cache storage dtype (default: the model's param dtype)",
    )
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--eos-token-id", type=int, default=None,
        help="stop token (default: the model config's scalar eos, if any)",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="llm_training_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for command, text in (("fit", "train an objective from a JSON config (resumes from "
                                  "the newest checkpoint)"),
                          ("validate", "validation loss of a run's checkpoint")):
        p = sub.add_parser(command, help=text)
        p.add_argument("--config", required=True, help="JSON config file")
        _run_args(p)

    generate = sub.add_parser("generate", help="KV-cache decoding from a run's checkpoint")
    generate.add_argument("--config", required=True, help="JSON config file")
    generate.add_argument(
        "--prompt-tokens", action="append", default=None,
        metavar="IDS", help="comma-separated token ids (repeatable)",
    )
    generate.add_argument(
        "--prompt", action="append", default=None,
        help="text prompt (repeatable; needs a tokenizer in the data config)",
    )
    generate.add_argument("--max-new-tokens", type=int, default=32)
    generate.add_argument(
        "--max-length", type=int, default=None,
        help="KV-cache capacity (default: prompt width + max_new_tokens)",
    )
    generate.add_argument(
        "--logprobs", action="store_true",
        help="include each generated token's logprob (under the sampled distribution; "
        "raw log-softmax when greedy) in the output records",
    )
    _sampling_args(generate)
    _run_args(generate)

    evaluate = sub.add_parser(
        "evaluate", help="packed perplexity / per-token NLL from a run's checkpoint"
    )
    evaluate.add_argument("--config", required=True, help="JSON config file")
    evaluate.add_argument("--limit-batches", type=int, default=None)
    evaluate.add_argument("--split", default="val", choices=("val", "train"))
    _run_args(evaluate)

    serve = sub.add_parser(
        "serve",
        help="continuous-batching generation server: JSONL requests on stdin, "
        "streamed token/done chunks on stdout",
    )
    serve.add_argument("--config", default=None,
                       help="JSON config of a run: serve its checkpoint's weights")
    serve.add_argument("--preset", choices=sorted(PRESETS), default=None)
    serve.add_argument("--model-config", default=None, help="JSON file of LlamaConfig fields")
    serve.add_argument(
        "--weights", default=None,
        help=".npz of the JAX parameter tree, keys joined by '/' (default: random from --seed)",
    )
    serve.add_argument("--max-batch", type=int, default=4, help="decode slots")
    serve.add_argument(
        "--max-model-len", type=int, default=256,
        help="per-request cap: prompt + generated tokens",
    )
    serve.add_argument("--prefill-chunk", type=int, default=32)
    serve.add_argument("--block-size", type=int, default=DEFAULT_BLOCK_SIZE)
    serve.add_argument(
        "--num-blocks", type=int, default=None,
        help="KV-pool capacity in blocks (default: max_batch full-length "
        "requests — no block pressure)",
    )
    serve.add_argument(
        "--max-new-tokens", type=int, default=32,
        help="generation budget for requests that omit it",
    )
    serve.add_argument(
        "--max-queue", type=int, default=None,
        help="intake bound: queued requests past this are shed with "
        "stop_reason='overloaded' (lowest priority first); default unbounded",
    )
    serve.add_argument(
        "--shed-ttft-ms", type=float, default=None,
        help="shed queued requests whose projected TTFT (EMA service-time "
        "estimate) crosses this many ms; default off",
    )
    serve.add_argument(
        "--drain-timeout-s", type=float, default=30.0,
        help="SIGTERM grace: finish in-flight requests for up to this "
        "long, then evict-and-journal the rest and exit 75 (resumable)",
    )
    serve.add_argument(
        "--watchdog-timeout-s", type=float, default=0.0,
        help="abort (SIGABRT, after a flight dump) when an engine step "
        "makes no progress for this long, so `supervise` can relaunch; "
        "0 disables (default)",
    )
    serve.add_argument(
        "--journal-every", type=int, default=1,
        help="engine steps between request-journal progress checkpoints "
        "(1 = every step; drain always journals)",
    )
    _sampling_args(serve)
    _run_args(serve, device_default="cuda")

    rl_fit = sub.add_parser(
        "rl-fit",
        help="on-policy GRPO post-training: rollouts through the serving "
        "engine, group-relative policy-gradient updates, weight sync into "
        "the engine each round",
    )
    rl_fit.add_argument("--config", required=True, help="JSON config file")
    rl_fit.add_argument(
        "--ckpt-path", default=None,
        help="checkpoint step to restore the policy from (default: newest; "
        "fresh seed-init when none exists)",
    )
    rl_fit.add_argument("--rounds", type=int, default=4)
    rl_fit.add_argument(
        "--prompts-per-round", type=int, default=2,
        help="prompt groups per round (x the objective's group_size samples each)",
    )
    rl_fit.add_argument(
        "--prompt-len", type=int, default=4,
        help="synthetic prompt length (deterministic in seed and round)",
    )
    rl_fit.add_argument("--max-new-tokens", type=int, default=8)
    rl_fit.add_argument(
        "--sync-mode", default="fused", choices=("fused", "host"),
        help="trainer->engine weight sync: fused = the engine decodes from the "
        "policy's own tensors (default), host = a round trip through host memory "
        "into the engine's tensors (the correctness oracle)",
    )
    rl_fit.add_argument(
        "--reward", default=None,
        help="verifiable reward name (copy_digit/regex/numeric_answer/"
        "length; default: LLMT_RL_REWARD, else copy_digit)",
    )
    rl_fit.add_argument(
        "--prompt-style", default="uniform", choices=("uniform", "repeat"),
        help="synthetic prompt shape: uniform random tokens, or one digit "
        "repeated (the copy-the-digit smoke task)",
    )
    rl_fit.add_argument(
        "--updates-per-round", type=int, default=1,
        help="PPO-style epochs over each round's batch (the clipped "
        "importance ratio keeps >1 sound)",
    )
    rl_fit.add_argument(
        "--rollout-priority", type=int, default=-1,
        help="scheduler priority class for rollout requests (default -1: "
        "below user traffic's 0, so contention evicts rollouts first)",
    )
    rl_fit.add_argument(
        "--user-traffic", type=int, default=0,
        help="synthetic priority-0 user requests submitted per round "
        "alongside the rollouts",
    )
    rl_fit.add_argument(
        "--yield-steps", type=int, default=50,
        help="engine steps rollout submission backs off after a new serve "
        "SLO burn-rate breach (LLMT_SLO_TTFT_P99_MS / LLMT_SLO_TPOT_P99_MS "
        "arm the monitor that user traffic feeds)",
    )
    rl_fit.add_argument("--max-batch", type=int, default=4, help="decode slots (static batch)")
    rl_fit.add_argument("--max-model-len", type=int, default=256)
    rl_fit.add_argument("--block-size", type=int, default=DEFAULT_BLOCK_SIZE)
    rl_fit.add_argument("--num-blocks", type=int, default=None)
    rl_fit.add_argument("--prefill-chunk", type=int, default=32)
    rl_fit.add_argument(
        "--max-queue", type=int, default=None,
        help="intake bound; overflow sheds lowest-priority (rollouts) first",
    )
    rl_fit.add_argument(
        "--journal-every", type=int, default=1,
        help="engine steps between rollout-journal progress checkpoints",
    )
    rl_fit.add_argument(
        "--cache-dtype", default=None, choices=("param", "float32", "bfloat16"),
        help="KV-cache storage dtype (default: the model's param dtype)",
    )
    rl_fit.add_argument(
        "--temperature", type=float, default=1.0,
        help="rollout sampling temperature (must be > 0 for exploration)",
    )
    rl_fit.add_argument("--top-k", type=int, default=None)
    rl_fit.add_argument("--top-p", type=float, default=None)
    rl_fit.add_argument("--seed", type=int, default=0)
    rl_fit.add_argument("--eos-token-id", type=int, default=None)
    rl_fit.add_argument("overrides", nargs="*", help="key.path=value (value parsed as JSON)")
    rl_fit.add_argument("--device", default=None, help="cuda (default) or cpu")

    supervise = sub.add_parser(
        "supervise",
        help="run fit (or, with --child serve, the serving tier) as a "
        "supervised child process; restart it on preemption (exit 75) and "
        "hard deaths (SIGKILL/segfault/SIGABRT)",
    )
    supervise.add_argument("--config", required=True)
    supervise.add_argument(
        "--child", default="fit", choices=("fit", "serve"),
        help="the supervised subcommand; a relaunched serve child replays "
        "its request journal before reading stdin",
    )
    supervise.add_argument(
        "--child-args", default="",
        help="extra flags/overrides for the child, as one shell-quoted "
        "string (e.g. --child-args '--device cpu run_root=/tmp/x') — the "
        "channel for flags the supervise parser does not know",
    )
    supervise.add_argument(
        "--ckpt-path", default=None,
        help="explicit resume step for the FIRST launch only (relaunches "
        "always restore the newest checkpoint)",
    )
    supervise.add_argument("--max-restarts", type=int, default=10)
    supervise.add_argument("--backoff-base-s", type=float, default=1.0)
    supervise.add_argument("--backoff-max-s", type=float, default=300.0)
    supervise.add_argument(
        "--min-devices", type=int, default=None,
        help="elastic capacity gate: before each relaunch, probe the "
        "visible device count (in a subprocess) and wait while it is below "
        "this minimum; default: relaunch blind",
    )
    supervise.add_argument(
        "--probe-backoff-s", type=float, default=5.0,
        help="sleep between capacity probes while below --min-devices",
    )
    supervise.add_argument(
        "--probe-max-wait-s", type=float, default=300.0,
        help="give up (propagating the child's exit code) after waiting "
        "this long for --min-devices",
    )
    supervise.add_argument(
        "--log", default=None,
        help="supervisor event log path ('' disables). Default: "
        "supervisor.jsonl in the config's run directory when it names one, "
        "else the cwd; an explicit path — including './supervisor.jsonl' — "
        "is used as given",
    )
    supervise.add_argument("overrides", nargs="*")

    watch = sub.add_parser(
        "watch",
        help="poll a live run's /statusz (the LLMT_METRICS_PORT exporter) "
        "and print each snapshot",
    )
    watch.add_argument("--port", type=int, default=None,
                       help="exporter port (default: LLMT_METRICS_PORT)")
    watch.add_argument("--host", default="127.0.0.1")
    watch.add_argument("--interval-s", type=float, default=2.0, help="poll cadence")
    watch.add_argument("--once", action="store_true",
                       help="one snapshot then exit (exit 2 when unreachable)")

    profile = sub.add_parser(
        "profile",
        help="arm a device-profile capture on a live run via its exporter's "
        "/profilez endpoint; exit 0 when armed, 3 when the trigger refused "
        "(budget/cooldown/busy), 2 when unreachable",
    )
    profile.add_argument("--port", type=int, default=None,
                         help="exporter port (default: LLMT_METRICS_PORT)")
    profile.add_argument("--host", default="127.0.0.1")
    profile.add_argument("--tag", default=None,
                         help="artifact tag (profile-<tag>/ in the run dir; default: a "
                         "profilez-<n> serial)")

    trace = sub.add_parser(
        "trace",
        help="export a run's trace.jsonl as Chrome-trace JSON viewable in Perfetto",
    )
    trace.add_argument("source", nargs="?", default=None,
                       help="run directory holding trace.jsonl, or a trace/flight-dump "
                       "jsonl file directly")
    trace.add_argument("--out", default=None,
                       help="output path (default: trace-export.json next to the source)")
    trace.add_argument("--merge", nargs="+", default=None, metavar="DIR",
                       help="instead of one source: wall-align N run dirs (via their "
                       "clock_anchor events) into ONE Perfetto file with per-run tracks")

    report = sub.add_parser("report", help="render a run summary from a run directory")
    report.add_argument("run_dir", help="dir holding metrics.jsonl / telemetry.jsonl")
    report.add_argument(
        "--bench-dir", default=None,
        help="dir searched first for the newest BENCH_r*.json / bench*.json "
        "record (== Perf == section); falls back to run_dir, then cwd",
    )
    report.add_argument(
        "--supervisor-log", default=None,
        help="supervisor.jsonl with per-segment topology events "
        "(== Elastic == section); default: <run_dir>/supervisor.jsonl",
    )
    report.add_argument(
        "--audit-dir", default=None,
        help="dir searched first for the newest audit*.json shardcheck "
        "record (== Audit == section); falls back to run_dir",
    )
    report.add_argument(
        "--format", default="text", choices=("text", "json"),
        help="json emits every section as one machine-readable object "
        "(schema_version-pinned, for trend tracking)",
    )

    fleet = sub.add_parser(
        "fleet",
        help="sweep a fleet of replicas (LLMT_FLEET_DIR cards or static "
        "--targets) and render rollups + health verdict; optionally "
        "re-export federation /metrics",
    )
    fleet.add_argument("--dir", default=None,
                       help="discovery directory holding replica-*.json cards "
                       "(default: LLMT_FLEET_DIR)")
    fleet.add_argument("--targets", default="",
                       help="static host:port,host:port replica list (skips discovery)")
    fleet.add_argument("--interval-s", type=float, default=None,
                       help="sweep cadence (default: LLMT_FLEET_SCRAPE_S, else 2s)")
    fleet.add_argument("--port", type=int, default=None,
                       help="also serve the aggregator's /metrics //fleetz //healthz "
                       "federation endpoint on this port")
    fleet.add_argument("--once", action="store_true",
                       help="one sweep then exit (exit 2, naming the searched paths, "
                       "when no replicas are found)")
    fleet.add_argument("--json", action="store_true",
                       help="emit the raw snapshot JSON instead of the fleetz one-pager")
    fleet.add_argument("--out", default=None,
                       help="also write the snapshot JSON here (a run dir's fleet.json "
                       "is what `report --format json` surfaces as its fleet block)")

    route = sub.add_parser(
        "route",
        help="health-aware router over N serve replicas: same JSONL "
        "protocol as serve on stdin/stdout, least-loaded routing with "
        "eviction on red/stale health, failover replay with exactly-once "
        "terminals, hedged retries, and SLO-driven elasticity",
    )
    route.add_argument("--config", required=True)
    route.add_argument("--ckpt-path", default=None,
                       help="checkpoint step each serve replica restores")
    route.add_argument("--replicas", type=int, default=2,
                       help="initial AND minimum serve replica count")
    route.add_argument("--max-replicas", type=int, default=None,
                       help="elasticity ceiling (default: --replicas, i.e. scale-out off)")
    route.add_argument(
        "--hedge-ttft-ms", type=float, default=0.0,
        help="hedge a request onto a second replica when its projected "
        "TTFT crosses this budget (deadline_ms, when set on the request, "
        "takes precedence); 0 disables (default)",
    )
    route.add_argument("--scrape-interval-s", type=float, default=None,
                       help="fleet health sweep cadence (default: LLMT_FLEET_SCRAPE_S, "
                       "else 2s)")
    route.add_argument("--idle-retire-s", type=float, default=0.0,
                       help="drain-and-retire one replica (down to --replicas) after this "
                       "long with no traffic; 0 disables (default)")
    route.add_argument("--scale-cooldown-s", type=float, default=30.0,
                       help="minimum seconds between scale events")
    route.add_argument("--drain-timeout-s", type=float, default=30.0,
                       help="SIGTERM grace before journaling the remainder and exiting 75")
    route.add_argument("--replica-run-root", default=None,
                       help="parent dir for per-replica run roots (default: "
                       "<run_dir>/replicas); each replica gets run_root=<root>/rN")
    route.add_argument("--seed-run-dir", default=None,
                       help="run dir whose checkpoints/ seeds each fresh replica "
                       "(default: the router's own run dir when it has one)")
    route.add_argument(
        "serve_args", nargs="*",
        help="flags/overrides forwarded to every serve replica: pass "
        "after `--` (e.g. -- --device cpu --max-batch 2 --eos-token-id -1)",
    )

    ckpt = sub.add_parser(
        "ckpt",
        help="checkpoint durability operations over a checkpoint root "
        "(and its mirror): verify manifests, list steps, retention GC, "
        "force a mirror pass",
    )
    ckpt_sub = ckpt.add_subparsers(dest="ckpt_command", required=True)
    for name, help_text in (
        ("verify", "check every committed step against its integrity "
         "manifest; exit 1 with each offending file named on findings"),
        ("ls", "list committed steps and their manifest status"),
        ("gc", "apply the retention policy (keep-last-N + keep-every-K; "
         "never the newest step, never the last intact copy)"),
        ("mirror", "mirror every manifested step now (tmp-then-rename + "
         "manifest re-verification on the copy)"),
    ):
        p = ckpt_sub.add_parser(name, help=help_text)
        p.add_argument("dir", help="checkpoint root (the step_N parent)")
        p.add_argument("--mirror-dir", default=None,
                       help="mirror root (default: LLMT_CKPT_MIRROR_DIR)")
        if name == "verify":
            p.add_argument("--mode", default="fast", choices=("fast", "full"),
                           help="fast = file set + sizes; full = re-hash every file")
            p.add_argument("--step", type=int, default=None,
                           help="verify only this step (default: every committed step)")
        if name == "gc":
            p.add_argument("--keep-last", type=int, default=3)
            p.add_argument("--keep-every", type=int, default=None,
                           help="also keep every step divisible by K")
            p.add_argument("--dry-run", action="store_true")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    commands = {"fit": run_fit, "validate": run_validate, "generate": run_generate,
                "evaluate": run_evaluate, "serve": run_serve, "rl-fit": run_rl_fit,
                "supervise": run_supervise,
                "ckpt": ckpt_main,
                "watch": lambda a: watch_main(port=a.port, host=a.host,
                                              interval_s=a.interval_s, once=a.once),
                "profile": lambda a: profile_main(port=a.port, host=a.host, tag=a.tag),
                "trace": lambda a: trace_main(a.source, out=a.out, merge=a.merge),
                "report": lambda a: report_main(
                    a.run_dir, bench_dir=a.bench_dir, supervisor_log=a.supervisor_log,
                    audit_dir=a.audit_dir, format=a.format),
                "fleet": lambda a: fleet_main(
                    fleet_dir=a.dir, targets=a.targets, interval_s=a.interval_s, port=a.port,
                    once=a.once, as_json=a.json, out=a.out),
                "route": route_main}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
