"""Console entry: `python -m llm_training_tpu_torch
{fit,validate,generate,evaluate,serve,supervise,ckpt}`.

`fit --config file.json [--ckpt-path STEP] [key.path=value ...]` trains:
the counterpart of the JAX `fit` command on a JSON config with the YAML
examples' node layout (`trainer` / `model` / `data`, components as
`class_path` + `init_args`). The `trainer` node's `loggers` and
`callbacks` lists are components too, and its `checkpoint` node builds the
`Checkpointer`: `fit` then resumes from the newest step (or `--ckpt-path`),
saves every `checkpoint_every_n_steps` and at the end. Its `health` and
`resilience` nodes are JAX's; the `mesh` node is not ported yet and raises.
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
running. stdin EOF drains the queue, then a final `{"type": "stats"}`
record is printed.

The model is the run's (`--config`, restored from its checkpoint, newest
or `--ckpt-path`, into a model whose parameters are in the run's compute
dtype), a named preset (`--preset llama-3.1-8b`) or a JSON config file
(`--model-config`); a preset's or file's weights come from a `.npz` of the
JAX parameter tree (`--weights`, keys joined by '/') or are drawn from
`--seed`.

`supervise --config file.json` runs `fit` as a child process and
relaunches it on exit 75 and on hard deaths (SIGKILL, segfault, the
watchdog's SIGABRT) with JAX's flags, budget and backoff, logging every
lifecycle event to `supervisor.jsonl` (the config's run directory by
default); it never initializes CUDA. Flags for the child (`--device cpu`)
ride in `--child-args`. `ckpt {verify,ls,gc,mirror} DIR` checks, lists,
prunes and mirrors a checkpoint root by its integrity manifests: exit 0
clean, 1 findings, 2 unusable.

Every command runs on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import random
import shlex
import sys
import threading
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
from llm_training_tpu_torch.models.llama.config import PRESETS, LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax, tree_from_flat
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.resilience import (
    LOSS_SPIKE_EXIT_CODE,
    NON_FINITE_EXIT_CODE,
    RECOVERY_EXHAUSTED_EXIT_CODE,
    RESUMABLE_EXIT_CODE,
    PreemptionInterrupt,
    RecoveryExhaustedError,
)
from llm_training_tpu_torch.resilience.durability import ckpt_main
from llm_training_tpu_torch.resilience.supervisor import (
    Supervisor,
    SupervisorConfig,
    build_fit_argv,
)
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.serve.paged_cache import DEFAULT_BLOCK_SIZE
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
        compute = provider.get_config().compute_dtype
        provider.model_kwargs = {**provider.model_kwargs, "param_dtype": compute}
    state = trainer.restore_for_inference(objective, _resume_step(args))
    return trainer, objective, datamodule, state


def build_model(args) -> Llama:
    """The serving model of `args` on its device: the run's restored
    weights (`--config`), or a preset's or file's carried or random ones."""
    if getattr(args, "config", None) is not None:
        if args.preset or args.model_config or args.weights:
            raise SystemExit("--config serves the run's checkpoint; it excludes "
                             "--preset / --model-config / --weights")
        # the JSONL protocol owns stdout: log records go to stderr
        config = _load(args, log_stream=sys.stderr)
        return _restored(config, args, "serve", serving=True)[3].model
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
    return model.eval()


def _scalar_eos(config: LlamaConfig) -> int | None:
    eos = config.eos_token_id
    if isinstance(eos, list):
        return eos[0] if len(eos) == 1 else None
    return eos


def run_serve(args, stdin: TextIO = sys.stdin, stdout: TextIO = sys.stdout) -> int:
    model = build_model(args)
    serve_config = ServeConfig(
        max_batch=args.max_batch,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk,
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
    engine = ServingEngine(model, serve_config, device=model.model.embed_tokens.weight.device)

    # a reader thread feeds stdin lines into a queue, so intake never
    # blocks the decode loop: a request arriving mid-decode joins at the
    # next step
    lines: queue.Queue = queue.Queue()
    eof = object()

    def read_stdin():
        for line in stdin:
            if line.strip():
                lines.put(line)
        lines.put(eof)

    reader = threading.Thread(target=read_stdin, daemon=True)
    reader.start()

    def emit(events):
        for event in events:
            stdout.write(json.dumps(event) + "\n")
        stdout.flush()

    def ingest(item) -> bool:
        """One stdin line -> submit, or an error chunk; False at EOF."""
        if item is eof:
            return False
        try:
            record = json.loads(item)
            if not isinstance(record, dict):
                raise ValueError("request line must be a JSON object")
            deadline_ms = record.get("deadline_ms")
            emit(engine.submit(
                id=record["id"], prompt=record["prompt"],
                max_new_tokens=int(record.get("max_new_tokens", args.max_new_tokens)),
                priority=int(record.get("priority", 0)),
                deadline_ms=float(deadline_ms) if deadline_ms is not None else None,
            ))
        except (KeyError, TypeError, ValueError) as e:  # JSONDecodeError is a ValueError
            emit([{"type": "error", "error": f"bad request line: {e}"}])
        return True

    open_stdin = True
    while open_stdin or not engine.scheduler.idle:
        if engine.scheduler.idle:
            open_stdin = ingest(lines.get())
            continue
        try:  # in flight: take whatever arrived, never stall the batch
            while open_stdin:
                open_stdin = ingest(lines.get_nowait())
        except queue.Empty:
            pass
        emit(engine.step())
    reader.join(timeout=1.0)
    emit([{"type": "stats", "stats": engine.stats()}])
    return 0


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


def run_supervise(args) -> int:
    """`supervise`: relaunch `fit` on exit 75 and hard deaths. Subprocesses
    only: this process never initializes CUDA."""
    if args.child == "serve":
        raise NotImplementedError(
            "supervise --child serve relaunches into a replay of the serve request journal, "
            "which is not ported yet (ROADMAP A.7)"
        )
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        stream=sys.stdout)
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
    supervisor = Supervisor(
        build_fit_argv(args.config, child_args, ckpt_path=args.ckpt_path), config=config,
        # relaunches drop an explicit --ckpt-path: they restore the newest step
        relaunch_argv=build_fit_argv(args.config, child_args),
    )
    return supervisor.run()


def run_validate(args) -> int:
    trainer, objective, datamodule = build_fit(_load(args), args.device)
    result = trainer.validate_from_checkpoint(objective, datamodule,
                                              resume_step=_resume_step(args))
    print(json.dumps(result), flush=True)
    return 0


def _parse_prompts(args, config: dict) -> list[list[int]]:
    """--prompt-tokens '3,17,42' (repeatable); --prompt needs a tokenizer,
    which the port does not have yet."""
    prompts = [[int(t) for t in raw.replace(" ", "").split(",") if t]
               for raw in args.prompt_tokens or []]
    if args.prompt:
        if config.get("data", {}).get("init_args", {}).get("tokenizer") is None:
            raise SystemExit(
                "--prompt needs a tokenizer in the config's data node; "
                "use --prompt-tokens with raw token ids instead"
            )
        raise NotImplementedError(
            "--prompt: tokenizers come with the HF data modules, not ported yet (ROADMAP "
            "A.5); use --prompt-tokens"
        )
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
    _sampling_args(serve)
    _run_args(serve, device_default="cuda")

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
        "its request journal before reading stdin (serve: not ported yet)",
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
                "evaluate": run_evaluate, "serve": run_serve, "supervise": run_supervise,
                "ckpt": ckpt_main}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
