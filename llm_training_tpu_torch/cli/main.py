"""Console entry: `python -m llm_training_tpu_torch serve`.

Counterpart of `_run_serve` in `llm_training_tpu/cli/main.py`: a
continuous-batching server over a JSONL stdin/stdout protocol. One request
per input line (`{"id", "prompt": [ids], "max_new_tokens"?, "priority"?}`);
the engine streams `{"type": "token"}` chunks and one `{"type": "done"}`
per request as they land, admitting new requests between decode steps. A
malformed line answers a `{"type": "error"}` chunk and the server keeps
running. stdin EOF drains the queue, then a final `{"type": "stats"}`
record is printed.

The model is a named preset (`--preset llama-3.1-8b`) or a JSON config
file (`--model-config`); weights come from a `.npz` of the JAX parameter
tree (`--weights`, keys joined by '/') or are drawn from `--seed`.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
from typing import TextIO

import numpy as np
import torch

from llm_training_tpu_torch import resolve_device
from llm_training_tpu_torch.infer.sampling import SamplingConfig
from llm_training_tpu_torch.models.llama.config import PRESETS, LlamaConfig, preset
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax, tree_from_flat
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.serve.paged_cache import DEFAULT_BLOCK_SIZE


def build_model(args) -> Llama:
    """The model of `args` on its device, with carried or random weights."""
    device = resolve_device(args.device)
    if (args.preset is None) == (args.model_config is None):
        raise SystemExit("give exactly one of --preset / --model-config")
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
        prefill_chunk=args.prefill_chunk,
        seed=args.seed,
        eos_token_id=(
            args.eos_token_id if args.eos_token_id is not None
            else _scalar_eos(model.config)
        ),
        sampling=SamplingConfig(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
        ),
    )
    engine = ServingEngine(model, serve_config, device=args.device)

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
            emit(engine.submit(
                id=record["id"], prompt=record["prompt"],
                max_new_tokens=int(record.get("max_new_tokens", args.max_new_tokens)),
                priority=int(record.get("priority", 0)),
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="llm_training_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve",
        help="continuous-batching generation server: JSONL requests on stdin, "
        "streamed token/done chunks on stdout",
    )
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
        "--max-new-tokens", type=int, default=32,
        help="generation budget for requests that omit it",
    )
    serve.add_argument(
        "--eos-token-id", type=int, default=None,
        help="stop token (default: the model config's scalar eos, if any)",
    )
    serve.add_argument("--temperature", type=float, default=0.0)
    serve.add_argument("--top-k", type=int, default=None)
    serve.add_argument("--top-p", type=float, default=None)
    serve.add_argument("--seed", type=int, default=0)
    serve.add_argument("--device", default="cuda")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        return run_serve(args)
    raise SystemExit(f"unknown command {args.command!r}")


if __name__ == "__main__":
    sys.exit(main())
