"""`route` end to end on the CPU: the port's router over two of the port's
own `serve --config` children, one of which the router's chaos trigger
SIGKILLs mid-stream.

The tiny checkpoint comes from a one-step port `fit`. Six greedy requests
go through `route --replicas 2 -- --device cpu`; the router kills the
replica that produced the 20th forwarded token, folds its journal and
replays what was in flight on a live replica (a replacement is spawned).
Every request gets exactly one terminal, and its tokens equal those of one
uninterrupted `serve --config` of the same checkpoint (fp32, so a replay's
re-prefill of prompt + delivered tokens decodes what the stream would
have). The router's stats count the failover, and `report` on its run
directory renders `== Router ==`.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from pathlib import Path

from llm_training_tpu_torch.cli.main import build_parser, run_serve
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.telemetry.report import render_report

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
            attention_impl="xla", param_dtype="float32", compute_dtype="float32")
SERVE_FLAGS = ["--max-batch", "2", "--eos-token-id", "-1"]
REQUESTS = [{"id": f"q{i}", "prompt": [3 + i, 5, 7, 9], "max_new_tokens": 12}
            for i in range(6)]
KILL_AT = 20


def _config(root: Path) -> Path:
    config = {
        "seed_everything": 7,
        "run_root": str(root / "runs"),
        "trainer": {
            "max_steps": 1,
            "checkpoint": {"dirpath": str(root / "ckpt"), "async_save": False},
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": "${run_root}", "project": "p",
                                       "name": "route"}}],
        },
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": TINY},
            "optim": {"learning_rate": 1e-3}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 2, "max_length": 16, "num_samples": 4,
                               "vocab_size": TINY["vocab_size"]}},
    }
    path = root / "route.json"
    path.write_text(json.dumps(config))
    return path


def _records(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_route_failover_over_two_serve_children(tmp_path):
    config = _config(tmp_path)
    assert cli_main(["fit", "--config", str(config), "--device", "cpu"]) == 0
    stdin = "".join(json.dumps(r) + "\n" for r in REQUESTS)

    # the reference: one uninterrupted serve of the checkpoint
    args = build_parser().parse_args(["serve", "--config", str(config), "--device", "cpu",
                                      *SERVE_FLAGS, f"run_root={tmp_path / 'reference'}"])
    out = io.StringIO()
    assert run_serve(args, stdin=io.StringIO(stdin), stdout=out) == 0
    reference = {r["id"]: r["tokens"] for r in _records(out.getvalue())
                 if r.get("type") == "done"}
    assert sorted(reference) == [r["id"] for r in REQUESTS]

    env = {k: v for k, v in os.environ.items() if not k.startswith("LLMT_")}
    run = subprocess.run(
        [sys.executable, "-m", "llm_training_tpu_torch", "route", "--config", str(config),
         "--replicas", "2", "--scrape-interval-s", "0.5", "--", "--device", "cpu",
         *SERVE_FLAGS],
        cwd=ROOT, input=stdin, capture_output=True, text=True, timeout=240,
        env={**env, "PYTHONPATH": str(ROOT), "LLMT_CHAOS_ROUTER_KILL_REPLICA": str(KILL_AT)})
    assert run.returncode == 0, run.stderr[-3000:]
    records = _records(run.stdout)
    done = [r for r in records if r.get("type") == "done"]
    assert sorted(r["id"] for r in done) == sorted(reference)  # one terminal each
    assert {r["id"]: r["tokens"] for r in done} == reference
    streamed: dict[str, list[int]] = {}
    for r in records:
        if r.get("type") == "token":
            streamed.setdefault(r["id"], []).append(r["token"])
    assert streamed == reference  # no token streamed twice, none lost
    stats = next(r["stats"] for r in records if r.get("type") == "stats")
    assert stats["failovers"] >= 1 and stats["replays"] >= 1
    assert stats["requests_completed"] == len(REQUESTS)
    assert "chaos_kill_replica" in (tmp_path / "runs" / "p" / "route" / "trace.jsonl").read_text()
    assert "== Router ==" in render_report(tmp_path / "runs" / "p" / "route")
