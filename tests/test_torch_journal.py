"""Port parity of the serving engine's resilience half on the CPU: the
request journal (one package writes, the other replays, both ways), the
engine's drain and `submit_resumed` (a replayed stream continues token for
token, nothing streamed twice), and `serve --config`'s `{"type": "reload"}`
control line against the JAX `serve` on a checkpoint of each package.
"""

import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import torch

from llm_training_tpu.serve import journal as jax_journal
from llm_training_tpu_torch.cli.main import build_parser, run_serve
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.serve import journal as port_journal
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=64,
    rms_norm_eps=1e-5, rope_theta=10000.0, compute_dtype="float32", param_dtype="float32",
)


def _request(id, prompt, max_new_tokens=8, priority=0, deadline_ms=None):
    return types.SimpleNamespace(
        id=id, prompt=list(prompt), max_new_tokens=max_new_tokens, priority=priority,
        arrival_s=100.0, deadline_s=None if deadline_ms is None else 100.0 + deadline_ms / 1e3,
        generated=[], logprobs=[], emitted=0, stop_reason=None)


def _write(module, path: Path) -> None:
    """One call sequence: accepted, delta progress (an unchanged state
    writes nothing), a retired id, a reused id, a note and a torn tail."""
    journal = module.RequestJournal(path)
    a = _request("a", [3, 4], priority=-1, deadline_ms=250.0)
    journal.accepted(a)
    a.generated, a.logprobs, a.emitted = [5, 6], [-0.5, -1.25], 1
    journal.progress(a)
    journal.progress(a)
    a.generated.append(7)
    a.logprobs.append(None)
    a.emitted = 3
    journal.progress(a)
    b = _request("b", [9])
    journal.delivered("b", [9], 4, priority=2)
    b.generated, b.logprobs, b.emitted = [1], [-2.0], 1
    journal.progress(b)
    b.stop_reason = "max_tokens"
    journal.finished(b)
    journal.note({"event": "route", "id": "a", "replica": 0})
    journal.delivered("b", [8, 8], 2)
    journal.close()
    with open(path, "a") as f:
        f.write('{"event": "progress", "id": "a", "generat')


def test_journal_is_read_by_the_other_package(tmp_path):
    """The same calls write byte-identical journals in both packages, and
    each package's `replay_journal` folds either file to the same
    entries: the torn tail skipped, the retired id dropped, the reused id's
    last acceptance kept, logprobs re-concatenated with their gaps."""
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    _write(port_journal, ours)
    _write(jax_journal, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours, theirs):
        entries = port_journal.replay_journal(path)
        assert entries == jax_journal.replay_journal(path)
        assert [e["id"] for e in entries] == ["a", "b"]
        assert entries[0]["generated"] == [5, 6, 7] and entries[0]["logprobs"] == [-0.5, -1.25, None]
        assert entries[0]["emitted"] == 3 and entries[0]["deadline_ms"] == 250.0
        assert entries[1]["prompt"] == [8, 8] and entries[1]["generated"] == []
    assert port_journal.replay_journal(tmp_path / "missing.jsonl") == []


def _model(seed=0) -> Llama:
    model = Llama(LlamaConfig(**TINY), device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval()


def _engine(model, max_batch=2):
    return ServingEngine(model, ServeConfig(max_batch=max_batch, max_model_len=48, block_size=8,
                                            prefill_chunk=4, eos_token_id=None), device="cpu")


REQUESTS = [("r0", [3, 17, 42, 7], 10), ("r1", [5, 9], 12), ("r2", [11, 2, 2], 9)]


def test_drain_and_replay_continue_every_stream(tmp_path):
    """An engine with a journal drains mid-stream (its running rows and its
    queue journaled, every block freed); a fresh engine replays the journal
    with `submit_resumed` and every request ends with the tokens of an
    uninterrupted run, no token streamed twice. The JAX package replays
    the port's journal to the same entries."""
    model = _model()
    full = {e["id"]: e["tokens"] for e in _engine(model).run(
        [{"id": i, "prompt": p, "max_new_tokens": n} for i, p, n in REQUESTS])
        if e["type"] == "done"}
    path = tmp_path / "journal.jsonl"
    engine = _engine(model)
    engine.attach_journal(port_journal.RequestJournal(path), every=2)
    streamed = {i: [] for i, _, _ in REQUESTS}
    for i, p, n in REQUESTS:
        engine.submit(id=i, prompt=p, max_new_tokens=n)
    for _ in range(6):
        for event in engine.step():
            if event["type"] == "token":
                streamed[event["id"]].append(event["token"])
    summary = engine.drain()
    engine.journal.close()
    assert summary["blocks_in_use"] == 0 and summary["journaled"] == 3
    entries = port_journal.replay_journal(path)
    assert entries == jax_journal.replay_journal(path)
    assert [e["id"] for e in entries] == ["r0", "r1", "r2"]

    fresh = _engine(model)
    for entry in entries:
        assert entry["emitted"] == len(streamed[entry["id"]]) == len(entry["generated"])
        fresh.submit_resumed(entry)
    done = {}
    while not fresh.scheduler.idle:
        for event in fresh.step():
            if event["type"] == "token":
                streamed[event["id"]].append(event["token"])
            elif event["type"] == "done":
                done[event["id"]] = event["tokens"]
    assert done == full and streamed == full
    assert fresh.stats()["serve/replayed_requests"] == 3


def test_submit_resumed_pads_logprobs_and_retires_finished_entries():
    """A journal without logprobs pads them with None; an entry whose last
    token was journaled but not its done record ends at once."""
    engine = _engine(_model())
    assert engine.submit_resumed({"id": "x", "prompt": [1, 2], "generated": [4, 5, 6],
                                  "logprobs": [-1.0], "emitted": 9, "max_new_tokens": 8}) == []
    (request,) = engine.scheduler.waiting
    assert request.logprobs == [-1.0, None, None] and request.emitted == 3
    (done,) = engine.submit_resumed({"id": "y", "prompt": [1], "generated": [4, 5],
                                     "emitted": 2, "max_new_tokens": 2})
    assert done["stop_reason"] == "max_tokens" and done["tokens"] == [4, 5]
    assert done["generation"] == 0 and engine.replayed_requests == 2


# ---------------------------------------------------------------- the reload line


def _config(tmp_path: Path, package: str) -> Path:
    config = {
        "seed_everything": 7,
        "trainer": {"max_steps": 2, "checkpoint_every_n_steps": 2,
                    "checkpoint": {"dirpath": str(tmp_path / f"{package}-ckpt"),
                                   "async_save": False}},
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": {**TINY, "attention_impl": "xla"}},
            "optim": {"learning_rate": 1e-3}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 2, "max_length": 16, "num_samples": 8,
                               "vocab_size": 64}},
    }
    path = tmp_path / f"{package}.json"
    path.write_text(json.dumps(config))
    return path


LINES = [{"id": "r0", "prompt": [3, 4, 5]}, {"type": "reload"},
         {"id": "r1", "prompt": [6, 7]}, {"type": "reload", "ckpt_path": 99},
         {"id": "r2", "prompt": [8]}]

# fits 2 steps, then serves LINES from stdin (JSON is YAML to the JAX loader)
_JAX_SERVE = r"""
import io, json, sys
from llm_training_tpu.cli.main import main
config, lines = sys.argv[1], sys.argv[2]
assert main(["fit", "--config", config]) == 0
print("---serve---", flush=True)
sys.stdin = io.StringIO(lines)
sys.exit(main(["serve", "--config", config, "--max-new-tokens", "4"]))
"""


def _answers(records: list[dict]) -> dict:
    """What the reload lines changed: the answers to them, the generation
    each request finished under, the final gauge."""
    return {
        "weights": [r for r in records if r.get("type") == "weights"],
        "errors": [r["error"].split(":")[0] for r in records if r.get("type") == "error"],
        "done": {r["id"]: r["generation"] for r in records if r.get("type") == "done"
                 and r["id"] != "r0"},
        "generation": next(r for r in records if r.get("type") == "stats")["stats"][
            "serve/weights_generation"],
    }


def test_serve_reload_line_matches_jax(tmp_path):
    """`{"type": "reload"}` restores the newest checkpoint and bumps the
    generation (answered `{"type": "weights", "generation": 1}`); a reload
    of a missing step answers `reload failed` and the weights keep serving;
    requests after the reload finish under generation 1 — as the JAX
    `serve` answers the same lines on its own checkpoint."""
    stdin = "".join(json.dumps(line) + "\n" for line in LINES)
    env = {k: v for k, v in os.environ.items() if not k.startswith("LLMT_") and k != "XLA_FLAGS"}
    run = subprocess.run(
        [sys.executable, "-c", _JAX_SERVE, str(_config(tmp_path, "jax")), stdin],
        cwd=ROOT, env={**env, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    jax_records = [json.loads(line) for line in run.stdout.split("---serve---")[1].splitlines()
                   if line.startswith("{")]

    path = _config(tmp_path, "port")
    assert cli_main(["fit", "--config", str(path), "--device", "cpu"]) == 0
    args = build_parser().parse_args(["serve", "--config", str(path), "--device", "cpu",
                                      "--max-new-tokens", "4"])
    stdout = io.StringIO()
    assert run_serve(args, stdin=io.StringIO(stdin), stdout=stdout) == 0
    records = [json.loads(line) for line in stdout.getvalue().splitlines()]
    ours = _answers(records)
    assert ours == _answers(jax_records)
    assert ours["weights"] == [{"type": "weights", "generation": 1, "ckpt_path": None}]
    assert ours["errors"] == ["reload failed"] and ours["generation"] == 1.0
    assert ours["done"] == {"r1": 1, "r2": 1}
    assert all(r["generation"] == 1 for r in records if r.get("type") == "token"
               and r["id"] != "r0")
