"""Port parity of `serve`'s resilience tier on the CPU, against the JAX
package: the scheduler's load shedding on the same request sequences under
an injected clock (shed order, backpressure at submit, projected-TTFT
shedding, the service-time EMA), the engine shedding over a bounded queue,
the serve chaos triggers, `build_serve_argv`, the drain -> exit 75 ->
journal replay through both packages' `serve` on one checkpoint's weights,
and `supervise --child serve` over that SIGTERM."""

import io
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from llm_training_tpu.resilience import chaos as jax_chaos
from llm_training_tpu.resilience import supervisor as jax_supervisor
from llm_training_tpu.serve import ServeConfig as JaxServeConfig
from llm_training_tpu.serve import ServingEngine as JaxServingEngine
from llm_training_tpu.serve import scheduler as jax_scheduler
from llm_training_tpu.serve.paged_cache import BlockAllocator as JaxAllocator
from llm_training_tpu_torch.cli.main import build_parser, run_serve
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.lms.clm import CLM
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax, tree_from_flat
from llm_training_tpu_torch.resilience import chaos, supervisor
from llm_training_tpu_torch.resilience.elastic import ATTEMPT_ENV
from llm_training_tpu_torch.serve import scheduler
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.serve.journal import replay_journal
from llm_training_tpu_torch.serve.paged_cache import BlockAllocator
from test_torch_llama import TINY, jax_model_and_params, port_model

ROOT = Path(__file__).resolve().parent.parent

# ------------------------------------------------------------- the scheduler

PACKAGES = {"port": (scheduler, BlockAllocator), "jax": (jax_scheduler, JaxAllocator)}


class Clock:
    now = 0.0

    def __call__(self) -> float:
        return self.now


def _run_scheduler(package: str, config: dict, ops: list[tuple]) -> dict:
    """Drive one package's scheduler through `ops` (`time.perf_counter` is
    the caller's `Clock`) and report what it did."""
    module, allocator = PACKAGES[package]
    sched = module.Scheduler(module.SchedulerConfig(**config), allocator(16 + 1))
    for op in ops:
        if op[0] == "submit":
            _, rid, priority, arrival = op
            sched.submit(module.ServeRequest(id=rid, prompt=[1, 2], max_new_tokens=4,
                                             priority=priority, arrival_s=arrival))
        elif op[0] == "tick":
            Clock.now = op[1]
        elif op[0] == "finish":
            running = {r.id: r for r in sched.running.values()}
            sched.finish(running[op[1]], op[2])
        else:
            getattr(sched, op[0])()
    return {
        "completed": [(r.id, r.stop_reason) for r in sched.completed],
        "waiting": [r.id for r in sched.waiting],
        "running": sorted(r.id for r in sched.running.values()),
        "shed_total": sched.shed_total,
        "ema": sched._service_ema_s,
        "projected": [sched.projected_ttft_ms(i) for i in range(-1, 5)],
    }


SEQUENCES = {
    # one slot, queue bound 1: each submit while saturated sheds the
    # lowest-priority (then youngest) queued request, the eviction order
    "shed_order_backpressure": (dict(max_batch=1, max_queue=1), [
        ("tick", 0.0), ("submit", "run", 0, 0.0), ("admit",),
        ("submit", "q1", 0, 1.0), ("submit", "q2", 1, 2.0), ("submit", "q3", 0, 3.0),
        ("submit", "q4", -1, 4.0), ("submit", "q5", 2, 5.0), ("shed",),
    ]),
    # with a slot free nothing is shed at submit, even over the bound; the
    # step's admit + shed pass decides
    "free_slot_no_shed_at_submit": (dict(max_batch=2, max_queue=0), [
        ("submit", "a", 0, 0.0), ("submit", "b", 0, 1.0), ("submit", "c", 0, 2.0),
        ("admit",), ("shed",),
    ]),
    # a full completion seeds the EMA (failures never feed it); a queue tail
    # projecting past shed_ttft_ms is shed until it fits
    "projected_ttft_and_ema": (dict(max_batch=2, shed_ttft_ms=1500.0), [
        ("tick", 0.0), ("submit", "s0", 0, 0.0), ("admit",), ("shed",),
        ("tick", 1.0), ("finish", "s0", "max_tokens"),
        ("submit", "r0", 0, 2.0), ("submit", "r1", 1, 3.0), ("submit", "r2", 0, 4.0),
        ("submit", "r3", 0, 5.0), ("submit", "r4", -1, 6.0), ("submit", "r5", 0, 7.0),
        ("shed",), ("admit",), ("tick", 9.0), ("finish", "r1", "deadline"),
        ("tick", 12.0), ("finish", "r0", "max_tokens"), ("shed",),
    ]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_shedding_decisions_match_jax(monkeypatch, name):
    config, ops = SEQUENCES[name]
    config = dict(max_model_len=32, block_size=8, prefill_chunk=4, **config)
    monkeypatch.setattr(time, "perf_counter", Clock())
    Clock.now = 0.0
    ours = _run_scheduler("port", config, ops)
    Clock.now = 0.0
    theirs = _run_scheduler("jax", config, ops)
    assert ours == theirs
    if name == "shed_order_backpressure":
        # each submit over the bound sheds the lowest priority queued (the
        # youngest among ties): q1 under q2, the newcomer q3, q4 (-1), then
        # q2 under q5
        assert ours["completed"] == [("q1", "overloaded"), ("q3", "overloaded"),
                                     ("q4", "overloaded"), ("q2", "overloaded")]
        assert ours["waiting"] == ["q5"] and ours["shed_total"] == 4
    elif name == "free_slot_no_shed_at_submit":
        assert ours["running"] == ["a", "b"] and ours["completed"] == [("c", "overloaded")]
    else:
        # s0 served 1.0 s; r0 (arrival 2.0) done at 12.0 -> 0.8 * 1.0 + 0.2 * 10.0
        assert ours["ema"] == pytest.approx(2.8)
        assert ("r4", "overloaded") in ours["completed"] and ours["shed_total"] == 4


# ------------------------------------------------------------------ the engine

SERVE = dict(max_model_len=48, block_size=8, prefill_chunk=4, eos_token_id=None)


@pytest.mark.parametrize("max_batch,max_queue", [(1, 0), (2, 1)])
def test_engine_sheds_over_bounded_queue_like_jax(max_batch, max_queue):
    """Both engines, the same weights and requests: the same terminals
    (ids, stop reasons, tokens) and the same `shed_total`."""
    jax_model, variables, params = jax_model_and_params(True)
    config = dict(SERVE, max_batch=max_batch, max_queue=max_queue)
    engines = (JaxServingEngine(jax_model, variables, JaxServeConfig(**config)),
               ServingEngine(port_model(params), ServeConfig(**config), device="cpu"))
    requests = [("a", [3, 17], 0), ("b", [5, 9], 1), ("c", [7, 1, 2], 0), ("d", [4], -1),
                ("e", [8, 8], 2)]
    results = []
    for engine in engines:
        events = []
        for rid, prompt, priority in requests:
            events += engine.submit(rid, prompt, max_new_tokens=4, priority=priority)
        while not engine.scheduler.idle:
            events += engine.step()
        done = [(e["id"], e["stop_reason"], e["tokens"]) for e in events if e["type"] == "done"]
        results.append((done, engine.stats()["serve/shed_total"]))
    assert results[0] == results[1]
    done, shed = results[1]
    assert shed > 0 and sorted(d[0] for d in done) == list("abcde")
    assert {d[1] for d in done} == {"max_tokens", "overloaded"}
    live = engines[1].live_stats()
    assert live["serve/requests_shed"] == shed and live["serve/queue_depth"] == 0


# ------------------------------------------------------------------ chaos


def test_chaos_serve_env_overlay_matches_jax(monkeypatch):
    monkeypatch.setenv("LLMT_CHAOS_SERVE_STALL_STEP", "4")
    monkeypatch.setenv("LLMT_CHAOS_SERVE_SIGTERM_STEP", "6")
    monkeypatch.setenv("LLMT_CHAOS_SERVE_MALFORMED_FLOOD", "3")
    ours, theirs = chaos.config_from_env(), jax_chaos.config_from_env()
    for key in ("serve_stall_step", "serve_sigterm_step", "serve_malformed_flood"):
        assert getattr(ours, key) == getattr(theirs, key)
    assert (ours.serve_stall_step, ours.serve_sigterm_step, ours.serve_malformed_flood) == (4, 6, 3)
    assert ours.any_active() and theirs.any_active()


class _Registry:
    def counter(self, name):
        return type("C", (), {"inc": lambda self: None})()


@pytest.mark.parametrize("attempt", ["1", "2"])
def test_chaos_serve_faults_fire_once_first_attempt_only_like_jax(monkeypatch, attempt):
    monkeypatch.setenv(ATTEMPT_ENV, attempt)
    observed = []
    for module in (chaos, jax_chaos):
        slept = []
        harness = module.Chaos(module.ChaosConfig(serve_stall_step=3, serve_malformed_flood=5),
                               registry=_Registry())
        fired = [harness.maybe_serve_stall(step, sleep=slept.append) for step in (2, 3, 3)]
        observed.append((fired, slept, harness.serve_malformed_lines()))
    assert observed[0] == observed[1]
    if attempt == "1":
        assert observed[0][0] == [False, True, False] and observed[0][1] == [3600.0]
        assert len(observed[0][2]) == 5
    else:
        assert observed[0] == ([False, False, False], [], [])


def test_chaos_serve_sigterm_delivers_a_real_signal(monkeypatch):
    monkeypatch.setenv(ATTEMPT_ENV, "1")
    received = []
    previous = signal.signal(signal.SIGTERM, lambda s, f: received.append(s))
    try:
        harness = chaos.Chaos(chaos.ChaosConfig(serve_sigterm_step=2), registry=_Registry())
        assert not harness.maybe_serve_sigterm_mid_stream(1)
        assert harness.maybe_serve_sigterm_mid_stream(2)
        assert not harness.maybe_serve_sigterm_mid_stream(2)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert received == [signal.SIGTERM]


@pytest.mark.parametrize("serve_args,ckpt_path", [
    ([], None), (["--device", "cpu", "--max-queue", "4", "a.b=1"], "7"),
])
def test_build_serve_argv_matches_jax(serve_args, ckpt_path):
    ours = supervisor.build_serve_argv("run.json", serve_args, ckpt_path=ckpt_path)
    theirs = jax_supervisor.build_serve_argv("run.json", serve_args, ckpt_path=ckpt_path)
    assert ours[:4] == [sys.executable, "-m", "llm_training_tpu_torch", "serve"]
    assert theirs[:4] == [sys.executable, "-m", "llm_training_tpu", "serve"]
    assert ours[4:] == theirs[4:]


# ------------------------------------------------- drain, exit 75, replay

SIGTERM_STEP = 4
FLAGS = ["--max-batch", "2", "--max-model-len", "48", "--prefill-chunk", "4",
         "--block-size", "8", "--max-new-tokens", "8", "--drain-timeout-s", "0"]
LINES = [{"type": "profile", "tag": "x"}, {"id": "r0", "prompt": [3, 17, 42, 7, 11]},
         {"id": "r1", "prompt": [5, 9]}, {"id": "r2", "prompt": [1, 2, 3]}]
STDIN = "".join(json.dumps(line) + "\n" for line in LINES)

# fits 1 step at learning rate 0, dumps the restored parameters, then serves
# STDIN under a chaos SIGTERM; prints the exit code and the journal
_JAX_SERVE = r"""
import io, json, sys
import jax, numpy as np
from llm_training_tpu.cli.main import main
from llm_training_tpu.trainer import trainer
config, lines, out, flags = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
real = trainer.Trainer.restore_for_inference
def restore(self, objective, step=None):
    state = real(self, objective, step)
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))[0]
    np.savez(out, **{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                     for path, v in leaves})
    return state
trainer.Trainer.restore_for_inference = restore
assert main(["fit", "--config", config]) == 0
print("---serve---", flush=True)
sys.stdin = io.StringIO(lines)
rc = main(["serve", "--config", config, *flags])
print("---rc--- " + str(rc), flush=True)
"""


def _config(root: Path, package: str, run_name: str) -> Path:
    config = {
        "seed_everything": 7,
        "trainer": {
            "max_steps": 1,
            "checkpoint": {"dirpath": str(root / f"{package}-ckpt"), "async_save": False},
            "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                         "init_args": {"save_dir": str(root / package), "project": "p",
                                       "name": run_name}}],
        },
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": {**TINY, "attention_impl": "xla"}},
            "optim": {"learning_rate": 0.0}}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {"batch_size": 2, "max_length": 16, "num_samples": 4,
                               "vocab_size": TINY["vocab_size"]}},
    }
    path = root / f"{package}-{run_name}.json"
    path.write_text(json.dumps(config))
    return path


def _records(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _journal(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _split_logprobs(records: list[dict]) -> tuple[list[str], list[float]]:
    """Each record without its logprobs (as canonical JSON, order-free: the
    stdin reader's delivery records interleave with the loop's either way),
    and the logprobs in one list."""
    bare, logprobs = [], []
    for record in records:
        record = dict(record)
        logprobs += [v for v in record.pop("logprobs", None) or [] if v is not None]
        bare.append(json.dumps(record, sort_keys=True))
    return sorted(bare), logprobs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX `serve` under a chaos SIGTERM on its checkpoint (a JAX
    subprocess), and the port's checkpoint of the same parameters (a port
    `fit` at learning rate 0 from them)."""
    root = tmp_path_factory.mktemp("serve-resilience")
    jax_cfg = _config(root, "jax", "run")
    env = {k: v for k, v in os.environ.items() if not k.startswith("LLMT_") and k != "XLA_FLAGS"}
    run = subprocess.run(
        [sys.executable, "-c", _JAX_SERVE, str(jax_cfg), STDIN, str(root / "params.npz"),
         json.dumps(FLAGS)], cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
             "LLMT_CHAOS_SERVE_SIGTERM_STEP": str(SIGTERM_STEP)},
        capture_output=True, text=True, timeout=300)
    assert "---rc--- 75" in run.stdout, run.stdout[-2000:] + run.stderr[-3000:]
    jax_run = root / "jax" / "p" / "run"
    with np.load(root / "params.npz") as flat:
        tree = tree_from_flat(flat)
    real = CLM.configure_model

    def configure_model(self, device, generator):
        model = real(self, device, generator)
        model.load_state_dict(state_dict_from_jax(tree, model.config))
        return model

    CLM.configure_model = configure_model
    try:
        assert cli_main(["fit", "--config", str(_config(root, "port", "base")),
                         "--device", "cpu"]) == 0
    finally:
        CLM.configure_model = real
    return {"root": root, "jax_records": _records(run.stdout.split("---serve---")[1]),
            "jax_journal": _journal(jax_run / "serve-journal.jsonl"),
            "jax_backup_gone": not (jax_run / "serve-journal.replaying.jsonl").exists()}


def _serve(config: Path, stdin: str) -> tuple[int, list[dict]]:
    args = build_parser().parse_args(["serve", "--config", str(config), "--device", "cpu",
                                      *FLAGS])
    stdout = io.StringIO()
    rc = run_serve(args, stdin=io.StringIO(stdin), stdout=stdout)
    return rc, _records(stdout.getvalue())


def _tokens(records: list[dict]) -> dict[str, list[int]]:
    streams: dict[str, list[int]] = {}
    for record in records:
        if record.get("type") == "token":
            streams.setdefault(record["id"], []).append(record["token"])
    return streams


def test_drain_exit_75_and_replay_match_jax(served, monkeypatch):
    """A chaos SIGTERM at the same engine step: both `serve`s drain (budget
    0), journal every request and exit 75 without a terminal; the journals
    hold the same records (logprobs within 1e-5); the profile line is
    answered as JAX's. The relaunch replays before stdin and its streams,
    joined to the first run's, equal an uninterrupted run token for token,
    with one terminal a request."""
    root = served["root"]
    baseline_rc, baseline = _serve(_config(root, "port", "base"), STDIN)
    assert baseline_rc == 0
    full = {r["id"]: r["tokens"] for r in baseline if r.get("type") == "done"}
    assert sorted(full) == ["r0", "r1", "r2"] and all(len(t) == 8 for t in full.values())

    config = _config(root, "port", "run")
    monkeypatch.setenv("LLMT_CHAOS_SERVE_SIGTERM_STEP", str(SIGTERM_STEP))
    rc, first = _serve(config, STDIN)
    assert rc == 75
    jax_records = served["jax_records"]
    profile = [r for r in first if r.get("type") == "profile"]
    assert profile == [r for r in jax_records if r.get("type") == "profile"]
    assert profile == [{"type": "profile", "accepted": True, "reason": None, "tag": "x"}]
    assert not [r for r in first if r.get("type") == "done"]
    assert not [r for r in jax_records if r.get("type") == "done"]
    assert _tokens(first) == _tokens(jax_records) and _tokens(first)

    run_dir = root / "port" / "p" / "run"
    journal = _journal(run_dir / "serve-journal.jsonl")
    ours, ours_lp = _split_logprobs(journal)
    theirs, theirs_lp = _split_logprobs(served["jax_journal"])
    assert ours == theirs
    np.testing.assert_allclose(ours_lp, theirs_lp, atol=1e-5, rtol=0)
    assert sorted(e["id"] for e in replay_journal(run_dir / "serve-journal.jsonl")) == [
        "r0", "r1", "r2"]
    assert (run_dir / "profile-x.json").exists() and served["jax_backup_gone"]

    monkeypatch.delenv("LLMT_CHAOS_SERVE_SIGTERM_STEP")
    rc, second = _serve(config, "")
    assert rc == 0
    done = [r for r in second if r.get("type") == "done"]
    assert sorted(r["id"] for r in done) == ["r0", "r1", "r2"]
    joined = {rid: _tokens(first).get(rid, []) + _tokens(second).get(rid, []) for rid in full}
    assert joined == full and {r["id"]: r["tokens"] for r in done} == full
    stats = next(r["stats"] for r in second if r.get("type") == "stats")
    assert stats["serve/replayed_requests"] == 3
    assert not (run_dir / "serve-journal.jsonl").exists()
    assert not (run_dir / "serve-journal.replaying.jsonl").exists()


def test_supervise_child_serve_relaunches_into_the_replay(served):
    """`supervise --child serve` on the CPU over a chaos SIGTERM: the child
    exits 75, the relaunch (attempt 2, where serve chaos is inert) replays
    the journal and finishes, one terminal a request."""
    root = served["root"]
    config = _config(root, "port", "sup")
    env = {k: v for k, v in os.environ.items() if not k.startswith("LLMT_")}
    run = subprocess.run(
        [sys.executable, "-m", "llm_training_tpu_torch", "supervise", "--config", str(config),
         "--child", "serve", "--backoff-base-s", "0",
         "--child-args", " ".join(["--device", "cpu", *FLAGS])],
        cwd=ROOT, input=STDIN, capture_output=True, text=True, timeout=300,
        env={**env, "PYTHONPATH": str(ROOT), "LLMT_CHAOS_SERVE_SIGTERM_STEP": str(SIGTERM_STEP)})
    assert run.returncode == 0, run.stderr[-3000:]
    records = _records(run.stdout)
    done = [r for r in records if r.get("type") == "done"]
    assert sorted(r["id"] for r in done) == ["r0", "r1", "r2"]
    assert all(r["stop_reason"] == "max_tokens" and r["n_tokens"] == 8 for r in done)
    events = [json.loads(line) for line in
              (root / "port" / "p" / "sup" / "supervisor.jsonl").read_text().splitlines()]
    assert [e["rc"] for e in events if e["event"] == "exit"] == [75, 0]
    stats = [r["stats"] for r in records if r.get("type") == "stats"]
    assert [s["serve/replayed_requests"] for s in stats] == [0.0, 3.0]
