"""Port parity of the tracer on the CPU (`telemetry/trace.py`), against the
JAX package's: one event sequence on a fake clock exports to the same
Chrome trace and summary, a trace written by either package reads through
either, the ring, sampling, sink gating, torn tails and flight dumps behave
as JAX's, a request's queue/prefill/decode spans tile its wall clock across
an eviction, and the `trace` command's exit codes."""

import json
from pathlib import Path

import pytest

from llm_training_tpu.telemetry import trace as jax_trace
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from llm_training_tpu_torch.telemetry import trace
from test_torch_llama import jax_model_and_params, port_model

MODULES = {"port": trace, "jax": jax_trace}


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _record(module, clock: FakeClock, sink: Path | None = None):
    """One serving sequence: two requests, one evicted and resumed, engine
    steps, a shed terminal, a train span and a resilience instant."""
    tracer = module.TraceRecorder(capacity=64, sample_every=1, enabled=True, clock=clock)
    if sink is not None:
        assert tracer.attach_sink(sink)
    events = [
        ("instant", "serve", "submit", dict(request_id="a", prompt_len=5)),
        ("instant", "serve", "submit", dict(request_id="b", prompt_len=2)),
        ("span", "serve", "queue", 0.010, dict(request_id="a", residency=0)),
        ("span", "serve", "prefill", 0.020, dict(request_id="a", residency=0)),
        ("instant", "serve", "first_token", dict(request_id="a", ttft_ms=30.0)),
        ("span", "serve", "engine_step", 0.005, dict(step=1, running=1, waiting=1)),
        ("span", "serve", "decode", 0.040, dict(request_id="a", residency=0)),
        ("instant", "serve", "evicted", dict(request_id="a", lost_cache_tokens=7)),
        ("span", "serve", "queue", 0.015, dict(request_id="a", residency=1)),
        ("span", "serve", "prefill", 0.008, dict(request_id="a", residency=1)),
        ("span", "serve", "decode", 0.030, dict(request_id="a", residency=1)),
        ("instant", "serve", "done", dict(request_id="a", stop_reason="max_tokens", n_tokens=8)),
        ("span", "serve", "queue", 0.120, dict(request_id="b", residency=0)),
        ("instant", "serve", "shed", dict(request_id="b", phase="queue")),
        ("instant", "serve", "done", dict(request_id="b", stop_reason="overloaded", n_tokens=0)),
        ("span", "train", "train_step", 0.5, dict(step=3)),
        ("instant", "resilience", "rollback", dict(step=3)),
    ]
    for kind, cat, name, *rest in events:
        if kind == "span":
            duration, args = rest
            t0 = clock.now
            clock.now += duration
            tracer.span(cat, name, t0, clock.now, **args)
        else:
            clock.now += 0.001
            tracer.instant(cat, name, **rest[0])
    tracer.detach_sink()
    return tracer


def test_export_and_summary_match_jax(tmp_path):
    recorders = {name: _record(module, FakeClock()) for name, module in MODULES.items()}
    events = {name: r.snapshot() for name, r in recorders.items()}
    assert events["port"] == events["jax"]
    assert trace.to_chrome_trace(events["port"]) == jax_trace.to_chrome_trace(events["jax"])
    ours = trace.summarize_trace(events["port"])
    assert ours == jax_trace.summarize_trace(events["jax"])
    assert ours["terminal_reasons"] == {"max_tokens": 1, "overloaded": 1}
    (slowest,) = ours["slowest_requests"]
    assert slowest["id"] == "a" and slowest["evictions"] == 1
    assert slowest["queue_ms"] == pytest.approx(25.0) and slowest["decode_ms"] == pytest.approx(70.0)
    assert recorders["port"].counts() == recorders["jax"].counts()


def test_a_trace_written_by_either_package_reads_through_the_other(tmp_path):
    paths = {}
    for name, module in MODULES.items():
        paths[name] = tmp_path / name / "trace.jsonl"
        _record(module, FakeClock(), sink=paths[name])
    for path in paths.values():
        ours, theirs = trace.read_trace_events(path), jax_trace.read_trace_events(path)
        assert ours == theirs and ours[0]["name"] == "clock_anchor"
        assert trace.to_chrome_trace(ours) == jax_trace.to_chrome_trace(theirs)
    # the files differ only in the anchor's wall/monotonic/pid sample
    strip = [[e for e in trace.read_trace_events(p) if e["cat"] != "meta"] for p in paths.values()]
    assert strip[0] == strip[1] and len(strip[0]) == 17


def test_ring_sampling_and_sink_gating_match_jax(tmp_path, monkeypatch):
    for name, module in MODULES.items():
        tracer = module.TraceRecorder(capacity=4, sample_every=3, enabled=True)
        for i in range(10):
            tracer.instant("serve", "e", step=i)
        assert [e["args"]["step"] for e in tracer.snapshot()] == [6, 7, 8, 9], name
        assert [tracer.sample_request() for _ in range(7)] == [True, False, False] * 2 + [True]
        path = tmp_path / f"{name}.jsonl"
        assert tracer.attach_sink(path) and not tracer.attach_sink(tmp_path / "other.jsonl")
        tracer.instant("serve", "kept", write=True)
        tracer.instant("serve", "ring_only", write=False)
        tracer.detach_sink()
        names = [e["name"] for e in module.read_trace_events(path)]
        assert names == ["clock_anchor", "kept"], name
        assert tracer.counts() == {"recorded": 13, "written": 2, "flight_dumps": 0,
                                   "requests_seen": 7, "requests_sampled": 3}
        monkeypatch.setenv("LLMT_TRACE", "0")
        off = module.TraceRecorder()
        off.instant("serve", "e")
        assert off.snapshot() == [] and not off.attach_sink(tmp_path / f"{name}-off.jsonl")
        monkeypatch.setenv("LLMT_TRACE_RING", "3")
        monkeypatch.setenv("LLMT_TRACE_SAMPLE", "junk")
        monkeypatch.delenv("LLMT_TRACE")
        env = module.TraceRecorder()
        assert (env.capacity, env.sample_every, env.enabled) == (3, 1, True)
        monkeypatch.delenv("LLMT_TRACE_RING")
        monkeypatch.delenv("LLMT_TRACE_SAMPLE")


def test_torn_tails_and_flight_dumps_match_jax(tmp_path):
    path = tmp_path / "trace.jsonl"
    _record(trace, FakeClock(), sink=path)
    with open(path, "a") as f:
        f.write('["not", "a", "record"]\n{"ts": 1.0}\n{"ts": 2.0, "name": "torn", "ca')
    assert trace.read_trace_events(path) == jax_trace.read_trace_events(path)
    assert len(trace.read_trace_events(path)) == 18
    assert trace.read_trace_events(tmp_path / "absent.jsonl") == []
    for name, module in MODULES.items():
        tracer = _record(module, FakeClock())
        dump = tracer.flight_dump(tmp_path / name, "hang-1")
        assert dump == tmp_path / name / "trace-flight-hang-1.jsonl"
        events = module.read_trace_events(dump)
        assert events[0]["name"] == "clock_anchor" and events[1:] == tracer.snapshot()
        assert tracer.counts()["flight_dumps"] == 1
    # a dump that cannot be written returns None and never raises
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert trace.TraceRecorder().flight_dump(blocker / "sub", "t") is None


def test_spans_tile_each_request_across_an_eviction():
    """A pool of 4 blocks under 3 requests of 12 prompt tokens + 10 new:
    block pressure evicts; every request's queue/prefill/decode spans sum to
    its submit-to-done wall clock within 50 ms, the evicted one over two
    residencies."""
    _, _, params = jax_model_and_params(True)
    tracer = trace.TraceRecorder(capacity=4096, sample_every=1, enabled=True)
    previous = trace.set_tracer(tracer)
    try:
        engine = ServingEngine(port_model(params), ServeConfig(
            max_batch=2, max_model_len=48, block_size=8, num_blocks=4, prefill_chunk=4,
            eos_token_id=None), device="cpu")
        events = engine.run([{"id": f"r{i}", "prompt": list(range(3, 15)), "max_new_tokens": 10}
                             for i in range(3)])
    finally:
        trace.set_tracer(previous)
    assert engine.scheduler.evictions > 0
    assert sorted(e["id"] for e in events if e["type"] == "done") == ["r0", "r1", "r2"]
    recorded = tracer.snapshot()
    for rid in ("r0", "r1", "r2"):
        mine = [e for e in recorded if (e.get("args") or {}).get("request_id") == rid]
        submit = next(e["ts"] for e in mine if e["name"] == "submit")
        done = next(e["ts"] for e in mine if e["name"] == "done")
        phases = [e for e in mine if e["ph"] == "X" and e["name"] in trace.REQUEST_PHASES]
        assert abs(sum(e["dur"] for e in phases) - (done - submit)) < 0.05, rid
        # each span starts where the previous one ended
        for before, after in zip(phases, phases[1:]):
            assert after["ts"] == pytest.approx(before["ts"] + before["dur"], abs=1e-9)
    evicted = [e["args"]["request_id"] for e in recorded if e["name"] == "evicted"]
    assert evicted and sum(
        1 for e in recorded if e["name"] == "queue" and e["args"]["request_id"] == evicted[0]) >= 2
    summary = trace.summarize_trace(recorded)
    assert summary["requests_completed"] == 3 and summary["terminal_reasons"] == {"max_tokens": 3}


def test_serve_under_llmt_trace_0_records_nothing(tmp_path, monkeypatch):
    """`serve` in a process whose tracer comes from `LLMT_TRACE=0` records
    no event, samples no request and reports 0 in its stats record; the
    same requests with the default environment record (the control)."""
    import io

    from llm_training_tpu_torch.cli.main import build_parser, run_serve

    model = tmp_path / "tiny.json"
    model.write_text(json.dumps(dict(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, compute_dtype="float32",
        param_dtype="float32")))
    lines = "".join(json.dumps({"id": f"r{i}", "prompt": [1, 2, 3 + i]}) + "\n" for i in range(3))
    counts = {}
    for flag in ("0", None):
        if flag is None:
            monkeypatch.delenv("LLMT_TRACE", raising=False)
        else:
            monkeypatch.setenv("LLMT_TRACE", flag)
        previous = trace.set_tracer(None)  # the next get_tracer() reads the env
        try:
            args = build_parser().parse_args(["serve", "--model-config", str(model),
                                              "--device", "cpu", "--max-new-tokens", "3"])
            stdout = io.StringIO()
            assert run_serve(args, stdin=io.StringIO(lines), stdout=stdout) == 0
            counts[flag] = trace.get_tracer().counts()
        finally:
            trace.set_tracer(previous)
        records = [json.loads(line) for line in stdout.getvalue().splitlines()]
        assert sum(r["type"] == "done" for r in records) == 3
        stats = records[-1]["stats"]
        assert stats["trace/events_recorded"] == counts[flag]["recorded"]
    assert counts["0"]["recorded"] == counts["0"]["requests_sampled"] == 0
    assert counts[None]["recorded"] > 0 and counts[None]["requests_sampled"] == 3


def test_trace_command_exit_codes_match_jax(tmp_path, capsys):
    """Exit 2 when the source is absent or holds no event, 0 with a
    Chrome-trace export beside it; `--merge` aligns two anchored runs."""
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "trace.jsonl").write_text("not json\n")
    for source in (tmp_path / "absent", empty):
        assert cli_main(["trace", str(source)]) == 2
        assert jax_trace.trace_main(str(source)) == 2
    assert cli_main(["trace"]) == 2
    runs = []
    for name, module in MODULES.items():
        run = tmp_path / name
        _record(module, FakeClock(), sink=run / "trace.jsonl")
        runs.append(run)
    assert cli_main(["trace", str(runs[0]), "--out", str(tmp_path / "port.json")]) == 0
    assert jax_trace.trace_main(str(runs[0]), out=str(tmp_path / "jax.json")) == 0
    ours = json.loads((tmp_path / "port.json").read_text())
    assert ours == json.loads((tmp_path / "jax.json").read_text())
    assert {e["args"]["name"] for e in ours["traceEvents"] if e["name"] == "thread_name"} >= {
        "req a", "req b", "engine"}
    assert cli_main(["trace", "--merge", *map(str, runs)]) == 0
    merged = json.loads((runs[0] / "trace-merged.json").read_text())
    labels = {e["args"]["name"] for e in merged["traceEvents"] if e["name"] == "process_name"}
    assert {"port/serve", "jax/serve"} <= labels
    assert "exported 18 events" in capsys.readouterr().out  # 17 and the anchor
