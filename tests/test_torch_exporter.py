"""Port parity of the live-telemetry tier on the CPU, against the JAX
package: the `/metrics` text, `parse_prometheus_text`, `/healthz` against
the watchdog's beat, `/statusz`, the `LLMT_METRICS_PORT` switch, a port
collision, `watch --once` and `profile`; the SLO monitor's burn-rate
breaches on one observation sequence; the profile trigger's budget and
cooldown, its `torch.profiler` capture and manifest; and `serve`'s
`{"type": "profile"}` line (C.26)."""

import io
import json
import logging
import math
import socket
import time
from pathlib import Path

import pytest

from llm_training_tpu.resilience import watchdog as jax_watchdog
from llm_training_tpu.telemetry import exporter as jax_exporter
from llm_training_tpu.telemetry import profiling as jax_profiling
from llm_training_tpu.telemetry import registry as jax_registry
from llm_training_tpu.telemetry import slo as jax_slo
from llm_training_tpu_torch.cli.main import build_parser, run_serve
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.resilience import watchdog
from llm_training_tpu_torch.telemetry import exporter, profiling, registry, slo
from test_torch_llama import TINY

PACKAGES = {
    "port": (exporter, registry, slo, profiling, watchdog),
    "jax": (jax_exporter, jax_registry, jax_slo, jax_profiling, jax_watchdog),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _fill(module) -> object:
    reg = module.TelemetryRegistry(clock=FakeClock())
    reg.counter("exporter/scrapes").inc(3)
    reg.counter("serve/odd name-with.chars").inc()
    reg.gauge("serve/queue_depth").set(4.0)
    reg.gauge("hbm/nan").set(math.nan)
    reg.gauge("hbm/inf").set(math.inf)
    reg.gauge("never/set")
    with reg.timer("data/wait").time():
        pass
    return reg


def test_metrics_text_is_byte_equal_to_jax():
    texts = []
    for name, (exp, reg_module, *_) in PACKAGES.items():
        reg = _fill(reg_module)
        values, kinds = reg.snapshot_with_kinds()
        assert values == reg.snapshot()
        exporter_ = exp.MetricsExporter(0, registry=reg, clock=FakeClock(5.0),
                                        extra_fn=lambda: {"serve/running": 2.0})
        texts.append((exp.render_prometheus(values, kinds), exporter_.render_metrics()))
    assert texts[0] == texts[1]
    parsed = exporter.parse_prometheus_text(texts[0][1])
    assert parsed["llmt_serve_queue_depth"] == 4.0 and parsed["llmt_serve_running"] == 2.0
    assert "# TYPE llmt_exporter_scrapes counter" in texts[0][1]
    assert math.isnan(parsed["llmt_hbm_nan"]) and "llmt_never_set" not in parsed


PARSE_CASES = [
    ("# TYPE llmt_a gauge\nllmt_a 1.5\nllmt_b +Inf\n", False),
    ("llmt_x 1.0 1699999999\n", False),
    ("llmt_x\n", False),
    ("llmt_x junk\n", False),
    ("9bad_name 1.0\n", False),
    ("# COMMENT not a type line\nllmt_x 1.0\n", False),
    ("", False),
    ('llmt_q{replica="a",role="serve"} 3.0\nllmt_n 1.0\n', False),
    ('llmt_q{replica="a",role="serve"} 3.0\nllmt_n 1.0\n', True),
    ('llmt_x{replica="a",} 1.0\n', True),
    ("llmt_x{} 1.0\n", True),
]


@pytest.mark.parametrize("text,labels", PARSE_CASES)
def test_parse_prometheus_text_accepts_and_refuses_as_jax(text, labels):
    outcomes = []
    for module in (exporter, jax_exporter):
        try:
            outcomes.append(("ok", module.parse_prometheus_text(text, labels=labels)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_healthz_turns_red_at_half_the_watchdog_window_and_rearms():
    results = []
    for name, (exp, *_, wd_module) in PACKAGES.items():
        clock = FakeClock(100.0)
        dog = wd_module.HangWatchdog(10.0, clock=clock, primary_source="engine_step")
        exporter_ = exp.MetricsExporter(0, watchdog=dog, clock=clock)
        seen = [exporter_.health()]  # no beat yet: healthy, no age
        dog.beat(step=1)
        for now in (104.0, 105.5):
            clock.t = now
            seen.append(exporter_.health())
        dog.beat(step=2)
        seen.append(exporter_.health())
        results.append(seen)
    assert results[0] == results[1]
    assert [healthy for healthy, _ in results[0]] == [True, True, False, True]
    assert "no engine_step heartbeat for 5.5s" in results[0][2][1]["reason"]
    # and over HTTP
    dog = watchdog.HangWatchdog(4.0, primary_source="engine_step")
    dog.beat()
    exporter_ = exporter.MetricsExporter(0, watchdog=dog, host="127.0.0.1")
    assert exporter_.start()
    try:
        assert _get(exporter_.port, "/healthz")[0] == 200
        time.sleep(2.1)
        code, body = _get(exporter_.port, "/healthz")
        assert code == 503 and json.loads(body)["status"] == "unhealthy"
        dog.beat()
        assert _get(exporter_.port, "/healthz")[0] == 200
        assert _get(exporter_.port, "/nope")[0] == 404
    finally:
        exporter_.stop()


def _get(port: int, path: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5.0) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_statusz_matches_jax(tmp_path):
    pages = []
    for name, (exp, reg_module, slo_module, _, wd_module) in PACKAGES.items():
        clock = FakeClock(10.0)
        dog = wd_module.HangWatchdog(30.0, clock=clock, primary_source="engine_step")
        dog.beat()
        clock.t = 12.5
        monitor = slo_module.SLOMonitor(
            slo_module.specs_from_config({"serve": {"error_rate": 0.1}}), clock=clock,
            fast_window_s=10, slow_window_s=10, fast_burn=1.0, slow_burn=1.0, min_events=2,
            cooldown_s=0)
        for _ in range(3):
            monitor.observe_request(ok=False)
        exporter_ = exp.MetricsExporter(
            0, registry=reg_module.TelemetryRegistry(), watchdog=dog, slo=monitor, clock=clock,
            status_fn=lambda: {"engine step": 7, "queue depth": 2})
        pages.append(exporter_.render_statusz())
    assert pages[0] == pages[1]
    assert "watchdog: beat 2.5s ago (timeout 30.0s)" in pages[0]
    assert "engine step: 7" in pages[0] and "last alert: serve/error_rate" in pages[0]


@pytest.mark.parametrize("raw", ["", "0", "junk", "-5", "9400"])
def test_metrics_port_switch_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("LLMT_METRICS_PORT", raw)
    assert exporter.resolve_metrics_port() == jax_exporter.resolve_metrics_port()
    if raw != "9400":
        assert exporter.start_exporter() is None


def test_port_collision_only_warns(caplog):
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    try:
        with caplog.at_level(logging.WARNING):
            assert exporter.start_exporter(port=holder.getsockname()[1],
                                           host="127.0.0.1") is None
    finally:
        holder.close()
    assert "metrics exporter disabled" in caplog.text


def test_watch_once_and_profile_commands(capsys):
    trigger = profiling.ProfileTrigger(budget=1, cooldown_s=0.0)
    exporter_ = exporter.MetricsExporter(0, profile=trigger, host="127.0.0.1",
                                         status_fn=lambda: {"queue depth": 3})
    assert exporter_.start()
    try:
        port = str(exporter_.port)
        assert cli_main(["watch", "--once", "--port", port]) == 0
        assert "queue depth: 3" in capsys.readouterr().out
        assert cli_main(["profile", "--port", port, "--tag", "one"]) == 0
        assert json.loads(capsys.readouterr().out)["tag"] == "one"
        assert cli_main(["profile", "--port", port]) == 3  # still pending: busy
        assert json.loads(capsys.readouterr().out)["reason"] == "busy"
    finally:
        exporter_.stop()
    free = exporter.find_free_port()
    assert cli_main(["watch", "--once", "--port", str(free)]) == 2
    assert jax_exporter.watch_main(port=free, once=True) == 2
    assert cli_main(["profile", "--port", str(free)]) == 2


# --------------------------------------------------------------------- SLO


def test_slo_breaches_land_at_the_same_indices_as_jax(tmp_path):
    """One sequence of request terminals on a fake clock: a healthy stretch,
    a burst of slow and failed requests, then recovery. Both monitors
    breach at the same observations, with the same counters and gauges,
    and flight-dump at most 3 times a target."""
    base = {"serve": {"ttft_p99_ms": 200.0, "error_rate": 0.05}}
    sequence = ([(50.0, True)] * 20 + [(400.0, True), (60.0, False)] * 15
                + [(50.0, True)] * 20)
    results = []
    for name, (_, reg_module, slo_module, *_rest) in PACKAGES.items():
        clock = FakeClock()
        reg = reg_module.TelemetryRegistry()
        monitor = slo_module.build_slo_monitor(
            base, registry=reg, run_dir=tmp_path / name, clock=clock, fast_window_s=5.0,
            slow_window_s=20.0, fast_burn=10.0, slow_burn=4.0, min_events=4, cooldown_s=2.0)
        breaches = []
        for index, (ttft, ok) in enumerate(sequence):
            clock.t += 0.25
            before = monitor.breach_count()
            monitor.observe_request(ttft_ms=ttft, tpot_ms=5.0, ok=ok)
            if monitor.breach_count() > before:
                breaches.append((index, monitor.last_alert()["key"]))
        dumps = sorted(p.name for p in (tmp_path / name).glob("trace-flight-slo-*.jsonl"))
        snapshot = {k: v for k, v in reg.snapshot().items() if k.startswith("slo/")}
        results.append((breaches, snapshot, dumps))
    assert results[0] == results[1]
    breaches, snapshot, dumps = results[0]
    assert breaches and {key for _, key in breaches} == {"serve/ttft_p99_ms", "serve/error_rate"}
    assert snapshot["slo/breaches_total"] == len(breaches)
    assert len([d for d in dumps if "ttft" in d]) <= 3 and dumps


@pytest.mark.parametrize("env", [{}, {"LLMT_SLO_TTFT_P99_MS": "150", "LLMT_SLO_BURN_FAST": "0",
                                      "LLMT_SLO_STEP_TIME_P99_S": "junk"}])
def test_slo_env_overlay_matches_jax(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    base = {"train": {"goodput_pct_min": 50.0}}
    assert slo.slo_config_from_env(base) == jax_slo.slo_config_from_env(base)
    ours = slo.build_slo_monitor(base)
    theirs = jax_slo.build_slo_monitor(base)
    assert [(s.key, s.target, s.kind) for s in ours.specs] == [
        (s.key, s.target, s.kind) for s in theirs.specs]
    assert (ours.fast_burn, ours.slow_burn, ours.cooldown_s) == (
        theirs.fast_burn, theirs.slow_burn, theirs.cooldown_s)
    assert slo.build_slo_monitor({}) is None or env


# ------------------------------------------------------------ profile trigger


def test_profile_budget_and_cooldown_decisions_match_jax(monkeypatch, tmp_path):
    """The same request/poll sequence on a fake clock: the same answers,
    counters and status (JAX's profiler calls stubbed; the port's capture
    runs `torch.profiler` on the CPU)."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    results = []
    for name, (_, reg_module, _, prof_module, _) in PACKAGES.items():
        clock = FakeClock()
        reg = reg_module.TelemetryRegistry()
        trigger = prof_module.ProfileTrigger(run_dir=tmp_path / name, registry=reg, budget=2,
                                             cooldown_s=10.0, window_steps=1, clock=clock)
        answers = []
        for now, action, arg in [(0, "request", "a"), (1, "request", "b"), (1, "poll", 1),
                                 (2, "poll", 2), (5, "request", "c/../d"),
                                 (12, "request", "c/../d"), (12, "poll", 3), (13, "poll", 4),
                                 (30, "request", "e"), (31, "schedule", 40)]:
            clock.t = now
            if action == "request":
                answers.append(trigger.request(arg, source="test"))
            elif action == "poll":
                trigger.poll(arg)
            else:
                answers.append(trigger.schedule(arg, 2))
        status = trigger.status()
        for record in status["history"]:
            record.pop("trace_dir")
        trigger.teardown()
        answers.append(trigger.request("late"))
        results.append((answers, status, {k: v for k, v in reg.snapshot().items()
                                          if k.startswith("profile/")}))
    assert results[0] == results[1]
    answers = results[0][0]
    assert [a["reason"] for a in answers if isinstance(a, dict)] == [
        None, "busy", "cooldown", None, "budget", "torn-down"]
    assert answers[3]["tag"] == "c-..-d"


def test_profile_capture_writes_a_torch_profiler_trace_and_manifest(tmp_path):
    import torch

    reg = registry.TelemetryRegistry()
    trigger = profiling.ProfileTrigger(run_dir=tmp_path, registry=reg, budget=1,
                                       cooldown_s=0.0, window_steps=2)
    assert trigger.request("cap")["accepted"]
    trigger.poll(3)
    torch.randn(64, 64) @ torch.randn(64, 64)
    trigger.poll(4)
    assert trigger.status()["active"] == "cap"
    trigger.poll(5)
    trace = json.loads((tmp_path / "profile-cap" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    manifest = json.loads((tmp_path / "profile-cap.json").read_text())
    assert (manifest["tag"], manifest["start_step"], manifest["stop_step"]) == ("cap", 3, 5)
    assert manifest["trace_dir"] == str(tmp_path / "profile-cap")
    snap = reg.snapshot()
    assert snap["profile/captures"] == 1.0 and "profile/errors" not in snap


def test_serve_profile_line_answers_as_jax(tmp_path):
    """C.26: `{"type": "profile", "tag"?}` on `serve`'s stdin is answered
    `{"type": "profile", "accepted", "reason", "tag"}` as JAX's serve does
    (its default tag `serve-<step>`; a second line while the first is
    pending answers busy), never `bad request line`."""
    model = tmp_path / "tiny.json"
    model.write_text(json.dumps({**TINY, "attention_impl": "xla"}))
    args = build_parser().parse_args(["serve", "--model-config", str(model), "--device", "cpu",
                                      "--max-new-tokens", "2"])
    lines = [{"type": "profile"}, {"type": "profile", "tag": "x"}]
    stdout = io.StringIO()
    assert run_serve(args, stdin=io.StringIO("".join(json.dumps(x) + "\n" for x in lines)),
                     stdout=stdout) == 0
    answers = [json.loads(line) for line in stdout.getvalue().splitlines()][:2]
    trigger = jax_profiling.ProfileTrigger()
    expected = [{"type": "profile", **trigger.request("serve-0", source="serve")},
                {"type": "profile", **trigger.request("x", source="serve")}]
    assert answers == expected
    assert [a["reason"] for a in answers] == [None, "busy"]
    assert profiling.get_profile_trigger() is None
