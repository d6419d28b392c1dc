"""Port parity of the telemetry layer on the CPU: the registry and the
goodput ledger under an injected clock, the `hbm/*` gauges and their
timeline, the EMA z-score, the anomaly helpers and dumps, NanGuard over a
metric stream and the JSONL logger's telemetry routing -- each fed the same
inputs as its JAX counterpart, bit-equal where the code is host-side numpy
or the standard library; then the ledger inside a port fit.
"""

import json
import math
import threading
import types

import numpy as np
import pytest

from llm_training_tpu.callbacks.loggers import JsonlLogger as JaxJsonlLogger
from llm_training_tpu.callbacks.nan_guard import LossSpikeError as JaxSpike
from llm_training_tpu.callbacks.nan_guard import NanGuard as JaxNanGuard
from llm_training_tpu.callbacks.nan_guard import NanGuardConfig as JaxNanGuardConfig
from llm_training_tpu.callbacks.nan_guard import NonFiniteLossError as JaxNonFinite
from llm_training_tpu.telemetry import anomaly as jax_anomaly
from llm_training_tpu.telemetry import device as jax_device
from llm_training_tpu.telemetry.goodput import GoodputLedger as JaxLedger
from llm_training_tpu.telemetry.registry import TelemetryRegistry as JaxRegistry
from llm_training_tpu_torch.callbacks.loggers import JsonlLogger, JsonlLoggerConfig
from llm_training_tpu_torch.callbacks.nan_guard import (
    LossSpikeError,
    NanGuard,
    NanGuardConfig,
    NonFiniteLossError,
)
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.telemetry import anomaly, device
from llm_training_tpu_torch.telemetry.goodput import PHASES, GoodputLedger
from llm_training_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
    set_registry,
)
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
            attention_impl="xla", param_dtype="float32", compute_dtype="float32")


class _Clock:
    """A clock that advances only when told to."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _drive_ledger(ledger_cls):
    clock = _Clock()
    ledger = ledger_cls(clock=clock)
    ledger.start()
    out = []
    for phase, seconds in (("compile", 2.5), ("data_wait", 0.125), ("step_compute", 1.75),
                           ("checkpoint_save", 0.5), ("validation", 0.25),
                           ("step_compute", 3.0)):
        with ledger.measure(phase):
            out.append(ledger.current_phase)
            clock.advance(seconds)
        clock.advance(0.0625)  # host bookkeeping between phases: `other`
    ledger.note("data_wait", 0.375)
    out.append(ledger.current_phase)
    out.append(ledger.summary())
    with pytest.raises(KeyError):
        ledger.note("bogus", 1.0)
    return out


def test_goodput_ledger_matches_jax_under_injected_clock():
    got, want = _drive_ledger(GoodputLedger), _drive_ledger(JaxLedger)
    assert got == want
    summary = got[-1]
    assert PHASES == ("compile", "data_wait", "step_compute", "checkpoint_save", "validation")
    tracked = sum(summary[f"goodput/{p}_s"] for p in (*PHASES, "other"))
    assert math.isclose(tracked, summary["goodput/total_s"], rel_tol=1e-12)
    assert summary["goodput/goodput_pct"] == 100.0 * 4.75 / summary["goodput/total_s"]


def _drive_registry(registry_cls):
    clock = _Clock()
    registry = registry_cls(clock=clock)
    registry.counter("data/retries").inc()
    registry.counter("data/retries").inc(2.5)
    registry.gauge("compile_time_s").set(3)
    registry.gauge("unset")  # a gauge never set is left out
    with registry.timer("data/produce").time():
        clock.advance(0.75)
    registry.timer("data/produce").add(0.25)
    return registry.snapshot()


def test_registry_matches_jax_under_injected_clock():
    got, want = _drive_registry(TelemetryRegistry), _drive_registry(JaxRegistry)
    assert got == want
    assert got == {"data/retries": 3.5, "compile_time_s": 3.0, "data/produce_s": 1.0,
                      "data/produce_n": 2.0}


def test_registry_is_thread_safe_and_current_is_swappable():
    registry = TelemetryRegistry()
    threads = [threading.Thread(target=lambda: [registry.counter("c").inc() for _ in range(2000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert registry.snapshot()["c"] == 16000.0
    previous = set_registry(registry)
    try:
        assert get_registry() is registry
    finally:
        assert set_registry(previous) is registry
    assert get_registry() is previous


def test_hbm_gauges_fall_back_to_rss_like_jax(tmp_path, monkeypatch):
    """On the CPU both report the process's RSS under the same keys; the
    timeline's records carry the same fields."""
    monkeypatch.setattr(jax_device, "local_device_memory_stats", lambda: [])
    got, want = device.hbm_gauges("cpu"), jax_device.hbm_gauges()
    assert set(got) == set(want) == {"hbm/bytes_in_use", "hbm/peak_bytes_in_use",
                                     "hbm/host_fallback"}
    assert got["hbm/host_fallback"] == 1.0 and got["hbm/bytes_in_use"] > 0
    ours = device.HBMTimeline(run_dir=tmp_path / "port", device="cpu", clock=lambda: 7.0)
    theirs = jax_device.HBMTimeline(run_dir=tmp_path / "jax", clock=lambda: 7.0)
    assert set(ours.sample(3)) == set(theirs.sample(3))
    a = json.loads((tmp_path / "port" / "hbm.jsonl").read_text())
    b = json.loads((tmp_path / "jax" / "hbm.jsonl").read_text())
    assert set(a) == set(b) and a["step"] == b["step"] == 3 and a["host_fallback"]


def test_hbm_gauges_rollup_of_cards_matches_jax():
    """The per-card rollup (worst card first, mean, per-card keys) on the
    same per-card sample."""
    sample = [(0, {"bytes_in_use": 10.0, "peak_bytes_in_use": 12.0, "bytes_limit": 100.0}),
              (1, {"bytes_in_use": 70.0, "peak_bytes_in_use": 71.0, "bytes_limit": 80.0})]
    assert device._gauges_from_stats(sample) == jax_device._gauges_from_stats(sample)
    assert device._gauges_from_stats(sample)["hbm/worst_device"] == 1.0


def test_ema_zscore_matches_jax():
    rng = np.random.default_rng(3)
    stream = list(5.0 + 0.1 * rng.standard_normal(40)) + [float("nan"), 9.0, float("inf"), 4.9]
    ours, theirs = anomaly.EmaZScore(beta=0.9, warmup=5), jax_anomaly.EmaZScore(beta=0.9, warmup=5)
    for value in stream:
        assert ours.score(value) == theirs.score(value)
        ours.update(value)
        theirs.update(value)
        assert (ours.count, ours.mean, ours.var) == (theirs.count, theirs.mean, theirs.var)
    with pytest.raises(ValueError):
        anomaly.EmaZScore(beta=1.0)


def test_provenance_helpers_and_dump_match_jax(tmp_path):
    health = {f"health/grad_norm/layers_{i:02d}": (float("nan") if i % 3 == 0 else float(i))
              for i in range(10)}
    health.update({f"health/update_ratio/layers_{i:02d}": 1e-3 * i for i in range(10)})
    health["health/update_ratio/norm"] = float("inf")
    assert anomaly.offending_layers(health) == jax_anomaly.offending_layers(health)
    assert anomaly.offending_layers(health, limit=2) == ["layers_00", "layers_03",
                                                         "... (+2 more)"]
    assert anomaly.top_layers(health) == jax_anomaly.top_layers(health) == [
        "layers_09", "layers_08", "layers_07"]
    metrics = {"loss": float("nan"), "grad_norm": 2.0, "lr": np.float32(1e-3), "tag": object}
    args = dict(step=7, reason="non_finite", metrics=metrics, offending=["layers_00"],
                health=health, extra={"zscores": {"loss": 9.5}, "note": 3})
    ours = anomaly.dump_anomaly(tmp_path / "port", **args)
    theirs = jax_anomaly.dump_anomaly(tmp_path / "jax", **args)
    assert ours.name == theirs.name == "anomaly-7.json"
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    want["metrics"]["tag"] = got["metrics"]["tag"]  # str() of the same object
    assert got == want
    trainer = types.SimpleNamespace(callbacks=[types.SimpleNamespace(run_dir=str(tmp_path))],
                                    checkpointer=None)
    assert anomaly.resolve_run_dir(trainer) == jax_anomaly.resolve_run_dir(trainer) == tmp_path


def _fake_trainer(registry_cls, run_dir, health=None):
    return types.SimpleNamespace(
        telemetry=registry_cls(), last_health=health, checkpointer=None,
        callbacks=[types.SimpleNamespace(run_dir=str(run_dir))],
        should_stop=False, abort_final_save=False,
    )


def _guard_stream(guard_cls, cfg_cls, registry_cls, errors, run_dir, stream, **cfg):
    """Feed the metric stream to a guard; returns (the step that raised and
    its error kind, the guard's counters and state, the registry's
    snapshot, the dump's keys)."""
    health = {"health/grad_norm/layers_00": float("nan"), "health/grad_norm/layers_01": 1.0,
              "health/update_ratio/layers_01": 0.5}
    trainer = _fake_trainer(registry_cls, run_dir, health)
    guard = guard_cls(cfg_cls(**cfg))
    raised = None
    for step, (loss, grad_norm) in enumerate(stream, start=1):
        try:
            guard.on_step_end(trainer, step, {"loss": loss, "grad_norm": grad_norm})
        except errors as e:
            raised = (step, type(e).__name__)
            break
    dumps = sorted(p.name for p in run_dir.glob("anomaly-*.json"))
    keys = [sorted(json.loads((run_dir / d).read_text())) for d in dumps]
    return raised, guard.state_dict(), trainer.telemetry.snapshot(), dumps, keys, (
        trainer.should_stop, trainer.abort_final_save)


STREAMS = {
    "spike": [(4.0 - 0.01 * i, 1.0 + 0.001 * i) for i in range(12)] + [(40.0, 1.0), (41.0, 1.0)],
    "nan": [(4.0, 1.0), (float("nan"), 1.0), (3.9, 1.0), (float("nan"), 1.0),
            (float("inf"), float("nan"))],
}


@pytest.mark.parametrize("case", [
    ("spike", dict(spike_zscore=6.0, spike_warmup_steps=5)),
    ("spike", dict(spike_zscore=6.0, spike_warmup_steps=5, spike_patience=1)),
    ("nan", dict()),
    ("nan", dict(patience=1)),
    ("nan", dict(patience=1, action="stop")),
], ids=["spike", "spike-patience", "nan", "nan-patience", "nan-stop"])
def test_nan_guard_matches_jax_over_a_metric_stream(tmp_path, case):
    name, cfg = case
    ours = _guard_stream(NanGuard, NanGuardConfig, TelemetryRegistry,
                         (NonFiniteLossError, LossSpikeError), tmp_path / "port",
                         STREAMS[name], **cfg)
    theirs = _guard_stream(JaxNanGuard, JaxNanGuardConfig, JaxRegistry, (JaxNonFinite, JaxSpike),
                           tmp_path / "jax", STREAMS[name], **cfg)
    assert ours == theirs
    if cfg.get("action") != "stop":
        assert ours[0] is not None
    assert ours[3], "an anomaly dump was written"


def test_nan_guard_state_round_trip_and_rollback_match_jax(tmp_path):
    states = []
    for guard_cls, cfg_cls in ((NanGuard, NanGuardConfig), (JaxNanGuard, JaxNanGuardConfig)):
        guard = guard_cls(cfg_cls(spike_zscore=6.0, spike_warmup_steps=3))
        trainer = _fake_trainer(JaxRegistry, tmp_path / guard_cls.__module__.split(".")[0])
        for step, value in enumerate([3.0, 2.9, float("nan"), 2.8], start=1):
            try:
                guard.on_step_end(trainer, step, {"loss": value, "grad_norm": 1.0})
            except Exception:
                pass
        fresh = guard_cls(cfg_cls(spike_zscore=6.0, spike_warmup_steps=3))
        fresh.load_state_dict(json.loads(json.dumps(guard.state_dict())))
        fresh.on_rollback(trainer, 1)
        states.append((guard.state_dict(), fresh.state_dict()))
    assert states[0] == states[1]
    assert states[0][1]["streak"] == 0 and states[0][1]["non_finite_steps"] == 1


def test_jsonl_logger_routes_telemetry_like_jax(tmp_path):
    metrics = {"loss": np.float32(2.5), "grad_norm": 1.25, "lr": 1e-3, "goodput/total_s": 3.0,
               "hbm/bytes_in_use": 7.0, "health/grad_norm/layers_00": 0.5,
               "nan_guard/spike_steps": 1.0, "compile_time_s": 2.0, "data/retries": 1.0,
               "resilience/rollbacks": 1.0, "perf/mfu": 0.25, "note": "x"}
    record = {"goodput/checkpoint_save_s": 4.0, "loss": 1.0, "hbm/devices": 1.0}
    loggers = {
        "port": JsonlLogger(JsonlLoggerConfig(save_dir=str(tmp_path), project="port", name="r")),
        "jax": JaxJsonlLogger(),
    }
    loggers["jax"].run_dir = tmp_path / "jax" / "r"
    for logger in loggers.values():
        logger.on_step_end(None, 2, metrics)
        logger.on_validation_end(None, 2, {"val_loss": 3.0})
        logger.on_telemetry(None, 2, record)
        logger.on_fit_end(None, None)
    for name in ("metrics.jsonl", "telemetry.jsonl"):
        got = (tmp_path / "port" / "r" / name).read_text()
        assert got == (tmp_path / "jax" / "r" / name).read_text(), name
    telemetry = [json.loads(line) for line in
                 (tmp_path / "port" / "r" / "telemetry.jsonl").read_text().splitlines()]
    assert "loss" not in telemetry[0] and telemetry[-1] == {
        "step": 2, "goodput/checkpoint_save_s": 4.0, "hbm/devices": 1.0}


class _Records:
    def __init__(self):
        self.metrics, self.telemetry = [], []

    def on_step_end(self, trainer, step, metrics):
        self.metrics.append(dict(metrics))

    def on_telemetry(self, trainer, step, record):
        self.telemetry.append(dict(record))


def test_fit_brackets_goodput_phases_and_logs_telemetry(tmp_path):
    """A port fit on the CPU: every log step's metrics carry the ledger's
    summary, the hbm/* gauges and the registry's snapshot (prefetcher
    timers included); the phases sum to the total; the fit's first
    micro-step bills to compile; the epilogue's record reaches
    on_telemetry and telemetry.jsonl."""
    records = _Records()
    logger = JsonlLogger(JsonlLoggerConfig(save_dir=str(tmp_path), project="p", name="r"))
    trainer = Trainer(TrainerConfig(max_steps=4, log_every_n_steps=2, val_check_interval=2,
                                    limit_val_batches=1), callbacks=[records, logger],
                      device="cpu")
    objective = CLM(CLMConfig(model=ModelProvider("Llama", TINY),
                              optim=OptimConfig(learning_rate=1e-3)))
    data = DummyDataModule(DummyDataModuleConfig(batch_size=4, max_length=32, num_samples=64,
                                                 vocab_size=128, validation_split=8))
    previous = get_registry()
    trainer.fit(objective, data)
    assert get_registry() is previous  # restored after the fit
    assert [m["steps_per_sec"] > 0 for m in records.metrics] == [True, True]
    last = records.metrics[-1]
    for key in ("goodput/compile_s", "goodput/step_compute_s", "goodput/data_wait_s",
                "goodput/validation_s", "hbm/bytes_in_use", "hbm_timeline/records",
                "data/produce_s", "data/host_wait_n", "data/retries", "compile_time_s"):
        assert key in last, key
    assert last["goodput/compile_s"] > 0 and last["data/retries"] == 0
    record = records.telemetry[-1]
    assert record == trainer.last_telemetry
    total = sum(record[f"goodput/{p}_s"] for p in (*PHASES, "other"))
    assert math.isclose(total, record["goodput/total_s"], rel_tol=1e-9)
    lines = (tmp_path / "p" / "r" / "telemetry.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["goodput/total_s"] == record["goodput/total_s"]
    assert (tmp_path / "p" / "r" / "hbm.jsonl").exists()
