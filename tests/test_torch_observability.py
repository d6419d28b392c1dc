"""`fit`'s live telemetry and `report` in the port against JAX's.

One 3-step tiny-Llama fit runs in each package with `LLMT_TRACE_TRAIN=1`,
a step-time SLO target every step breaches (the SLO monitors' clocks are
injected counters, so the breach indices do not depend on the host), a
chaos NaN at step 2 that NanGuard turns into an in-process rollback with
an anomaly dump and a flight dump, and a JSONL run directory. A third fit,
the port's without any of the telemetry armed, gives the losses the armed
one must reproduce exactly (rtol 0: the telemetry touches no math).

- The fits' `trace.jsonl` hold the same `(cat, name)` event sequence. The
  one recorded difference (ROADMAP C.39): JAX's `compile` span is its AOT
  compile, before the loop; the port's spans the first micro-step, right
  after its `data_load`. Both write exactly one.
- The `slo/*` counters and breach steps, and the `trace/*` gauges, are
  JAX's.
- JAX's `report_main` and the port's print byte-equal text and equal JSON
  on JAX's run directory and on synthetic ones that carry a `fleet.json`,
  `router/*` gauges, a `supervisor.jsonl`, a bench record and an audit
  record; on each package's own run directory the two reports have the
  same sections and the same keys under each, but the compiled step's
  `xla/*` and `attr/*` gauges (ROADMAP C.17) and the `world` block, which
  echoes each logger's `run_metadata.json` (ROADMAP C.40).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

from llm_training_tpu.callbacks.loggers import JsonlLogger as JaxJsonlLogger
from llm_training_tpu.callbacks.loggers import JsonlLoggerConfig as JaxJsonlLoggerConfig
from llm_training_tpu.callbacks.nan_guard import NanGuard as JaxNanGuard
from llm_training_tpu.callbacks.nan_guard import NanGuardConfig as JaxNanGuardConfig
from llm_training_tpu.data import DummyDataModule as JaxDummy
from llm_training_tpu.data import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.resilience import ChaosConfig as JaxChaosConfig
from llm_training_tpu.resilience import RecoveryConfig as JaxRecoveryConfig
from llm_training_tpu.resilience import ResilienceConfig as JaxResilienceConfig
from llm_training_tpu.telemetry import report as jax_report
from llm_training_tpu.telemetry import slo as jax_slo
from llm_training_tpu.telemetry import trace as jax_trace
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu.trainer.checkpoint import CheckpointConfig as JaxCheckpointConfig
from llm_training_tpu.trainer.checkpoint import Checkpointer as JaxCheckpointer
from llm_training_tpu_torch.callbacks.loggers import JsonlLogger, JsonlLoggerConfig
from llm_training_tpu_torch.callbacks.nan_guard import NanGuard, NanGuardConfig
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.resilience import ChaosConfig, RecoveryConfig, ResilienceConfig
from llm_training_tpu_torch.telemetry import report as port_report
from llm_training_tpu_torch.telemetry import slo as port_slo
from llm_training_tpu_torch.telemetry import trace as port_trace
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
            attention_impl="xla", param_dtype="float32", compute_dtype="float32")
DATA = dict(batch_size=8, max_length=16, num_samples=64, vocab_size=128)
OPTIM = dict(learning_rate=1e-3, warmup_steps=1, lr_scheduler="constant")
# every optimizer step breaches the step-time target; each breach counts
ARMED = {"LLMT_TRACE_TRAIN": "1", "LLMT_SLO_STEP_TIME_P99_S": "1e-9",
         "LLMT_SLO_MIN_SAMPLES": "1", "LLMT_SLO_COOLDOWN_S": "0",
         "LLMT_PROFILE_BUDGET": "0"}


class _Counter:
    """An SLO clock that advances one second a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _counted_clock(module):
    class Monitor(module.SLOMonitor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "clock": _Counter()})
    return Monitor


class _Losses:
    def __init__(self):
        self.losses = {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])


def _jax_fit(root: Path):
    losses = _Losses()
    trainer = JaxTrainer(
        JaxTrainerConfig(max_steps=3, log_every_n_steps=1, checkpoint_every_n_steps=1,
                         resilience=JaxResilienceConfig(chaos=JaxChaosConfig(nan_step=2),
                                                        recovery=JaxRecoveryConfig(
                                                            max_rollbacks=1))),
        callbacks=[losses, JaxJsonlLogger(JaxJsonlLoggerConfig(save_dir=str(root),
                                                               project="p", name="jax")),
                   JaxNanGuard(JaxNanGuardConfig())],
        checkpointer=JaxCheckpointer(JaxCheckpointConfig(dirpath=str(root / "jax-ckpt"),
                                                         async_save=False, max_to_keep=10)),
    )
    objective = JaxCLM(JaxCLMConfig(model=JaxProvider(
        model_class="llm_training_tpu.models.Llama", model_kwargs=TINY),
        optim=JaxOptimConfig(**OPTIM)))
    trainer.fit(objective, JaxDummy(JaxDummyConfig(**DATA)))
    return trainer, losses


def _port_fit(root: Path, name: str, params):
    config = LlamaConfig.from_dict(TINY)
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    losses = _Losses()
    trainer = Trainer(
        TrainerConfig(max_steps=3, log_every_n_steps=1, checkpoint_every_n_steps=1,
                      resilience=ResilienceConfig(chaos=ChaosConfig(nan_step=2),
                                                  recovery=RecoveryConfig(max_rollbacks=1))),
        callbacks=[losses, JsonlLogger(JsonlLoggerConfig(save_dir=str(root), project="p",
                                                         name=name)),
                   NanGuard(NanGuardConfig())], device="cpu",
        checkpointer=Checkpointer(CheckpointConfig(dirpath=str(root / f"{name}-ckpt"),
                                                   async_save=False, max_to_keep=10)),
    )
    objective = CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM)),
                    model=model)
    trainer.fit(objective, DummyDataModule(DummyDataModuleConfig(**DATA)))
    return trainer, losses


@pytest.fixture(scope="module")
def fits(tmp_path_factory, devices):
    """JAX's armed fit, the port's armed fit from JAX's initial weights, and
    the port's unarmed fit of the same."""
    import flax.linen as nn
    import jax

    root = tmp_path_factory.mktemp("observability")
    data = JaxDummy(JaxDummyConfig(**DATA))
    data.setup()
    objective = JaxCLM(JaxCLMConfig(model=JaxProvider(
        model_class="llm_training_tpu.models.Llama", model_kwargs=TINY),
        optim=JaxOptimConfig(**OPTIM)))
    params = jax.device_get(nn.meta.unbox(objective.init_params(
        jax.random.key(JaxTrainerConfig().seed), next(data.train_batches()))))
    out = {"root": root}
    with pytest.MonkeyPatch.context() as patch:
        for key in list(os.environ):
            if key.startswith("LLMT_"):
                patch.delenv(key)
        previous = port_trace.set_tracer(port_trace.TraceRecorder())
        try:
            out["unarmed"] = _port_fit(root, "unarmed", params)
        finally:
            port_trace.set_tracer(previous)
        for key, value in ARMED.items():
            patch.setenv(key, value)
        for module in (jax_slo, port_slo):
            patch.setattr(module, "SLOMonitor", _counted_clock(module))
        for name, trace_module, run in (
                ("jax", jax_trace, lambda: _jax_fit(root)),
                ("port", port_trace, lambda: _port_fit(root, "port", params))):
            previous = trace_module.set_tracer(trace_module.TraceRecorder())
            try:
                out[name] = run()
            finally:
                trace_module.set_tracer(previous)
    return out


def _events(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "trace.jsonl").read_text().splitlines()]


def _sequence(events: list[dict]) -> list[tuple[str, str]]:
    return [(e["cat"], e["name"]) for e in events]


def test_fit_trace_sequence_matches_jax(fits):
    root = fits["root"]
    theirs = _sequence(_events(root / "p" / "jax"))
    ours = _sequence(_events(root / "p" / "port"))
    compile_ = ("train", "compile")
    assert theirs.count(compile_) == ours.count(compile_) == 1
    assert theirs.index(compile_) == theirs.index(("train", "segment_start")) - 1
    assert ours[ours.index(compile_) - 1] == ("train", "data_load")
    assert ours[ours.index(compile_) + 1] == ("train", "train_step")
    theirs.remove(compile_)
    ours.remove(compile_)
    assert ours == theirs
    for event in (("train", "segment_start"), ("train", "data_load"), ("train", "train_step"),
                  ("resilience", "rollback"), ("train", "checkpoint_save"),
                  ("slo", "breach")):
        assert event in ours, event
    # the micro-step of every per-step span, in order
    def steps(events):
        return [(e["name"], e["args"].get("step")) for e in events
                if e["cat"] == "train" and e["name"] in ("data_load", "train_step")]
    assert steps(_events(root / "p" / "port")) == steps(_events(root / "p" / "jax"))
    rollback = [e["args"] for e in _events(root / "p" / "port") if e["name"] == "rollback"]
    assert rollback == [e["args"] for e in _events(root / "p" / "jax") if e["name"] == "rollback"]
    # the flight dumps beside the anomaly dump and the rollback
    for name in ("jax", "port"):
        run_dir = root / "p" / name
        assert (run_dir / "anomaly-2.json").exists()
        assert {p.name for p in run_dir.glob("trace-flight-*.jsonl")} >= {
            "trace-flight-anomaly-2.jsonl", "trace-flight-rollback-2.jsonl"}


def test_fit_slo_and_trace_gauges_match_jax(fits):
    theirs = fits["jax"][0].telemetry.snapshot()
    ours = fits["port"][0].telemetry.snapshot()
    counters = sorted(k for k in theirs if k.startswith("slo/") and (
        k.endswith("breaches") or k.endswith("breaches_total") or "burn" in k
        or k.endswith("last_breach_step")))
    assert counters and "slo/breaches_total" in counters
    assert {k: ours.get(k) for k in counters} == {k: theirs[k] for k in counters}
    assert ours["slo/breaches_total"] >= 2
    breaches = [[(e["args"].get("key"), e["args"].get("step")) for e in _events(
        fits["root"] / "p" / name) if e["cat"] == "slo"] for name in ("jax", "port")]
    assert breaches[1] == breaches[0] and breaches[0]
    flight = sorted(p.name for p in (fits["root"] / "p" / "jax").glob("trace-flight-slo-*"))
    assert flight and flight == sorted(
        p.name for p in (fits["root"] / "p" / "port").glob("trace-flight-slo-*"))
    for key in ("trace/events_recorded", "trace/events_written", "trace/flight_dumps"):
        assert key in ours, key
    # the same events reached each sink; the port's ring saw one event less
    # or more only where JAX's compile differs (none: one compile each)
    assert ours["trace/flight_dumps"] == theirs["trace/flight_dumps"]
    assert ours["trace/events_written"] == theirs["trace/events_written"]


def test_armed_fit_losses_equal_the_unarmed_fit(fits):
    armed, unarmed = fits["port"][1].losses, fits["unarmed"][1].losses
    assert sorted(armed) == sorted(unarmed) == [1, 2, 3]
    np.testing.assert_allclose([armed[s] for s in (1, 3)], [unarmed[s] for s in (1, 3)],
                               rtol=0, atol=0)
    # the unarmed fit wrote no trace and no SLO counters
    assert not (fits["root"] / "p" / "unarmed" / "trace.jsonl").exists() or not any(
        json.loads(line)["cat"] == "slo" for line in
        (fits["root"] / "p" / "unarmed" / "trace.jsonl").read_text().splitlines())
    assert "slo/breaches_total" not in fits["unarmed"][0].telemetry.snapshot()


# ------------------------------------------------------------------ report


def _reports(capsys, run_dir: Path, **kwargs) -> dict:
    out = {}
    for name, module in (("jax", jax_report), ("port", port_report)):
        text_rc = module.report_main(str(run_dir), **kwargs)
        text = capsys.readouterr().out
        json_rc = module.report_main(str(run_dir), format="json", **kwargs)
        data = json.loads(capsys.readouterr().out)
        out[name] = (text_rc, text, json_rc, data)
    return out


def test_report_on_jax_run_dir_is_jax_report(fits, capsys):
    reports = _reports(capsys, fits["root"] / "p" / "jax")
    assert reports["port"] == reports["jax"]
    text = reports["port"][1]
    for header in ("== Trace ==", "== SLO ==", "== Goodput", "== Recovery =="):
        assert header in text, header


def _sections(text: str) -> list[str]:
    return [line for line in text.splitlines() if line.startswith("== ")]


def test_port_report_on_port_run_dir_has_jax_sections(fits, capsys):
    """The port's report on the port's fit and JAX's on JAX's: the same
    sections in the same order, and the same keys under each."""
    root = fits["root"] / "p"
    assert port_report.report_main(str(root / "port")) == 0
    ours = capsys.readouterr().out
    assert jax_report.report_main(str(root / "jax")) == 0
    theirs = capsys.readouterr().out
    assert _sections(ours) == _sections(theirs)
    assert port_report.report_main(str(root / "port"), format="json") == 0
    ours_json = json.loads(capsys.readouterr().out)
    assert jax_report.report_main(str(root / "jax"), format="json") == 0
    theirs_json = json.loads(capsys.readouterr().out)
    assert ours_json["schema_version"] == theirs_json["schema_version"]
    assert sorted(ours_json) == sorted(theirs_json)
    for key in theirs_json:
        if key == "world":
            continue  # each logger's own run_metadata.json (ROADMAP C.40)
        if isinstance(theirs_json[key], dict) and isinstance(ours_json[key], dict):
            # the compiled step's gauges JAX writes and eager PyTorch has not
            # (ROADMAP C.17)
            theirs_keys = [k for k in theirs_json[key] if not k.startswith(("xla/", "attr/"))]
            assert sorted(ours_json[key]) == sorted(theirs_keys), key
    # the CLI's command prints the same text
    assert cli_main(["report", str(root / "port")]) == 0
    assert capsys.readouterr().out == ours


def _synthetic(root: Path, kind: str) -> tuple[Path, dict]:
    """A run directory that carries the artifacts of the control planes."""
    run_dir = root / kind
    run_dir.mkdir(parents=True)
    keys = [k for k in re.findall(r'"([a-z_]+/[a-z0-9_/]*)"',
                                  (Path(jax_report.__file__)).read_text())]
    telemetry = {"step": 4}
    for i, key in enumerate(sorted(set(keys))):
        telemetry[key + ("x" if key.endswith("/") else "")] = float(i % 7) + 0.5
    telemetry.update({"goodput/goodput_pct": 81.5, "goodput/total_s": 12.0,
                      "goodput/step_compute_s": 9.0, "goodput/compile_s": 1.5,
                      "slo/train/step_time_p99_s/breaches": 2.0,
                      "slo/train/step_time_p99_s/target": 0.5,
                      "slo/train/step_time_p99_s/burn_fast": 30.0,
                      "elastic/segment": 1.0, "goodput/cost_dollars": 0.25})
    metrics = [{"step": s, "loss": 3.0 - 0.25 * s, "grad_norm": 1.0 + s,
                "steps_per_sec": 2.0, "tokens/sec": 900.0 + s} for s in (1, 2, 3, 4)]
    (run_dir / "metrics.jsonl").write_text("".join(json.dumps(m) + "\n" for m in metrics))
    records = [dict(telemetry, step=2, **{"elastic/segment": 0.0}), telemetry]
    (run_dir / "telemetry.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    (run_dir / "run_metadata.json").write_text(json.dumps({"seed": 7, "mesh": {"fsdp": 1}}))
    kwargs: dict = {}
    if kind in ("fleet", "all"):
        (run_dir / "fleet.json").write_text(json.dumps({
            "verdict": "red", "sweeps": 4,
            "replicas": {"serve-0-11": {"role": "serve", "healthy": True, "stale": False,
                                        "error": None, "attempt": 0},
                         "serve-1-22": {"role": "serve", "healthy": False, "stale": True,
                                        "error": "stale card", "attempt": 1}},
            "red": [], "stale_cards": ["serve-1-22"],
            "rollup": {"llmt_fleet_serve_requests_completed": 16.0,
                       "llmt_fleet_replicas": 2.0}}))
    if kind in ("supervisor", "all"):
        events = [{"event": "segment_topology", "attempt": 0, "chips": 4,
                   "mesh": {"fsdp": 4}, "price_per_chip_hour": 1.0},
                  {"event": "exit", "attempt": 0, "rc": 75},
                  {"event": "segment_topology", "attempt": 1, "chips": 2,
                   "mesh": {"fsdp": 2}, "price_per_chip_hour": 1.0},
                  {"event": "exit", "attempt": 1, "rc": 0}]
        log = root / f"{kind}-supervisor.jsonl"
        log.write_text("".join(json.dumps(e) + "\n" for e in events))
        kwargs["supervisor_log"] = str(log)
    if kind in ("bench", "all"):
        bench = root / f"{kind}-bench"
        bench.mkdir()
        (bench / "BENCH_r07.json").write_text(json.dumps({
            "value": 0.41, "vs_baseline": 1.02, "tokens_per_sec_per_chip": 1234.5,
            "sec_per_step": 0.8, "goodput_pct": 93.1,
            "blocks": {"block_q": 512, "block_k": 1024}}))
        kwargs["bench_dir"] = str(bench)
    if kind in ("audit", "all"):
        audit = root / f"{kind}-audit"
        audit.mkdir()
        (audit / "audit_r01.json").write_text(json.dumps({
            "findings": [{"rule": "replicated-large", "path": "a"},
                         {"rule": "replicated-large", "path": "b"}],
            "families": ["llama"], "meshes": ["fsdp4"], "baselined": 1,
            "estimates": {"llama": {"meshes": {"fsdp4": {"total_gib": 3.5},
                                               "fsdp2": {"total_gib": 6.25}}}},
            "hbm_budget_gib": 16.0}))
        (audit / "race_r01.json").write_text(json.dumps({
            "findings": [{"rule": "unguarded"}], "suppressed": 2}))
        kwargs["audit_dir"] = str(audit)
    return run_dir, kwargs


@pytest.mark.parametrize("kind", ["fleet", "router", "supervisor", "bench", "audit", "all"])
def test_report_on_synthetic_run_dirs_is_jax_report(kind, tmp_path, capsys):
    run_dir, kwargs = _synthetic(tmp_path, kind)
    reports = _reports(capsys, run_dir, **kwargs)
    assert reports["port"] == reports["jax"]
    rc, text, json_rc, data = reports["port"]
    assert rc == json_rc == 0 and data["schema_version"] == jax_report.REPORT_SCHEMA_VERSION
    expected = {"fleet": "== Fleet ==", "router": "== Router ==",
                "supervisor": "== Elastic ==", "bench": "== Perf ==",
                "audit": "== Audit ==", "all": "== Fleet =="}[kind]
    assert expected in text


def test_report_missing_run_dir_exits_2_as_jax(tmp_path, capsys):
    codes = [module.report_main(str(tmp_path / "absent")) for module in (jax_report, port_report)]
    err = capsys.readouterr().err
    assert codes == [2, 2] and err.count("report:") == 2
