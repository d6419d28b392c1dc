"""The callback contract and the callbacks of `fit` on the CPU: the hook
contract against the JAX `Trainer` (the same hooks with the same
arguments in the same order, `teardown` even when the fit raises,
`abort_final_save`), the time estimator and the progress bar against
JAX's on the same step times, a `torch.profiler` trace over a step
window, the output tee restored by `teardown`, and the example configs'
trainer and callbacks nodes through the port's config layer.
"""

import json
import logging
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import llm_training_tpu.callbacks.progress as jax_progress
import llm_training_tpu.callbacks.time_estimator as jax_estimator
import llm_training_tpu_torch.callbacks.progress as progress
import llm_training_tpu_torch.callbacks.time_estimator as estimator
from llm_training_tpu.callbacks.output_redirection import OutputRedirection as JaxOutputRedirection
from llm_training_tpu.callbacks.output_redirection import (
    OutputRedirectionConfig as JaxOutputRedirectionConfig,
)
from llm_training_tpu.data import DummyDataModule as JaxDummy
from llm_training_tpu.data import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.callbacks.loggers import JsonlLogger, JsonlLoggerConfig
from llm_training_tpu_torch.callbacks.output_redirection import (
    OutputRedirection,
    OutputRedirectionConfig,
)
from llm_training_tpu_torch.callbacks.profiler import ProfilerCallback, ProfilerCallbackConfig
from llm_training_tpu_torch.cli.config import instantiate_from_config
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
            attention_impl="xla", param_dtype="float32", compute_dtype="float32")
DATA = dict(batch_size=8, max_length=32, num_samples=64, vocab_size=128, validation_split=8)
OPTIM = dict(learning_rate=1e-3, warmup_steps=1, lr_scheduler="constant")


class _Hooks:
    """A callback written to JAX's hook signatures, recording each call's
    hook and the arguments both packages can compare."""

    def __init__(self, fail_at=None):
        self.calls, self.trainer, self.fail_at = [], None, fail_at

    def on_fit_start(self, trainer, objective, datamodule, start_step):
        self.trainer = trainer
        self.calls.append(("on_fit_start", start_step, datamodule is not None))

    def on_train_step(self, trainer, step):
        assert trainer is self.trainer
        self.calls.append(("on_train_step", step))
        if step == self.fail_at:
            raise RuntimeError("callback failure")

    def on_step_end(self, trainer, step, metrics):
        self.calls.append(("on_step_end", step, {"loss", "grad_norm", "lr"} <= set(metrics)))

    def on_validation_end(self, trainer, step, metrics):
        self.calls.append(("on_validation_end", step, sorted(metrics)))

    def on_telemetry(self, trainer, step, record):
        self.calls.append(("on_telemetry", step, "goodput/total_s" in record))

    def on_fit_end(self, trainer, state):
        assert trainer is self.trainer
        self.state = state
        self.calls.append(("on_fit_end", state is not None))

    def teardown(self):
        self.calls.append(("teardown",))


def _jax_fit(hooks, max_steps=3):
    trainer = JaxTrainer(JaxTrainerConfig(max_steps=max_steps, log_every_n_steps=2,
                                          val_check_interval=2, limit_val_batches=1),
                         callbacks=[hooks])
    objective = JaxCLM(JaxCLMConfig(model=JaxProvider(
        model_class="llm_training_tpu.models.Llama", model_kwargs=TINY),
        optim=JaxOptimConfig(**OPTIM)))
    return trainer.fit(objective, JaxDummy(JaxDummyConfig(**DATA)))


def _port_fit(callbacks, max_steps=3, **trainer):
    config = dict(max_steps=max_steps, log_every_n_steps=2, val_check_interval=2,
                  limit_val_batches=1)
    config.update(trainer)
    fit = Trainer(TrainerConfig(**config), callbacks=callbacks, device="cpu")
    objective = CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM)))
    return fit, fit.fit(objective, DummyDataModule(DummyDataModuleConfig(**DATA)))


def test_hook_contract_matches_jax(devices):
    """One callback written to JAX's signatures (`on_fit_end(trainer,
    state)`, `teardown()`) through a JAX fit and a port fit: the same hooks,
    with the same arguments, in the same order; `on_fit_end` gets the state
    the fit returns."""
    jax_hooks, port_hooks = _Hooks(), _Hooks()
    jax_state = _jax_fit(jax_hooks)
    trainer, state = _port_fit([port_hooks])
    assert port_hooks.calls == jax_hooks.calls
    assert port_hooks.calls == [
        ("on_fit_start", 0, True), ("on_train_step", 1), ("on_train_step", 2),
        ("on_step_end", 2, True), ("on_validation_end", 2, ["val_loss"]), ("on_train_step", 3),
        ("on_step_end", 3, True), ("on_telemetry", 3, True), ("on_fit_end", True), ("teardown",)]
    assert port_hooks.state is state and state is trainer.state
    assert jax_hooks.state is jax_state


def test_teardown_runs_when_fit_raises(devices):
    """A callback raising at step 2: both fits raise it, and every callback's
    `teardown()` has run; the port restores the registry it replaced."""
    from llm_training_tpu_torch.telemetry.registry import get_registry

    jax_hooks, port_hooks = _Hooks(fail_at=2), _Hooks(fail_at=2)
    with pytest.raises(RuntimeError, match="callback failure"):
        _jax_fit(jax_hooks)
    previous = get_registry()
    with pytest.raises(RuntimeError, match="callback failure"):
        _port_fit([port_hooks])
    assert get_registry() is previous
    assert port_hooks.calls == jax_hooks.calls
    assert port_hooks.calls[-1] == ("teardown",) and ("on_fit_end", True) not in port_hooks.calls


class _Veto:
    def on_step_end(self, trainer, step, metrics):
        if step == trainer.config.max_steps:
            trainer.abort_final_save = True


def test_abort_final_save_vetoes_the_final_checkpoint(tmp_path):
    """A callback setting `trainer.abort_final_save` on the last step: the
    interval save of step 2 stays the newest, no step-3 checkpoint."""
    checkpointer = Checkpointer(CheckpointConfig(dirpath=str(tmp_path)))
    fit = Trainer(TrainerConfig(max_steps=3, log_every_n_steps=1, checkpoint_every_n_steps=2),
                  callbacks=[_Veto()], device="cpu", checkpointer=checkpointer)
    fit.fit(CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM))),
            DummyDataModule(DummyDataModuleConfig(**DATA)))
    assert checkpointer.all_steps() == [2] and fit.abort_final_save


class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_time_estimator_matches_jax(monkeypatch):
    """The same step times, tokens and model: every number of the result
    equals JAX's; MFU differs only by the peak table (989 TFLOP/s for the
    port's H100 against 197 for JAX's v5e here)."""
    times = [10.0, 12.5, 15.0, 17.5, 20.0, 22.25]
    monkeypatch.setattr(estimator, "time", types.SimpleNamespace(perf_counter=_Clock(times)))
    monkeypatch.setattr(jax_estimator, "time", types.SimpleNamespace(perf_counter=_Clock(times)))
    monkeypatch.setattr(estimator, "peak_flops_per_device", lambda device=None: 989e12)
    monkeypatch.setattr(jax_estimator, "jax", types.SimpleNamespace(
        devices=lambda: [types.SimpleNamespace(device_kind="TPU v5 lite")],
        tree=__import__("jax").tree, block_until_ready=lambda x: x))
    from llm_training_tpu.telemetry.registry import TelemetryRegistry

    model_cfg = types.SimpleNamespace(num_hidden_layers=2, hidden_size=64)
    objective = types.SimpleNamespace(model=types.SimpleNamespace(config=model_cfg))
    results = []
    for module, trainer_extra in (
        (estimator, dict(state=types.SimpleNamespace(model=torch.nn.Linear(10, 10)),
                         device=torch.device("cpu"))),
        (jax_estimator, dict(abstract_state=types.SimpleNamespace(params={"w": np.zeros(110)}),
                             last_metrics=None)),
    ):
        trainer = types.SimpleNamespace(
            config=types.SimpleNamespace(max_steps=100, accumulate_grad_batches=1),
            counters={"consumed_tokens": 0}, last_seq_len=32, telemetry=TelemetryRegistry(),
            should_stop=False, last_step=None, **trainer_extra)
        cb = module.TrainingTimeEstimator(module.TrainingTimeEstimatorConfig(
            num_steps=3, skip_first_n_steps=1, stop_after_steps=4))
        cb.on_fit_start(trainer, objective, None, 0)
        for step in range(1, 6):
            trainer.counters["consumed_tokens"] += 256
            trainer.last_step = step
            cb.on_train_step(trainer, step)
        cb.on_fit_end(trainer, None)
        results.append((cb.result, trainer.should_stop, trainer.telemetry.snapshot()))
    (ours, stop, snap), (theirs, jax_stop, jax_snap) = results
    mfu, jax_mfu = ours.pop("mfu"), theirs.pop("mfu")
    assert ours == theirs and stop and jax_stop
    assert mfu == pytest.approx(jax_mfu * 197e12 / 989e12, rel=1e-12)
    assert ours["model_flops_per_step"] == estimator.transformer_step_flops(110, 256, 2, 64, 32)
    assert {k: v for k, v in snap.items() if k != "perf/mfu"} == {
        k: v for k, v in jax_snap.items() if k != "perf/mfu"}


def test_time_estimator_peak_table():
    assert estimator.peak_flops_per_device("cpu") is None
    if not torch.cuda.is_available():
        assert estimator.peak_flops_per_device() is None
    names = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 PCIe": 756e12,
             "NVIDIA A100-SXM4-80GB": 312e12, "NVIDIA GeForce RTX 4090": None}
    for name, peak in names.items():
        found = next((f for key, f in estimator._PEAK_FLOPS if key in name.lower()), None)
        assert found == peak, name


def test_progress_bar_matches_jax(monkeypatch, capsys):
    """The same steps, tokens and clock: the same status lines."""
    lines = []
    for module in (progress, jax_progress):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=_Clock([0.0, 1.0, 1.25, 2.0, 3.5])))
        trainer = types.SimpleNamespace(config=types.SimpleNamespace(max_steps=10),
                                        counters={"consumed_tokens": 100})
        bar = module.ProgressBar(module.ProgressBarConfig(force=True, refresh_rate=0.5))
        bar.on_fit_start(trainer, None, None, 2)
        for step in (3, 4, 5, 6):
            trainer.counters["consumed_tokens"] += 1000
            bar.on_train_step(trainer, step)
            bar.on_step_end(trainer, step, {"loss": 2.5 - 0.1 * step})
        bar.teardown()
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert "step 6/10 (60%)" in lines[0] and "ETA" in lines[0] and lines[0].endswith("\n")


class _Raise:
    def __init__(self, at):
        self.at = at

    def on_train_step(self, trainer, step):
        if step == self.at:
            print("printed before the failure")
            raise RuntimeError("stop here")


def test_profiler_writes_a_trace_over_the_window(tmp_path):
    """A CPU `torch.profiler` trace of steps [1, 3) lands in the run
    directory as a Chrome trace; a fit raising inside a window leaves no
    trace open (`teardown`)."""
    logger = JsonlLogger(JsonlLoggerConfig(save_dir=str(tmp_path), project="p", name="r"))
    profiler = ProfilerCallback(ProfilerCallbackConfig(start_step=1, num_steps=2))
    _port_fit([logger, profiler], max_steps=4)
    trace = tmp_path / "p" / "r" / "profile-window-1" / "trace.json"
    assert profiler.trace_path == trace
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    open_window = ProfilerCallback(ProfilerCallbackConfig(trace_dir=str(tmp_path / "t"),
                                                          start_step=1, num_steps=10))
    with pytest.raises(RuntimeError, match="stop here"):
        _port_fit([open_window, _Raise(2)], max_steps=4)
    assert open_window._profiler is None and (tmp_path / "t" / "trace.json").exists()


def test_output_redirection_is_restored_by_teardown(tmp_path):
    """The tee writes numbered logs as JAX's; a fit that raises still gets
    stdout, stderr and the root logger's handlers back."""
    stdout, stderr = sys.stdout, sys.stderr
    handlers = list(logging.getLogger().handlers)
    tee = OutputRedirection(OutputRedirectionConfig(log_dir=str(tmp_path / "port")))
    with pytest.raises(RuntimeError, match="stop here"):
        _port_fit([tee, _Raise(1)], max_steps=2)
    assert (sys.stdout, sys.stderr) == (stdout, stderr)
    assert logging.getLogger().handlers == handlers
    assert "printed before the failure" in (tmp_path / "port" / "0.log").read_text()
    names = []
    for cls, cfg in ((OutputRedirection, OutputRedirectionConfig),
                     (JaxOutputRedirection, JaxOutputRedirectionConfig)):
        directory = tmp_path / cls.__module__.split(".")[0]
        for _ in range(2):
            cb = cls(cfg(log_dir=str(directory)))
            cb.on_fit_start(None, None, None, 0)
            print("line")
            cb.teardown()
        names.append(sorted(p.name for p in directory.glob("*.log")))
    assert names[0] == names[1] == ["0.log", "1.log"]


def _example(name):
    return yaml.safe_load((ROOT / "config" / "examples" / name).read_text())


def test_example_trainer_and_callback_nodes_are_accepted():
    """cpu-smoke.yaml's trainer node (health, resilience with recovery,
    checkpoint, callbacks, loggers) and llama-3.1-8b_pt.yaml's callbacks
    build through the port's config layer; their model and data nodes still
    name what is not ported (MoE: A.8; PreTrainingDataModule: A.5), and the
    HFCausalLM node reads its HF directory (missing here)."""
    smoke = _example("smoke/cpu-smoke.yaml")
    node = dict(smoke["trainer"])
    checkpoint = CheckpointConfig.from_node(node.pop("checkpoint"))
    components = node.pop("callbacks") + node.pop("loggers")
    config = build_dataclass(TrainerConfig, node, "trainer")
    assert config.health.every_n_steps == 2
    assert config.resilience.watchdog_timeout_s == 300 and config.resilience.data_retries == 2
    assert config.resilience.recovery.max_rollbacks == 2 and checkpoint.async_save is False
    built = [instantiate_from_config(c) for c in components]
    assert [type(c).__name__ for c in built] == ["TrainingTimeEstimator", "JsonlLogger"]
    assert built[0].config.num_steps == 2 and built[0].config.skip_first_n_steps == 1
    pt = _example("llama-3.1/llama-3.1-8b_pt.yaml")
    assert [type(instantiate_from_config(c)).__name__ for c in pt["trainer"]["callbacks"]] == [
        "TrainingTimeEstimator"]
    with pytest.raises(ValueError, match="mesh"):
        build_dataclass(TrainerConfig, {"mesh": pt["trainer"]["mesh"]}, "trainer")
    with pytest.raises((ValueError, NotImplementedError), match="num_experts"):
        instantiate_from_config(smoke["model"]).config.model.get_config()
    hf = instantiate_from_config(pt["model"]).config.model
    assert hf.get_config().hf_path == "/data/models/Llama-3.1-8B"
    assert hf.get_config().overrides["recompute_granularity"] == "selective"
    with pytest.raises(FileNotFoundError, match="Llama-3.1-8B"):
        hf.model_config()  # HFCausalLM reads the directory's config.json
    with pytest.raises(NotImplementedError, match="PreTrainingDataModule"):
        instantiate_from_config(pt["data"])
    for path in ("NanGuard", "ProgressBar", "ProfilerCallback", "OutputRedirection"):
        instantiate_from_config({"class_path": f"llm_training_tpu.callbacks.{path}"})
