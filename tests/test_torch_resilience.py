"""Port parity of the resilience layer on the CPU: retries, the skip-list
data stream, the recovery manager and its cooldown, fault injection, and
the rollback-and-skip driver against the JAX `Trainer` (the same chaos NaN
and spike, the same rollback record, losses within rtol 1e-4, the same
escalation); then preemption (exit 75 and a loss-exact resume, in a
subprocess), the hang watchdog and retried data errors in port fits.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_training_tpu.callbacks.nan_guard import NanGuard as JaxNanGuard
from llm_training_tpu.callbacks.nan_guard import NanGuardConfig as JaxNanGuardConfig
from llm_training_tpu.data import DummyDataModule as JaxDummy
from llm_training_tpu.data import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.resilience import ChaosConfig as JaxChaosConfig
from llm_training_tpu.resilience import DataSkipList as JaxSkipList
from llm_training_tpu.resilience import RecoveryConfig as JaxRecoveryConfig
from llm_training_tpu.resilience import RecoveryExhaustedError as JaxExhausted
from llm_training_tpu.resilience import RecoveryManager as JaxRecoveryManager
from llm_training_tpu.resilience import ResilienceConfig as JaxResilienceConfig
from llm_training_tpu.resilience import RetryPolicy as JaxRetryPolicy
from llm_training_tpu.resilience import cooldown_schedule as jax_cooldown
from llm_training_tpu.resilience import retry_call as jax_retry_call
from llm_training_tpu.resilience.chaos import Chaos as JaxChaos
from llm_training_tpu.resilience.chaos import config_from_env as jax_chaos_from_env
from llm_training_tpu.resilience.watchdog import HangWatchdog as JaxWatchdog
from llm_training_tpu.telemetry.goodput import GoodputLedger as JaxLedger
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu.trainer.checkpoint import CheckpointConfig as JaxCheckpointConfig
from llm_training_tpu.trainer.checkpoint import Checkpointer as JaxCheckpointer
from llm_training_tpu_torch.callbacks.nan_guard import NanGuard, NanGuardConfig
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.data.prefetch import DevicePrefetcher
from llm_training_tpu_torch.lms.base import ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.optim.builder import OptimConfig
from llm_training_tpu_torch.resilience import (
    ChaosConfig,
    ChaosError,
    DataSkipList,
    RecoveryConfig,
    RecoveryExhaustedError,
    RecoveryManager,
    ResilienceConfig,
    RetryPolicy,
    config_from_env,
    cooldown_schedule,
    get_chaos,
    install_chaos,
    retry_call,
    uninstall_chaos,
)
from llm_training_tpu_torch.resilience.chaos import Chaos
from llm_training_tpu_torch.resilience.watchdog import HangWatchdog
from llm_training_tpu_torch.telemetry.goodput import GoodputLedger
from llm_training_tpu_torch.telemetry.registry import TelemetryRegistry
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
            attention_impl="xla", param_dtype="float32", compute_dtype="float32")
DATA = dict(batch_size=8, max_length=32, num_samples=64, vocab_size=128)
OPTIM = dict(learning_rate=1e-3, warmup_steps=2, lr_scheduler="constant")
PARITY = dict(rtol=1e-4)  # the fit parity tolerance (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    uninstall_chaos()


# ---------------------------------------------------------------- retries


def test_retry_policy_and_call_match_jax():
    for kwargs in ({}, {"max_retries": 3, "backoff_base_s": 0.25, "backoff_factor": 3.0,
                        "backoff_max_s": 1.0}):
        ours, theirs = RetryPolicy(**kwargs), JaxRetryPolicy(**kwargs)
        assert [ours.delay_s(a) for a in range(5)] == [theirs.delay_s(a) for a in range(5)]
    for policy_cls, call, registry_cls in ((RetryPolicy, retry_call, TelemetryRegistry),
                                           (JaxRetryPolicy, jax_retry_call, TelemetryRegistry)):
        attempts, slept = [], []

        def flaky(attempt):
            attempts.append(attempt)
            if attempt < 2:
                raise ConnectionError("transient")
            return "ok"

        counter = registry_cls().counter("data/retries")
        assert call(flaky, policy_cls(max_retries=2), counter=counter, sleep=slept.append) == "ok"
        assert attempts == [0, 1, 2] and slept == [0.5, 1.0] and counter.value == 2
        with pytest.raises(ValueError):  # not transient: the first throw surfaces
            call(lambda a: (_ for _ in ()).throw(ValueError("bug")), policy_cls(max_retries=5))
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)


# ---------------------------------------------------------------- skip list and stream


def _take(stream, n):
    return [next(stream)["input_ids"] for _ in range(n)]


@pytest.mark.parametrize("windows,reserve,start", [
    ((), 0, 0), (((3, 1),), 2, 0), (((3, 2), (9, 1)), 3, 0), (((3, 2), (9, 1)), 3, 4),
    (((1, 5),), 2, 0),  # more skips than the reserve: the pool wraps
], ids=["none", "one", "two", "resumed", "wraps"])
def test_skip_list_stream_matches_jax(windows, reserve, start):
    """The port's stream equals JAX's batch for batch over three epochs, for
    the same windows and reserve (and from a resumed start); with no skip
    list it is JAX's plain stream."""
    ours = DummyDataModule(DummyDataModuleConfig(**DATA))
    theirs = JaxDummy(JaxDummyConfig(**DATA))
    ours.setup()
    theirs.setup()
    if windows or reserve:
        a = ours.train_batches(start, DataSkipList(windows, reserve))
        b = theirs.train_batches(start, JaxSkipList(windows, reserve))
    else:
        a, b = ours.train_batches(start), theirs.train_batches(start)
    for x, y in zip(_take(a, 24), _take(b, 24)):
        np.testing.assert_array_equal(x, y)


def test_skip_list_reserve_consuming_the_epoch_raises():
    dm = DummyDataModule(DummyDataModuleConfig(**DATA))
    dm.setup()
    with pytest.raises(ValueError, match="reserve"):
        next(dm.train_batches(0, DataSkipList((), reserve=8)))


def _drive_manager(manager_cls, config_cls, registry):
    manager = manager_cls(config_cls(max_rollbacks=3, skip_window_steps=2, escalate_after=1,
                                     lr_cooldown_steps=2, skip_windows=((20, 1),)),
                          registry=registry)
    out = [manager.on_failure(RuntimeError("x"), 5).rollback_index,
           manager.register_skip(10, 9), manager.register_cooldown(4),
           manager.on_failure(RuntimeError("x"), 7).rollback_index,
           manager.register_skip(14, 14), manager.metadata()]
    try:
        manager.on_failure(RuntimeError("x"), 7)
    except Exception as e:
        out.append(type(e).__name__)
    restored = manager_cls(config_cls(skip_windows=((20, 1),)), metadata=manager.metadata())
    out.append((restored.skip_list.windows, restored.skip_list.reserve, restored.cooldowns))
    return out, registry.snapshot()


def test_recovery_manager_matches_jax():
    ours = _drive_manager(RecoveryManager, RecoveryConfig, TelemetryRegistry())
    theirs = _drive_manager(JaxRecoveryManager, JaxRecoveryConfig, TelemetryRegistry())
    assert ours[0][:-2] == theirs[0][:-2]
    assert ours[0][-2] == "RecoveryExhaustedError" == theirs[0][-2]
    assert ours[0][-1] == theirs[0][-1] and ours[1] == theirs[1]
    for bad in (dict(max_rollbacks=0), dict(lr_cooldown_factor=0.0), dict(reserve_batches=0)):
        with pytest.raises(ValueError):
            RecoveryConfig(**bad)


def test_cooldown_schedule_matches_jax():
    base = lambda count: 1e-3 * (1 + 0.1 * count)  # noqa: E731
    windows = ((2, 3, 0.5), (3, 4, 0.25))
    ours, theirs = cooldown_schedule(base, windows), jax_cooldown(base, windows)
    np.testing.assert_allclose([ours(c) for c in range(10)], [float(theirs(c)) for c in range(10)],
                               rtol=1e-6)  # JAX's in float32
    assert ours(3) == base(3) * 0.125 and ours(9) == base(9)


# ---------------------------------------------------------------- chaos


def test_chaos_subset_matches_jax():
    config = dict(seed=3, data_error_steps=(1, 4), data_error_prob=0.25, nan_step=3,
                  spike_step=5, spike_scale=10.0, slow_step_s=0.5, slow_step_from=2)
    ours, theirs = Chaos(ChaosConfig(**config)), JaxChaos(JaxChaosConfig(**config))
    fired = []
    for harness, errors in ((ours, ChaosError), (theirs, OSError)):
        out = []
        for step in range(12):
            try:
                harness.maybe_raise("data", step)
                out.append(None)
            except errors as e:
                out.append(str(e))
        slept = []
        for step in range(4):
            out.append(harness.maybe_slow_step(step, sleep=slept.append))
        for step in range(1, 8):
            metrics = {"loss": 2.0, "grad_norm": 1.0}
            out.append((harness.maybe_poison_metrics(step, metrics), repr(metrics)))
        out.append(harness.maybe_poison_metrics(9, {"loss": 1.0}, fresh_start=False))
        fired.append((out, slept))
    assert fired[0] == fired[1]


def test_chaos_env_overlay_and_refused_keys(monkeypatch):
    monkeypatch.setenv("LLMT_CHAOS_NAN_STEP", "7")
    monkeypatch.setenv("LLMT_CHAOS_DATA_ERROR_STEPS", "2, 5")
    monkeypatch.setenv("LLMT_CHAOS_SLOW_STEP_S", "0.5")
    config = config_from_env(ChaosConfig(spike_step=4))
    assert (config.nan_step, config.data_error_steps, config.slow_step_s,
            config.spike_step) == (7, (2, 5), 0.5, 4)
    # the checkpoint's triggers and SIGKILL, the serving tier's and the
    # router's parse from the environment as JAX's do
    monkeypatch.setenv("LLMT_CHAOS_SIGKILL_STEP", "3")
    assert config_from_env().sigkill_step == 3
    monkeypatch.setenv("LLMT_CHAOS_SERVE_STALL_STEP", "3")
    assert config_from_env().serve_stall_step == 3
    monkeypatch.setenv("LLMT_CHAOS_ROUTER_BLACKHOLE", "3")
    monkeypatch.setenv("LLMT_CHAOS_ROUTER_KILL_REPLICA", "5")
    ours = config_from_env()
    assert (ours.router_blackhole_at, ours.router_kill_replica_at) == (3, 5)
    theirs = jax_chaos_from_env()
    assert (theirs.router_blackhole_at, theirs.router_kill_replica_at) == (3, 5)
    for key, value in (("checkpoint_error_steps", (1,)), ("sigkill_step", 2),
                       ("ckpt_corrupt", "flip"), ("ckpt_kill_in_swap", 1),
                       ("checkpoint_error_prob", 0.5), ("serve_stall_step", 1),
                       ("serve_sigterm_step", 1), ("serve_malformed_flood", 2)):
        assert ChaosConfig(**{key: value}).any_active(), key
    # each router trigger fires once, at the same counts as JAX's
    for key, value in (("router_kill_replica_at", 4), ("router_blackhole_at", 2)):
        assert ChaosConfig(**{key: value}).any_active(), key
        fired = []
        for harness in (Chaos(ChaosConfig(**{key: value})),
                        JaxChaos(JaxChaosConfig(**{key: value}))):
            fire = (harness.maybe_router_kill_replica if key == "router_kill_replica_at"
                    else harness.maybe_router_blackhole)
            fired.append([fire(n) for n in range(8)])
        assert fired[0] == fired[1] and sum(fired[0]) == 1, (key, fired)
    assert ResilienceConfig(elastic={"price_per_chip_hour": 1.0}).elastic.price_per_chip_hour == 1.0
    with pytest.raises(ValueError):
        ResilienceConfig(watchdog_action="explode")
    defaults = {k: v for k, v in JaxResilienceConfig().model_dump().items()
                if k not in ("recovery", "elastic", "chaos")}
    ours = ResilienceConfig()
    assert {k: getattr(ours, k) for k in defaults} == defaults
    assert install_chaos(ChaosConfig()) is None and get_chaos() is None


# ---------------------------------------------------------------- recovery against JAX


class _Recorder:
    def __init__(self):
        self.losses, self.rollbacks = {}, []

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])

    def on_rollback(self, trainer, step):
        self.rollbacks.append(step)


def _resilience(config_cls, chaos_cls, recovery_cls, **recovery):
    return dict(
        chaos=chaos_cls(nan_step=4, spike_step=7, spike_scale=1e3),
        recovery=recovery_cls(**recovery),
    )


def _guard(cls, cfg_cls):
    # warm after 2 log steps; only the injected x1000 (z ~ 1e4-1e5) trips it
    return cls(cfg_cls(spike_zscore=1000.0, spike_warmup_steps=2))


def _jax_objective():
    return JaxCLM(JaxCLMConfig(model=JaxProvider(model_class="llm_training_tpu.models.Llama",
                                                 model_kwargs=TINY),
                               optim=JaxOptimConfig(**OPTIM)))


def _port_objective(params):
    config = LlamaConfig.from_dict(TINY)
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, config))
    return CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM)),
               model=model)


def _jax_recovery_fit(tmp_path, max_steps, **recovery):
    recorder = _Recorder()
    trainer = JaxTrainer(
        JaxTrainerConfig(max_steps=max_steps, log_every_n_steps=1, checkpoint_every_n_steps=2,
                         resilience=JaxResilienceConfig(**_resilience(
                             JaxResilienceConfig, JaxChaosConfig, JaxRecoveryConfig,
                             **recovery))),
        callbacks=[recorder, _guard(JaxNanGuard, JaxNanGuardConfig)],
        checkpointer=JaxCheckpointer(JaxCheckpointConfig(dirpath=str(tmp_path), async_save=False,
                                                         max_to_keep=10)),
    )
    return trainer, recorder


def _port_recovery_fit(tmp_path, max_steps, **recovery):
    recorder = _Recorder()
    trainer = Trainer(
        TrainerConfig(max_steps=max_steps, log_every_n_steps=1, checkpoint_every_n_steps=2,
                      resilience=ResilienceConfig(**_resilience(
                          ResilienceConfig, ChaosConfig, RecoveryConfig, **recovery))),
        callbacks=[recorder, _guard(NanGuard, NanGuardConfig)], device="cpu",
        checkpointer=Checkpointer(CheckpointConfig(dirpath=str(tmp_path), async_save=False,
                                                   max_to_keep=10)),
    )
    return trainer, recorder


@pytest.fixture(scope="module")
def jax_recovery(tmp_path_factory, devices):
    """A 10-step JAX fit that heals a chaos NaN at step 4 and a spike at step
    7 in-process, and its initial weights (`init_params` under the
    trainer's seed)."""
    import flax.linen as nn
    import jax

    trainer, recorder = _jax_recovery_fit(tmp_path_factory.mktemp("jax"), 10, max_rollbacks=2)
    trainer.fit(_jax_objective(), JaxDummy(JaxDummyConfig(**DATA)))
    data = JaxDummy(JaxDummyConfig(**DATA))
    data.setup()
    init = nn.meta.unbox(_jax_objective().init_params(
        jax.random.key(JaxTrainerConfig().seed), next(data.train_batches())))
    return dict(recorder=recorder, snapshot=trainer.telemetry.snapshot(),
                windows=trainer._recovery.skip_list.windows, counters=dict(trainer.counters),
                init=jax.device_get(init))


def test_rollback_and_skip_matches_jax(tmp_path, jax_recovery):
    """The same chaos NaN (step 4) and spike (step 7): both fits roll back
    to their step-2 and step-6 checkpoints, skip micro-steps 3 and 6, and
    finish; the rollback record and counters are JAX's, the losses within
    rtol 1e-4."""
    trainer, recorder = _port_recovery_fit(tmp_path, 10, max_rollbacks=2)
    state = trainer.fit(_port_objective(jax_recovery["init"]),
                        DummyDataModule(DummyDataModuleConfig(**DATA)))
    want = jax_recovery["recorder"]
    assert state.step == 10
    assert recorder.rollbacks == want.rollbacks == [2, 6]
    assert [(r["failed_step"], r["restored_micro"], r["window"]) for r in trainer.rollbacks] == [
        (4, 2, [3, 1]), (7, 6, [6, 1])]
    assert trainer._recovery.skip_list.windows == jax_recovery["windows"] == [(3, 1), (6, 1)]
    snap = trainer.telemetry.snapshot()
    for key in ("resilience/rollbacks", "resilience/skip_windows", "resilience/skipped_steps",
                "nan_guard/non_finite_steps", "nan_guard/spike_steps",
                "resilience/chaos_injections"):
        assert snap[key] == jax_recovery["snapshot"][key], key
    assert trainer.counters == jax_recovery["counters"]
    steps = sorted(want.losses)
    assert sorted(recorder.losses) == steps
    clean = [s for s in steps if s not in (4, 7)]  # the poisoned reports
    np.testing.assert_allclose([recorder.losses[s] for s in clean],
                               [want.losses[s] for s in clean], **PARITY)
    meta = trainer.checkpointer.read_meta(10)
    assert meta["recovery"]["skip_list"] == {"windows": [[3, 1], [6, 1]], "reserve": 2}


def test_recovery_budget_exhaustion_matches_jax(tmp_path, devices):
    """With max_rollbacks 1 the second fault escalates in both."""
    jax_trainer, _ = _jax_recovery_fit(tmp_path / "jax", 8, max_rollbacks=1)
    with pytest.raises(JaxExhausted):
        jax_trainer.fit(_jax_objective(), JaxDummy(JaxDummyConfig(**DATA)))
    trainer, recorder = _port_recovery_fit(tmp_path / "port", 8, max_rollbacks=1)
    with pytest.raises(RecoveryExhaustedError, match="budget exhausted"):
        trainer.fit(CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM))),
                    DummyDataModule(DummyDataModuleConfig(**DATA)))
    for snap in (trainer.telemetry.snapshot(), jax_trainer.telemetry.snapshot()):
        assert snap["resilience/rollbacks"] == 1 and snap["resilience/recovery_escalations"] == 1
    assert recorder.rollbacks == [2]


def test_rollback_without_a_checkpoint_rebuilds_from_the_seed():
    """No checkpointer: the diverged state is dropped and a fresh one built
    from the seed, as JAX re-initializes; a handed-in model escalates."""
    recorder = _Recorder()
    trainer = Trainer(TrainerConfig(max_steps=5, log_every_n_steps=1, resilience=ResilienceConfig(
        chaos=ChaosConfig(nan_step=3), recovery=RecoveryConfig(max_rollbacks=1))),
        callbacks=[recorder, NanGuard()], device="cpu")
    objective = CLM(CLMConfig(model=ModelProvider("Llama", TINY), optim=OptimConfig(**OPTIM)))
    state = trainer.fit(objective, DummyDataModule(DummyDataModuleConfig(**DATA)))
    assert recorder.rollbacks == [0] and state.step == 5 and objective.model is state.model
    assert trainer.rollbacks[0]["window"] == [2, 1]
    assert trainer.counters["consumed_samples"] == 5 * 8
    handed = CLM(CLMConfig(optim=OptimConfig(**OPTIM)), model=Llama(LlamaConfig.from_dict(TINY),
                                                                    device="cpu"))
    trainer = Trainer(TrainerConfig(max_steps=4, log_every_n_steps=1, resilience=ResilienceConfig(
        chaos=ChaosConfig(nan_step=2), recovery=RecoveryConfig())),
        callbacks=[NanGuard()], device="cpu")
    with pytest.raises(RecoveryExhaustedError, match="handed in"):
        trainer.fit(handed, DummyDataModule(DummyDataModuleConfig(**DATA)))


# ---------------------------------------------------------------- preemption, CLI exits


def _cli_config(tmp_path, **trainer) -> Path:
    config = json.loads((ROOT / "llm_training_tpu_torch/config/cpu-smoke.json").read_text())
    config["run_root"] = str(tmp_path)
    config["trainer"].update(max_steps=6, log_every_n_steps=1, val_check_interval=None,
                             checkpoint={"dirpath": str(tmp_path / "ckpt"), "async_save": False},
                             **trainer)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return path


# torch's deterministic kernels: bit-exact resume on the CPU needs them
_RUN = ("import sys, torch; torch.use_deterministic_algorithms(True); "
        "from llm_training_tpu_torch.cli.main import main; sys.exit(main(sys.argv[1:]))")


def _fit_process(path, *overrides):
    return subprocess.run([sys.executable, "-c", _RUN, "fit", "--config", str(path), "--device",
                           "cpu", *overrides], cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env={**os.environ, "PYTHONPATH": str(ROOT)})


def _losses(run_root) -> dict[int, float]:
    rows = (Path(run_root) / "smoke" / "cpu-smoke" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, rows) if "loss" in r}


def test_preemption_exits_75_and_resumes_loss_exact(tmp_path):
    """`fit` with chaos SIGTERM at step 3 in its own process: the emergency
    checkpoint of step 3, exit 75; the relaunch of the same command resumes
    and its steps 4-6 equal an uninterrupted run's bit for bit."""
    chaos = '{"sigterm_step": 3}'
    preempted = _cli_config(tmp_path / "preempted")
    first = _fit_process(preempted, f"trainer.resilience={{\"chaos\": {chaos}}}")
    assert first.returncode == 75, first.stderr[-2000:]
    assert "resumable code 75" in first.stdout + first.stderr
    assert sorted(p.name for p in (tmp_path / "preempted" / "ckpt").iterdir()) == [
        "manifest-3.json", "step_3"]
    telemetry = (tmp_path / "preempted" / "smoke" / "cpu-smoke" / "telemetry.jsonl")
    last = json.loads(telemetry.read_text().splitlines()[-1])
    assert last["resilience/preemptions"] == 1 and last["resilience/emergency_saves"] == 1
    second = _fit_process(preempted, f"trainer.resilience={{\"chaos\": {chaos}}}")
    assert second.returncode == 0, second.stderr[-2000:]
    clean = _cli_config(tmp_path / "clean")
    torch.use_deterministic_algorithms(True)
    try:
        assert cli_main(["fit", "--config", str(clean), "--device", "cpu"]) == 0
    finally:
        torch.use_deterministic_algorithms(False)
    got, want = _losses(tmp_path / "preempted"), _losses(tmp_path / "clean")
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5, 6]
    assert got == want


@pytest.mark.parametrize("chaos,recovery,code", [
    ({"nan_step": 2}, None, 78),
    ({"spike_step": 4}, None, 77),
    ({"nan_step": 2, "spike_step": 4}, {"max_rollbacks": 1}, 76),
], ids=["non-finite-78", "spike-77", "exhausted-76"])
def test_fit_cli_maps_failures_to_exit_codes(tmp_path, chaos, recovery, code):
    guard = {"class_path": "llm_training_tpu.callbacks.NanGuard",
             "init_args": {"spike_zscore": 1000.0, "spike_warmup_steps": 2}}
    resilience = {"chaos": chaos, **({"recovery": recovery} if recovery else {})}
    path = _cli_config(tmp_path, callbacks=[guard], resilience=resilience,
                       checkpoint_every_n_steps=1)
    assert cli_main(["fit", "--config", str(path), "--device", "cpu"]) == code


# ---------------------------------------------------------------- watchdog and retries


def _watchdog_dump(cls, ledger_cls, tmp_path):
    clock = [0.0]
    ledger = ledger_cls()
    watchdog = cls(2.0, run_dir=tmp_path, ledger=ledger, registry=TelemetryRegistry(),
                   clock=lambda: clock[0])
    watchdog.beat("train_loop", step=7)
    watchdog.beat("prefetcher")
    clock[0] = 1.0
    assert not watchdog._poll_once()
    with ledger.measure("step_compute"):
        clock[0] = 5.0
        assert watchdog._poll_once() and not watchdog._poll_once()  # one dump per stall
    watchdog.beat("train_loop", step=8)  # progress re-arms it
    lines = watchdog.dump_paths[0].read_text().splitlines()
    return lines[:1] + lines[2:5], watchdog._registry.snapshot(), "\n".join(lines)


def test_watchdog_dump_matches_jax(tmp_path):
    """On the same injected clock both dump once per stall, naming the open
    goodput phase, each source's beat and every thread's stack."""
    ours = _watchdog_dump(HangWatchdog, GoodputLedger, tmp_path / "port")
    theirs = _watchdog_dump(JaxWatchdog, JaxLedger, tmp_path / "jax")
    assert ours[:2] == theirs[:2]
    assert ours[0][1] == "goodput phase open at stall: step_compute"
    assert "last beat [train_loop]: 5.0s ago (step 7)" in ours[0]
    assert f"--- thread {threading.main_thread().name}" in ours[2]
    with pytest.raises(ValueError):
        HangWatchdog(1.0, action="explode")


class _Losses:
    def __init__(self):
        self.losses = []

    def on_step_end(self, trainer, step, metrics):
        self.losses.append(metrics["loss"])


def test_watchdog_dumps_a_slow_step_and_the_fit_completes(tmp_path):
    """slow_step_s above watchdog_timeout_s with action dump: a hang dump of
    the stall after micro-step 1's beat (the open phase, every beat, the
    main thread's stack) lands in the run's checkpoint directory, and the
    fit ends. The phase open at the dump is none when it fires inside the
    boundary's sleep; a loaded machine may fire it inside step 2's compute
    (one dump per stall), and may add a dump of the warm-up step."""
    trainer = Trainer(TrainerConfig(max_steps=2, log_every_n_steps=1, resilience=ResilienceConfig(
        watchdog_timeout_s=1.0, chaos=ChaosConfig(slow_step_s=1.8, slow_step_from=2))),
        device="cpu", checkpointer=Checkpointer(CheckpointConfig(dirpath=str(tmp_path))))
    state = trainer.fit(CLM(CLMConfig(model=ModelProvider("Llama", TINY),
                                      optim=OptimConfig(**OPTIM))),
                        DummyDataModule(DummyDataModuleConfig(**DATA)))
    trainer.checkpointer.close()
    assert state.step == 2
    texts = [d.read_text() for d in tmp_path.glob("hang-dump-*.txt")]
    assert trainer.telemetry.snapshot()["resilience/watchdog_dumps"] >= 1
    assert any("goodput phase open at stall: " in t and "last beat [train_loop]" in t
               and "(step 1)" in t and "--- thread MainThread" in t for t in texts), texts


@pytest.mark.parametrize("depth", [2, 0], ids=["prefetch", "no-prefetch"])
def test_retried_data_error_leaves_the_stream_unchanged(depth):
    """chaos data_error_steps [2] with data_retries 2: one retry counted, the
    batches and the losses those of a clean fit; without prefetch (no retry
    site) the data error surfaces."""
    runs = []
    for chaos in (ChaosConfig(data_error_steps=(2,)), ChaosConfig()):
        recorder = _Losses()
        trainer = Trainer(TrainerConfig(max_steps=4, log_every_n_steps=1, prefetch_batches=depth,
                                        resilience=ResilienceConfig(
                                            data_retries=2, data_retry_backoff_s=0.0,
                                            chaos=chaos)),
                          callbacks=[recorder], device="cpu")
        torch.use_deterministic_algorithms(True)
        try:
            objective = CLM(CLMConfig(model=ModelProvider("Llama", TINY),
                                      optim=OptimConfig(**OPTIM)))
            data = DummyDataModule(DummyDataModuleConfig(**DATA))
            if depth == 0 and chaos.data_error_steps:
                trainer.fit(objective, data)  # the fit runs: no prefetcher, no chaos site
            else:
                trainer.fit(objective, data)
        finally:
            torch.use_deterministic_algorithms(False)
        runs.append((recorder.losses, trainer.telemetry.snapshot().get("data/retries", 0.0)))
    (faulted, retries), (clean, clean_retries) = runs
    assert faulted == clean
    assert retries == (1.0 if depth else 0.0) and clean_retries == 0.0


def test_prefetcher_rebuilds_a_closed_generator_at_the_retried_batch():
    """A generator that raises is closed; with a factory the retry rebuilds
    the stream at the batch being retried, so the stream is unchanged."""
    data = [{"x": np.full((1, 2), i, np.int32)} for i in range(6)]
    failures = {3}

    def factory(offset):
        def gen():
            for i in range(offset, len(data)):
                if i in failures:
                    failures.discard(i)
                    raise ConnectionError(f"transient at {i}")
                yield data[i]
        return gen()

    registry, beats = TelemetryRegistry(), []
    prefetcher = DevicePrefetcher(factory, "cpu", registry=registry, retries=1,
                                  retry_backoff_s=0.0, heartbeat=lambda: beats.append(1))
    got = [int(batch["x"][0, 0]) for batch, _ in prefetcher]
    prefetcher.close()
    assert got == list(range(6)) and len(beats) == 6
    snap = registry.snapshot()
    assert snap["data/retries"] == 1 and snap["data/produce_n"] == 6
    failures.add(2)
    with pytest.raises(ConnectionError):  # no retries: the error surfaces on next()
        list(DevicePrefetcher(factory, "cpu", registry=registry))
