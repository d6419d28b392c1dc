"""The trainer's new keys on the CPU: the batch prefetcher
(`data/prefetch.py`) and `prefetch_batches`; `offload_optimizer_state`,
`offload_state_dtype` and `offload_quant_block` with JAX's defaults and
errors; checkpoint and loss-exact resume of int8-encoded offloaded state;
and the CLI's `fit --config` with the new keys and the two new
optimizers."""

import threading

import numpy as np
import pytest
import torch

from llm_training_tpu.trainer.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.prefetch import DevicePrefetcher
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from tests.test_torch_checkpoint import _data, _jax_objective, _objective, _Losses
from tests.test_torch_train import CONFIG_FILE
from torch_threads import one_torch_thread  # noqa: F401

OFFLOAD_KEYS = ("prefetch_batches", "offload_optimizer_state", "offload_state_dtype",
                "offload_quant_block")


def _host_batches(n: int) -> list[dict]:
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 9, (2, 4)), "step": np.full((1,), i)} for i in range(n)]


# ---------------------------------------------------------------- the prefetcher


def test_prefetcher_keeps_order_and_counts():
    """Batches arrive in the stream's order, placed as tensors, each with
    its host-side rider; a factory is called at production offset 0."""
    batches = _host_batches(7)
    offsets = []

    def factory(offset):
        offsets.append(offset)
        return iter(batches[offset:])

    prefetcher = DevicePrefetcher(factory, "cpu", depth=2,
                                  host_aux_fn=lambda b: int(b["step"][0]))
    got = list(prefetcher)
    assert offsets == [0]
    assert [aux for _, aux in got] == list(range(7))
    for (batch, _), ref in zip(got, batches):
        assert isinstance(batch["input_ids"], torch.Tensor)
        assert np.array_equal(batch["input_ids"].numpy(), ref["input_ids"])
    with pytest.raises(StopIteration):
        next(prefetcher)


def test_prefetcher_raises_the_streams_error_on_next():
    def failing():
        yield from _host_batches(2)
        raise OSError("the data source broke")

    prefetcher = DevicePrefetcher(failing(), "cpu", depth=1)
    assert len([next(prefetcher), next(prefetcher)]) == 2
    with pytest.raises(OSError, match="the data source broke"):
        next(prefetcher)


def test_prefetcher_close_stops_an_endless_stream():
    """An endless stream parks the worker on the full queue; `close()`
    ends it."""
    def endless():
        while True:
            yield from _host_batches(3)

    before = threading.active_count()
    prefetcher = DevicePrefetcher(endless(), "cpu", depth=2)
    next(prefetcher)
    prefetcher.close()
    assert not prefetcher._thread.is_alive()
    assert threading.active_count() == before
    with pytest.raises(StopIteration):
        next(prefetcher)


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels: two uninterrupted runs equal each other
    bit for bit only with them (`tests/test_torch_checkpoint.py`)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_fit_with_prefetch_equals_without(optimizer, deterministic):
    """`prefetch_batches` 2 (the default, JAX's) and 0 give the same
    losses and parameters bit for bit: the prefetcher reorders no batch."""
    runs = []
    for depth in (2, 0):
        recorder = _Losses()
        objective = _objective()
        objective.config.optim.optimizer = optimizer
        objective.config.optim.optimizer_kwargs = {}
        trainer = Trainer(TrainerConfig(max_steps=2, log_every_n_steps=1, prefetch_batches=depth,
                                        accumulate_grad_batches=2),
                          callbacks=[recorder], device="cpu")
        state = trainer.fit(objective, _data())
        runs.append((recorder.losses, dict(state.model.named_parameters()), trainer.counters))
    (losses2, params2, counters2), (losses0, params0, counters0) = runs
    assert losses2 == losses0 and counters2 == counters0
    for name in params0:
        assert torch.equal(params2[name], params0[name]), name


# ---------------------------------------------------------------- the trainer's keys


def test_trainer_keys_default_as_jax():
    port, jax_ = TrainerConfig(), JaxTrainerConfig()
    assert {k: getattr(port, k) for k in OFFLOAD_KEYS} == {k: getattr(jax_, k)
                                                           for k in OFFLOAD_KEYS}


@pytest.mark.parametrize("keys", [
    dict(offload_optimizer_state=True, offload_state_dtype="float16"),
    dict(offload_state_dtype="int8"),
    dict(offload_optimizer_state=True, offload_quant_block=0),
], ids=["unknown_dtype", "codec_without_offload", "block_zero"])
def test_trainer_keys_raise_jaxs_errors(keys):
    """The port's TrainerConfig raises the ValueError that JAX's
    `_build_tx` raises for the same keys, with its message."""
    with pytest.raises(ValueError) as jax_error:
        JaxTrainer(JaxTrainerConfig(**keys))._build_tx(_jax_objective())
    with pytest.raises(ValueError) as port_error:
        TrainerConfig(**keys)
    assert str(port_error.value) == str(jax_error.value)


# ---------------------------------------------------------------- resume


def _offload_trainer(directory, max_steps, dtype="int8", block=16, **kw):
    checkpointer = None
    if directory is not None:
        checkpointer = Checkpointer(CheckpointConfig(dirpath=str(directory), max_to_keep=5))
    return Trainer(TrainerConfig(max_steps=max_steps, log_every_n_steps=1,
                                 accumulate_grad_batches=2, offload_optimizer_state=True,
                                 offload_state_dtype=dtype, offload_quant_block=block, **kw),
                   callbacks=[_Losses()], device="cpu", checkpointer=checkpointer)


def _run(trainer, resume_step=None):
    state = trainer.fit(_objective(), _data(), resume_step=resume_step)
    if trainer.checkpointer is not None:
        trainer.checkpointer.close()
    return trainer.callbacks[0].losses, state


class _Snapshot:
    """The optimizer's stored state right after each save (copies)."""

    def __init__(self):
        self.saved = {}

    def on_train_step(self, trainer, step):
        self.step = step

    def state_dict(self):  # called by the checkpointer's save, after staging
        opt = self.trainer.state.optimizer.state_dict()
        self.saved[self.step] = {k: t.clone() for k, t in opt.items()}
        return {}


def test_int8_state_resumes_loss_exact(tmp_path, deterministic):
    """4 steps with int8 offloaded state (accumulation 2), a run stopped
    with its checkpoint at step 2, then a fresh Trainer resumes to step 4:
    the losses, parameters and every stored code and scale equal the
    uninterrupted run's, and the restored state is the saved one bit for
    bit."""
    full, full_state = _run(_offload_trainer(None, 4))
    trainer = _offload_trainer(tmp_path, 2, checkpoint_every_n_steps=2)
    snapshot = _Snapshot()
    snapshot.trainer = trainer
    trainer.callbacks.append(snapshot)
    _run(trainer)
    resumer = _offload_trainer(tmp_path, 4)
    state, _ = resumer.init_state(_objective())
    meta = resumer.checkpointer.maybe_restore(state, 2)
    assert meta["optimizer"]["offload_state_dtype"] == "int8"
    restored = state.optimizer.state_dict()
    assert any(k.endswith(".q") for k in restored)
    for key, tensor in snapshot.saved[2].items():
        assert torch.equal(restored[key], tensor), key
    resumed, state = _run(_offload_trainer(tmp_path, 4))
    assert sorted(resumed) == [3, 4]
    assert {k: full[k] for k in (3, 4)} == resumed
    full_tensors, tensors = full_state.state_dict(), state.state_dict()
    assert full_tensors.keys() == tensors.keys()
    for name in full_tensors:
        assert torch.equal(full_tensors[name], tensors[name]), name


@pytest.mark.parametrize("change,key", [
    (dict(dtype="bfloat16"), "offload_state_dtype"),
    (dict(block=8), "offload_quant_block"),
], ids=["codec", "block"])
def test_resume_under_another_codec_raises(tmp_path, change, key):
    _run(_offload_trainer(tmp_path, 2))
    with pytest.raises(RuntimeError, match="offload_state_dtype") as error:
        _run(_offload_trainer(tmp_path, 4, **change))
    assert key in str(error.value.__cause__)


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("overrides", [
    ["model.init_args.optim.optimizer=lion"],
    ["model.init_args.optim.optimizer=adafactor", "model.init_args.optim.learning_rate=0.3",
     'model.init_args.optim.optimizer_kwargs={"min_dim_size_to_factor": 16}'],
    ["trainer.offload_optimizer_state=true", "trainer.offload_state_dtype=int8",
     "trainer.offload_quant_block=16", "trainer.prefetch_batches=3"],
], ids=["lion", "adafactor", "offload_int8"])
def test_cli_fit_takes_the_new_keys(tmp_path, overrides):
    """`fit --config` builds Lion, Adafactor and the offload keys from the
    config, and the smoke fit's loss falls."""
    import json

    rc = cli_main(["fit", "--config", CONFIG_FILE, "--device", "cpu", f"run_root={tmp_path}",
                   *overrides])
    assert rc == 0
    rows = [json.loads(line) for line in
            (tmp_path / "smoke" / "cpu-smoke" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses[-1] < losses[0]
